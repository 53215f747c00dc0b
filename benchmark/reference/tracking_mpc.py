"""
Upstream's ``trajectory_tracking_mpc`` (library/tpl/optim/optimizers.py
:12-126) in plain PyTorch: the spatial-progress tracking MPC of the
``ModelPredictiveController``.

States [x, y, phi, delta, v, s_r, a], actions [jerk, delta_dot]; a
kinematic bicycle with a characteristic velocity, the reference course
looked up at the progress s_r carried as a state; four constraints (the
steering angle and the acceleration within their limits).
"""

import torch

from benchmark.reference.ilqr import (  # noqa: F401
    Problem, gaps, solve_scenarios)
from benchmark.reference.interp import lerp, lerp_angle


def _core(x, p):
    px, py, phi, delta, v, s_r, a = x.unbind(-1)
    r_x = lerp(0.0, p["ref_step"], s_r, p["ref_x"])
    r_y = lerp(0.0, p["ref_step"], s_r, p["ref_y"])
    r_k = lerp(0.0, p["ref_step"], s_r, p["ref_k"])
    # the speed target's lookup is fixed(): its gradient through s_r is cut
    v_trg = lerp(0.0, p["ref_step"], s_r, p["ref_v"]).detach()
    r_phi = lerp_angle(0.0, p["ref_step"], s_r, p["ref_phi"])
    phi_dot = v / (p["l"] * (1 + (v / p["v_ch"]) ** 2)) * torch.tan(delta)
    d_r = torch.cos(r_phi) * (py - r_y) - torch.sin(r_phi) * (px - r_x)
    s_dot = v * torch.cos(phi - r_phi) / (1 - d_r * r_k)
    return phi_dot, d_r, s_dot, v_trg, r_phi, r_k


def dynamics(x, u, t, dt, p):
    px, py, phi, delta, v, s_r, a = x.unbind(-1)
    j, delta_dot = u.unbind(-1)
    phi_dot, _, s_dot, _, _, _ = _core(x, p)
    return torch.stack([v * torch.cos(phi), v * torch.sin(phi), phi_dot,
                        delta_dot, a + p["a_offset"], s_dot, j], dim=-1)


def cost(x, u, t, dt, p):
    px, py, phi, delta, v, s_r, a = x.unbind(-1)
    j, delta_dot = u.unbind(-1)
    phi_dot, d_r, s_dot, v_trg, r_phi, r_k = _core(x, p)
    c = (p["min_pdelta_dot"] + p["pdelta_dot"] * v ** 2) * delta_dot ** 2
    c = c + (p["min_p_phi_dot"] + p["p_phi_dot"] * v ** 2) * phi_dot ** 2
    c = c + p["pa"] * a ** 2
    c = c + p["pj"] * j ** 2
    c = c + p["pv"] * (v - v_trg) ** 2
    c = c + p["pd"] * d_r ** 2
    c = c + p["p_phi"] * (1.0 - torch.cos(phi - r_phi))
    c = c + p["p_phi_ref_dot_diff"] * (phi_dot - s_dot * r_k) ** 2 * v ** 2
    return c


def constraints(x, u, t, dt, p):
    delta, a = x[..., 3], x[..., 6]
    return torch.stack([delta - p["max_delta"], -p["max_delta"] - delta,
                        a - p["max_acc"], p["min_acc"] - a], dim=-1)


PROBLEM = Problem("trajectory_tracking_mpc", nx=7, nu=2, nc=4,
                  dynamics=dynamics, cost=cost, constraints=constraints)


def solve(cfg, scen, rows, dtype):
    """The AL-iLQR solve of the scenarios ``rows`` of ``scen`` in
    ``dtype``; :func:`gaps` compares the program's results with it."""
    return solve_scenarios(PROBLEM, cfg, scen, rows, dtype)
