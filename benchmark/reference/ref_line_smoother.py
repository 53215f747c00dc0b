"""
Upstream's ``ref_line_smoother_k`` (library/tpl/optim/optimizers.py
:431-490) in plain PyTorch: RSTP's ``PathSmoothing`` problem.

States [x, y, phi], the curvature the single action; the cost keeps the
pose on the raw line (looked up at the arc length of the step) and the
curvature small.  No constraints.
"""

import torch

from benchmark.reference.ilqr import (  # noqa: F401
    Problem, gaps, solve_scenarios)
from benchmark.reference.interp import lerp


def dynamics(x, u, t, dt, p):
    return torch.stack([torch.cos(x[..., 2]), torch.sin(x[..., 2]),
                        u[..., 0]], dim=-1)


def cost(x, u, t, dt, p):
    s = torch.broadcast_to(t * dt, x.shape[:-1])
    x_ref = lerp(0.0, p["ref_step"], s, p["ref_x"])
    y_ref = lerp(0.0, p["ref_step"], s, p["ref_y"])
    return (p["w_pos"] * (x[..., 0] - x_ref) ** 2
            + p["w_pos"] * (x[..., 1] - y_ref) ** 2
            + p["w_k"] * u[..., 0] ** 2)


PROBLEM = Problem("ref_line_smoother_k", nx=3, nu=1, nc=0,
                  dynamics=dynamics, cost=cost)


def solve(cfg, scen, rows, dtype):
    """The AL-iLQR solve of the scenarios ``rows`` of ``scen`` in
    ``dtype``; :func:`gaps` compares the program's results with it."""
    return solve_scenarios(PROBLEM, cfg, scen, rows, dtype)
