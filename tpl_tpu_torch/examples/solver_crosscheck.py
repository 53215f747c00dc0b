"""
Cross-check the AL-iLQR solver core against an independent NLP solver.

The port of ``examples/solver_crosscheck.py``, the analog of the
reference's acados comparison (reference:
library/tpl/optim/examples/simple_vehicle_acados/simple_vehicle_acados.py):
the same unicycle point-tracking OCP is solved by

  1. the port's augmented-Lagrangian iLQR (tpl_tpu_torch.optim.Solver: on
     the card the problem is traced into the generic AL-iLQR kernel's
     struct, one launch an update; on the CPU the plain iLQR), and
  2. scipy SLSQP on the direct single-shooting transcription of the
     identical discrete-time problem (on the host),

then trajectory costs and runtimes are compared.  Because both optimize
the exact same discretized objective, the costs must agree to optimizer
tolerance — an end-to-end correctness check of the whole solver stack
(autograd derivatives, backward pass, line search, control clamping).

Run: python -m tpl_tpu_torch.examples.solver_crosscheck          (the card)
     python -m tpl_tpu_torch.examples.solver_crosscheck --cpu    (the CPU)
"""

import argparse
import time

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch.optim.ilqr import Problem
from tpl_tpu_torch.optim.solver import Solver

H = 40          # steps
DT = 0.05       # s
X_TRG = np.array([3.0, 1.5, 0.0])   # target pose
W_POS, W_HEAD, W_U = 4.0, 0.1, 0.05
V_MAX, STEER_MAX = 2.0, 2.0
REL_TOL = 5e-2  # relative cost difference the two solvers may show


def dynamics_np(x, u):
    """Unicycle, explicit Euler — the shared discrete-time model."""
    px, py, th = x
    v, steer = u
    return np.array([
        px + DT * v * np.cos(th),
        py + DT * v * np.sin(th),
        th + DT * v * steer,
    ])


def stage_cost_np(x, u):
    d = x - X_TRG
    return DT * (W_POS * (d[0] ** 2 + d[1] ** 2) + W_HEAD * d[2] ** 2
                 + W_U * (u[0] ** 2 + u[1] ** 2))


def make_problem():
    """The unicycle OCP as a torch problem (no params)."""
    def dynamics(x, u, t, dt, p):
        return torch.stack([u[..., 0] * torch.cos(x[..., 2]),
                            u[..., 0] * torch.sin(x[..., 2]),
                            u[..., 0] * u[..., 1]], dim=-1)

    def cost(x, u, t, dt, p):
        return (W_POS * ((x[..., 0] - X_TRG[0]) ** 2
                         + (x[..., 1] - X_TRG[1]) ** 2)
                + W_HEAD * (x[..., 2] - X_TRG[2]) ** 2
                + W_U * (u[..., 0] ** 2 + u[..., 1] ** 2))

    prob = Problem("unicycle_crosscheck", nx=3, nu=2, nc=0,
                   dynamics=dynamics, cost=cost)
    return prob, {}


def make_solver(device=None):
    prob, spec = make_problem()
    opt = Solver(prob, spec, horizon_max=H, device=device)
    opt.horizon = H
    opt.step = DT
    opt.max_iterations = 100
    opt.u_min[:, 0] = -V_MAX
    opt.u_max[:, 0] = V_MAX
    opt.u_min[:, 1] = -STEER_MAX
    opt.u_max[:, 1] = STEER_MAX
    opt.x[0] = [0.0, 0.0, 0.0]
    return opt


def solve_ilqr(device=None):
    opt = make_solver(device)
    opt.update()           # first solve (traces and builds on the card)
    t0 = time.perf_counter()
    opt.update()
    dt_ms = (time.perf_counter() - t0) * 1e3
    route = opt.route if opt.device.type == "cuda" else "the plain iLQR"
    return np.asarray(opt.x), np.asarray(opt.u), dt_ms, route


def rollout_cost(u_flat, x0):
    u = u_flat.reshape(H, 2)
    x = x0.copy()
    c = 0.0
    for t in range(H):
        c += stage_cost_np(x, u[t])
        x = dynamics_np(x, u[t])
    return c


def solve_scipy():
    from scipy.optimize import minimize

    x0 = np.zeros(3)
    u0 = np.zeros(H * 2)
    bounds = [(-V_MAX, V_MAX), (-STEER_MAX, STEER_MAX)] * H
    t0 = time.perf_counter()
    res = minimize(rollout_cost, u0, args=(x0,), method="SLSQP",
                   bounds=bounds,
                   options={"maxiter": 500, "ftol": 1e-10})
    dt_ms = (time.perf_counter() - t0) * 1e3
    u = res.x.reshape(H, 2)
    xs = [x0]
    for t in range(H):
        xs.append(dynamics_np(xs[-1], u[t]))
    return np.array(xs), u, dt_ms, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the iLQR on the CPU")
    args = ap.parse_args(argv)
    tpl_tpu_torch.use_device("cpu" if args.cpu else "cuda")

    x_i, u_i, ms_i, route = solve_ilqr()
    cost_i = rollout_cost(np.asarray(u_i[:H]).ravel(), np.zeros(3))

    x_s, u_s, ms_s, res = solve_scipy()
    cost_s = res.fun

    print(f"AL-iLQR    : cost {cost_i:.6f}   runtime {ms_i:8.2f} ms "
          f"(second solve, {tpl_tpu_torch.device()}, {route})")
    print(f"scipy SLSQP: cost {cost_s:.6f}   runtime {ms_s:8.2f} ms "
          f"({res.nit} iterations)")
    print(f"final pose iLQR : {np.round(x_i[-1], 3)}")
    print(f"final pose SLSQP: {np.round(x_s[-1], 3)}")

    rel = abs(cost_i - cost_s) / max(1e-9, abs(cost_s))
    print(f"relative cost difference: {rel:.2e}")
    if not rel < REL_TOL:
        raise AssertionError("solvers disagree beyond tolerance")
    print("cross-check OK")
    return rel


if __name__ == "__main__":
    main()
