"""
Simple vehicle trajectory optimization example.

The port of ``examples/simple_vehicle.py``, the solver-core analog of the
reference's genopt demo (reference:
library/tpl/optim/examples/simple_vehicle/main.py): define a kinematic
bicycle problem as plain torch functions, solve a receding-horizon tracking
task, print the result.  The problem has no hand-written kernel: the
``Solver`` runs the plain iLQR on its device.

Run: python -m tpl_tpu_torch.examples.simple_vehicle          (on the card)
     python -m tpl_tpu_torch.examples.simple_vehicle --cpu    (on the CPU)
     ... --plot FILE    (the path against the reference, where matplotlib
                         is installed)

``--gui`` (the interactive browser view of the JAX example) waits for the
port of the GUI and is refused until then.
"""

import argparse

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch.ops.interp import lerp
from tpl_tpu_torch.optim.ilqr import Problem
from tpl_tpu_torch.optim.problems import ArraySpec
from tpl_tpu_torch.optim.solver import Solver


def make_problem():
    # states: x, y, phi, v; actions: acc, steer
    def dynamics(x, u, t, dt, p):
        phi, v = x[..., 2], x[..., 3]
        acc, steer = u[..., 0], u[..., 1]
        return torch.stack([
            v * torch.cos(phi),
            v * torch.sin(phi),
            v * torch.tan(steer) / p["wheel_base"],
            acc,
        ], dim=-1)

    def cost(x, u, t, dt, p):
        s = t * dt * p["v_ref"]      # rough progress-based reference index
        x_ref = lerp(0.0, p["ref_step"], s, p["ref_x"])
        y_ref = lerp(0.0, p["ref_step"], s, p["ref_y"])
        c = p["w_pos"] * ((x[..., 0] - x_ref) ** 2 + (x[..., 1] - y_ref) ** 2)
        c = c + p["w_v"] * (x[..., 3] - p["v_ref"]) ** 2
        c = c + p["w_u"] * (u[..., 0] ** 2 + u[..., 1] ** 2)
        return c

    prob = Problem("simple_vehicle", nx=4, nu=2, nc=0,
                   dynamics=dynamics, cost=cost)
    spec = dict(wheel_base=2.7, v_ref=8.0, w_pos=1.0, w_v=0.2, w_u=0.1,
                ref_x=ArraySpec(256), ref_y=ArraySpec(256), ref_step=0.5)
    return prob, spec


def make_solver(device=None):
    prob, spec = make_problem()
    opt = Solver(prob, spec, horizon_max=80, device=device)
    opt.horizon = 80
    opt.step = 0.1
    opt.max_iterations = 30
    opt.u_min[:, 0] = -3.0
    opt.u_max[:, 0] = 2.0
    opt.u_min[:, 1] = -0.5
    opt.u_max[:, 1] = 0.5

    ss = np.arange(256) * 0.5
    opt.params.ref_x = ss
    opt.params.ref_y = 4.0 * np.sin(ss * 0.08)
    opt.x[0] = [0.0, 2.0, 0.0, 5.0]
    return opt


def plot(opt, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(opt.params.ref_x[:120], opt.params.ref_y[:120], "--",
            label="reference")
    ax.plot(opt.x[:, 0], opt.x[:, 1], "-", label="optimized")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(path, bbox_inches="tight")
    print(f"plot: {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU")
    ap.add_argument("--plot", metavar="FILE", help="save a plot there")
    ap.add_argument("--gui", action="store_true",
                    help="the interactive view: waits for the GUI's port")
    args = ap.parse_args(argv)
    if args.gui:
        ap.error("--gui waits for the port of the GUI (tpl_tpu/gui)")
    tpl_tpu_torch.use_device("cpu" if args.cpu else "cuda")

    opt = make_solver()
    opt.update()

    print(f"solved on {opt.device} in {opt.runtime:.1f} ms, cost "
          f"{opt.traj_costs:.2f}, {opt.iterations} iterations")
    print("final state:", np.round(opt.x[-1], 2))
    if not np.all(np.isfinite(opt.x)):
        raise AssertionError("non-finite trajectory")
    if args.plot:
        plot(opt, args.plot)
    return opt


if __name__ == "__main__":
    main()
