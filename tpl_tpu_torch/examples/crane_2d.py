"""
2-D gantry crane swing-free positioning example.

The port of ``examples/crane_2d.py``, the solver-core analog of the
reference's genopt crane demo (reference:
library/tpl/optim/examples/crane_2d/main.py): cart + pendulum payload, move
to a target with minimal swing under control limits.  On the card the
``Solver`` traces the problem's torch functions into the generic AL-iLQR
kernel's struct (``tpl_tpu_torch/optim/trace.py``) and solves in one
launch an update; on the CPU it runs the plain iLQR.

Run: python -m tpl_tpu_torch.examples.crane_2d          (on the card)
     python -m tpl_tpu_torch.examples.crane_2d --cpu    (on the CPU)
     python -m tpl_tpu_torch.examples.crane_2d --gui    (interactive
         browser view: drag the target and the rope length, tweak the
         weights, toggle receding-horizon simulation; add --cpu off the
         card)
"""

import argparse

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch.optim.ilqr import Problem
from tpl_tpu_torch.optim.solver import Solver


def make_problem():
    # states: cart position p, cart velocity dp, rope angle a, ang vel da
    # action: cart acceleration
    g = 9.81

    def dynamics(x, u, t, dt, p):
        dp, a, da = x[..., 1], x[..., 2], x[..., 3]
        acc = u[..., 0]
        return torch.stack([
            dp,
            acc,
            da,
            -(g * torch.sin(a) + acc * torch.cos(a)) / p["rope_len"],
        ], dim=-1)

    def cost(x, u, t, dt, p):
        c = p["w_u"] * u[..., 0] ** 2
        c = c + p["w_swing"] * x[..., 2] ** 2
        return c

    def end_cost(x, t, dt, p):
        return (p["w_trg"] * (x[..., 0] - p["p_trg"]) ** 2
                + p["w_trg"] * x[..., 1] ** 2
                + p["w_trg"] * x[..., 2] ** 2 * 10.0
                + p["w_trg"] * x[..., 3] ** 2)

    prob = Problem("crane_2d", nx=4, nu=1, nc=0,
                   dynamics=dynamics, cost=cost, end_cost=end_cost)
    spec = dict(rope_len=5.0, w_u=0.05, w_swing=2.0, w_trg=100.0,
                p_trg=10.0)
    return prob, spec


def make_solver(device=None):
    prob, spec = make_problem()
    opt = Solver(prob, spec, horizon_max=100, device=device)
    opt.horizon = 100
    opt.step = 0.1
    opt.max_iterations = 60
    opt.u_min[:] = -2.0
    opt.u_max[:] = 2.0
    opt.x[0] = [0.0, 0.0, 0.0, 0.0]
    return opt


def check(opt):
    """The example's acceptance: the target reached with minimal swing."""
    if not abs(opt.x[-1, 0] - 10.0) < 0.5:
        raise AssertionError(f"final position {opt.x[-1, 0]:.3f}, target 10")
    if not abs(opt.x[-1, 2]) < np.radians(3.0):
        raise AssertionError(f"final swing {np.degrees(opt.x[-1, 2]):.2f} "
                             "deg")


def crane_scene(opt):
    """Plot geometry for the interactive view: fading payload
    trajectory, cart marker, rope line (the reference's crane figure,
    crane_2d/main.py:136-151)."""
    r = np.asarray(opt.x[:, 0])
    a = np.asarray(opt.x[:, 2])
    L = opt.params.rope_len
    xe, ye = r + L * np.sin(a), -L * np.cos(a)
    return [
        {"kind": "line", "xy": np.column_stack([xe, ye]).tolist(),
         "color": "#ec5", "fade": True},
        {"kind": "line", "xy": [[r[0], 0.0], [xe[0], ye[0]]],
         "color": "#6ac", "size": 2},
        {"kind": "points", "xy": [[r[0], 0.0]], "color": "#6ac",
         "size": 5},
        {"kind": "points", "xy": [[xe[0], ye[0]]], "color": "#ec5",
         "size": 4},
    ]


def serve_gui(port=8024):
    """Interactive browser view: drag the target point / rope-length
    line, tweak weights, toggle receding-horizon simulation (the
    reference's imviz loop, crane_2d/main.py:123-186)."""
    from tpl_tpu_torch.gui.optim_view import OptimView, Handle

    opt = make_solver()
    handles = [
        Handle("target_position", "point",
               get=lambda o: (o.params.p_trg, 0.0),
               set=lambda o, x, y: setattr(o.params, "p_trg", x)),
        Handle("rope_length", "hline",
               get=lambda o: (0.0, -o.params.rope_len),
               set=lambda o, x, y: setattr(o.params, "rope_len",
                                           max(0.5, -y))),
    ]
    OptimView(opt, scene=crane_scene, handles=handles,
              title="crane_2d", port=port).serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU")
    ap.add_argument("--gui", action="store_true",
                    help="serve the interactive view (port 8024)")
    args = ap.parse_args(argv)
    tpl_tpu_torch.use_device("cpu" if args.cpu else "cuda")
    if args.gui:
        return serve_gui()

    opt = make_solver()
    opt.update()

    route = opt.route if opt.device.type == "cuda" else "the plain iLQR"
    print(f"solved on {opt.device} ({route}) in {opt.runtime:.1f} ms, cost "
          f"{opt.traj_costs:.3f}, {opt.iterations} iterations")
    print(f"final: position {opt.x[-1, 0]:.3f} (target 10), "
          f"swing {np.degrees(opt.x[-1, 2]):.2f} deg")
    check(opt)
    print("target reached with minimal swing")
    return opt


if __name__ == "__main__":
    main()
