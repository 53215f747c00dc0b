"""
Scale-out demo: batched MPC tracking solves sharded over a device mesh.

The port of ``examples/scale_out.py``.  A scenario batch shards over a 1-D
mesh of devices (``tpl_tpu_torch.parallel.scenario_mesh``: the visible
cards, or ``--devices`` CPU entries with ``--cpu``), every device runs the
full AL-iLQR tracking solve on its shard (on a card the batched kernel,
``csrc/ilqr_tracking_mpc.cu``), and the globally best candidate cost
reduces on the first device (over the ranks too, where
``tpl_tpu_torch.parallel.init_distributed`` joined several processes).

Run: python -m tpl_tpu_torch.examples.scale_out              (the cards)
     python -m tpl_tpu_torch.examples.scale_out --cpu --devices 8

Prints per-configuration wall time and the scaling curve (CPU mesh entries
share the host's cores and run their shards one after the other, so a CPU
"efficiency" only validates the sharding, not a speedup).
"""

import argparse
import time

import torch

import tpl_tpu_torch
from tpl_tpu_torch.parallel import (mpc_setup, scenario_mesh,
                                    shard_scenarios, sharded_best_candidate)
from tpl_tpu_torch.parallel.dryrun import _sync, mpc_batched_solve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="a mesh of CPU entries instead of the cards")
    ap.add_argument("--devices", type=int, default=None,
                    help="the mesh's largest size (all cards, or 1 CPU "
                    "entry, unless given)")
    ap.add_argument("--per-device", type=int, default=64,
                    help="scenarios a device solves")
    ap.add_argument("--iterations", type=int, default=6,
                    help="AL-iLQR iterations a solve")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    tpl_tpu_torch.use_device("cpu" if args.cpu else "cuda")

    full = scenario_mesh(args.devices)
    print(f"devices: {len(full)} x {full[0].type}")
    H, dtype = 60, torch.float32
    prob, params, cfg, x0 = mpc_setup(dtype, H, args.iterations, full[0])
    solve_shard = mpc_batched_solve(prob, params, cfg, H, dtype)

    results = []
    for n in [d for d in (1, 2, 4, 8) if d <= len(full)]:
        B = args.per_device * n
        mesh = full[:n]
        solve = sharded_best_candidate(solve_shard, mesh)
        bx0 = shard_scenarios(
            x0[None, :] + 0.01 * torch.arange(B, dtype=dtype,
                                              device=x0.device)[:, None],
            mesh)

        u0, costs, best = solve(bx0)          # first call: builds
        _sync(mesh)
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            u0, costs, best = solve(bx0)
        _sync(mesh)
        dt = (time.perf_counter() - t0) / args.repeats
        rate = B / dt
        results.append((n, B, dt * 1e3, rate, float(best)))
        print(f"mesh={n}d  batch={B:4d}  {dt * 1e3:7.1f} ms/step  "
              f"{rate:8.0f} solves/s  best_cost={float(best):.3f}")

    if len(results) > 1:
        base = results[0][3]
        print("\nscaling (weak, batch grows with devices):")
        for n, B, ms, rate, _ in results:
            eff = rate / (base * n)
            print(f"  {n} devices: {rate / base:5.2f}x  efficiency "
                  f"{eff:5.1%}")
    return results


if __name__ == "__main__":
    main()
