"""
The readings the check's limits are set from: the numbers of the
configuration's ``gaps`` (``benchmark/reference/<config>.py``) for the
program and for the configuration's
control (the program at a lower precision, or the reference at one, in
the program's place), at the cell's own size, on the given seeds, in one
process so that the kernels are built once.

    python3 benchmark/readings.py --workload tracking_mpc.fleet \\
        --seeds 1,2,3 --control-seeds 4,5,6

The program's outputs are those of one call on each pool entry, which is
what a run's window returns for it (a call's result depends on its pool
entry alone).  Prints one JSON line a (cell, variant, seed).  The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import common, harness  # noqa: E402


def readings(cell, seed, variant, device):
    cfg, traffic = cell.config, cell.traffic
    n = traffic["pool"] * traffic.get("batch", 1)
    t = time.perf_counter()
    scen = cell.module("scenarios").make(cfg, traffic, seed, n, device)
    common.synchronize(device)
    inputs_s = time.perf_counter() - t
    rows = torch.arange(n, device=device)
    t = time.perf_counter()
    if variant == "control" and cell.control["kind"] == "reference":
        results = harness.reference_in_place(cell, scen, rows)
    else:
        entry = cell.entry()(cfg, traffic, scen, device,
                             harness.program_dtype(cell, variant))
        for i in range(traffic["pool"]):
            entry.keep(i, entry.call(i))
        results = entry.results()
        entry.close()
    program_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    reference = cell.module("reference")
    ref = reference.solve(cfg, scen, results["scenarios"], torch.float64)
    common.synchronize(device)
    reference_s = time.perf_counter() - t
    numbers = reference.gaps(results, ref)
    its = ref["iterations"].to(torch.float64)
    return dict(cell=cell.name, variant=variant, seed=seed,
                numbers=numbers, compared=int(rows.numel()),
                iterations_mean=float(its.mean()),
                iterations_max=int(its.max()),
                iterations_hist=torch.bincount(
                    ref["iterations"].cpu()).tolist(),
                inputs_s=inputs_s, program_s=program_s, reference_s=reference_s,
                memory_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    spec = harness.load_spec()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for name in args.workload:
        cell = harness.Cell(spec, name)
        for variant, ss in (("program", seeds), ("control", controls)):
            for seed in ss:
                print(json.dumps(readings(cell, seed, variant,
                                          torch.device(args.device))),
                      flush=True)


if __name__ == "__main__":
    main()
