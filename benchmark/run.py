"""
The benchmark of ``tpl_tpu_torch``: one run of one cell of
``BENCHMARK.json`` on the card this process finds.

    python3 benchmark/run.py --workload tracking_mpc.fleet --seed 7 \\
        --seconds 10 --trace 0

Prints the numbers the check compares, each beside its limit, as the last
lines of standard error, and one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown``
(``--trace 1``) and, last, ``checks``.  Exits non-zero without a result
where no CUDA device is found, fewer than the cell asks for, or where a
module of JAX or of the JAX package was loaded by the end of the run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    seed = args.seed % (2 ** 63)
    result, _ = harness.run_cell(cell, seed, args.seconds, bool(args.trace),
                                 "cuda:0", T_START)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"modules of JAX or the JAX package were loaded: {leaked}",
              file=sys.stderr)
        return 3
    for name, line in result["checks"].items():
        print(f"check {name}: {line['value']!r} (limit {line['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
