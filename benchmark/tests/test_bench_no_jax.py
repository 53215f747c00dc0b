"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the yardstick (reference, work counts, scenarios, readers) imports
nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tpl_tpu"}
YARDSTICK = ("reference", "work", "scenarios", "metrics", "end_to_end")


def sources():
    for d, _, files in os.walk(harness.BENCH_DIR):
        if os.path.basename(d) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imported(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_yardstick_imports_nothing_of_the_port():
    for path in sources():
        rel = os.path.relpath(path, harness.BENCH_DIR)
        if rel.split(os.sep)[0] in YARDSTICK:
            assert "tpl_tpu_torch" not in set(imported(path)), rel


_PROBE = r"""
import sys, time
from benchmark import harness
cell = harness.Cell(harness.load_spec(), "tracking_mpc.fleet")
cell.traffic.update(batch=2, pool=1, kept_round_max=1)
cell.config["horizon"] = 8
harness.run_cell(cell, 3, 0.01, False, "cpu", time.perf_counter())
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "tpl_tpu")))
"""


def test_a_run_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=harness.REPO)
    done = subprocess.run([sys.executable, "-c", _PROBE], cwd=harness.REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
