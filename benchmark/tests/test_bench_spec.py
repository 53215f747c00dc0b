"""The benchmark is driven by data: every cell, configuration, mix and
metric of ``BENCHMARK.json`` loads from its own files, ``BENCHMARK.json``
keeps to the contract's form, and a cell, mix and metric added as new
files and entries alone run without an edit."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return harness.load_spec()


def test_form_of_benchmark_json():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and len(s["command"]) <= 32
    assert 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.REPO,
                                        "BENCHMARK.json")) <= 64 * 1024
    names = [c["name"] for c in s["configs"]]
    assert len(set(names)) == len(names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
        assert len(c["reduced"]) <= 16
    cells = [w["name"] for w in s["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in s["workloads"]}) \
        == len(cells)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= set(cells)


@pytest.mark.parametrize("name", [w["name"] for w in spec()["workloads"]])
def test_every_cell_loads_from_its_files(name):
    cell = harness.Cell(spec(), name)
    assert cell.config["name"] == cell.config_name
    for kind, names in (("scenarios", ("make",)),
                        ("reference", ("solve", "gaps")),
                        ("work", ("operations", "reals"))):
        for n in names:
            assert callable(getattr(cell.module(kind), n)), (kind, n)
    assert cell.entry() is not None
    assert cell.limits and set(cell.limits) <= {"solution_gap", "cost_gap",
                                                "mu_step_differ"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(harness.reader("end_to_end", m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.reader("metrics", m["name"]))


def test_configs_keep_their_sources_settings():
    for c in spec()["configs"]:
        with open(os.path.join(harness.REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["dtype"] == "float64"


def copy_benchmark(tmp_path):
    """A checkout of the benchmark alone: ``BENCHMARK.json`` and
    ``benchmark/`` (the tests left out), under ``tmp_path``."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.REPO, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def run_in(root, script):
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{harness.REPO}")
    done = subprocess.run([sys.executable, "-c", script], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return [json.loads(line) for line in done.stdout.strip().splitlines()]


_NEW_CELL = r"""
import json, sys, time
from benchmark import harness
spec = harness.load_spec()
cell = harness.Cell(spec, "tracking_mpc.fleet_tiny")
cell.config["horizon"] = 10
res, _ = harness.run_cell(cell, 5, 0.05, False, "cpu", time.perf_counter())
print(json.dumps(res))
"""


def test_a_cell_of_new_files_alone_runs(tmp_path):
    """A copy of the benchmark gains a mix, a cell with its limits, and an
    end-to-end metric with its reader, as new files and new entries of
    BENCHMARK.json alone; the cell runs and reports the new metric."""
    root = copy_benchmark(tmp_path)
    s = spec()
    s["workloads"].append(dict(name="tracking_mpc.fleet_tiny",
                               config="tracking_mpc", traffic="fleet_tiny",
                               chips=1, why="a tiny batch"))
    s["end_to_end"].append(dict(name="calls_done", unit="calls",
                                better="higher", bound=0.05,
                                source="host_clock",
                                workloads=["tracking_mpc.fleet_tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    (root / "benchmark" / "traffic" / "fleet_tiny.json").write_text(
        json.dumps(dict(entry="fleet", batch=3, pool=2, kept_round_max=1,
                        inputs="spread")))
    (root / "benchmark" / "limits" / "tracking_mpc.fleet_tiny.json") \
        .write_text(json.dumps(dict(limits=dict(solution_gap=1e-6),
                                    control=dict(kind="program",
                                                 dtype="float32"))))
    (root / "benchmark" / "end_to_end" / "calls_done.py").write_text(
        "def read(run):\n    return float(len(run['walls']))\n")
    res, = run_in(root, _NEW_CELL)
    assert res["correct"] is True
    assert res["metrics"]["calls_done"]["value"] >= 1
    assert set(res["metrics"]) == {"setup_s", "calls_done"}


# a configuration whose program is no AL-iLQR solver: a running sum of each
# scenario's row, its reference in numpy, its own compared number and work
_TOY = {
    "configs/toy_scan.json": json.dumps(dict(name="toy_scan", width=16,
                                             dtype="float64")),
    "scenarios/toy_scan.py": (
        "import torch\n"
        "def make(cfg, traffic, seed, n, device):\n"
        "    g = torch.Generator(device=device)\n"
        "    g.manual_seed(seed)\n"
        "    return dict(a=torch.randn((n, cfg['width']), generator=g,\n"
        "                              dtype=torch.float64, device=device))\n"),
    "entries/toy_scan.py": (
        "import torch\n"
        "class Entry:\n"
        "    def __init__(self, cfg, traffic, scen, device, dtype):\n"
        "        self.batch, self.P = traffic['batch'], traffic['pool']\n"
        "        self.a, self.device, self.kept = scen['a'].to(dtype), "
        "device, {}\n"
        "    def call(self, i):\n"
        "        k = i % self.P\n"
        "        return torch.cumsum(self.a[k * self.batch:(k + 1) * "
        "self.batch], 1)\n"
        "    def keep(self, k, out):\n"
        "        self.kept[k] = out\n"
        "    def results(self):\n"
        "        ks = sorted(self.kept)\n"
        "        rows = [torch.arange(k * self.batch, (k + 1) * self.batch)\n"
        "                for k in ks]\n"
        "        return dict(y=torch.cat([self.kept[k] for k in ks])"
        ".double(),\n"
        "                    scenarios=torch.cat(rows))\n"
        "    def close(self):\n"
        "        self.kept.clear()\n"),
    "reference/toy_scan.py": (
        "import numpy as np, torch\n"
        "def solve(cfg, scen, rows, dtype):\n"
        "    np_dtype = np.float32 if dtype == torch.float32 else "
        "np.float64\n"
        "    a = scen['a'][rows].cpu().numpy().astype(np_dtype)\n"
        "    return dict(y=torch.as_tensor(np.cumsum(a, 1)))\n"
        "def gaps(program, ref):\n"
        "    d = (program['y'].cpu() - ref['y'].double()).abs()\n"
        "    return dict(widest_gap=float(d.max()))\n"),
    "work/toy_scan.py": (
        "def operations(cfg, ref):\n"
        "    return [cfg['width']] * len(ref['y'])\n"
        "def reals(cfg, batch):\n"
        "    return 2 * cfg['width'] * batch\n"),
    "traffic/scan.json": json.dumps(dict(entry="toy_scan", batch=4, pool=3,
                                         kept_round_max=1)),
    "limits/toy_scan.scan.json": json.dumps(dict(
        limits=dict(widest_gap=1e-12),
        control=dict(kind="reference", dtype="float32"))),
    "end_to_end/scans_per_s.py": (
        "def read(run):\n"
        "    return run['solves'] / run['window_s']\n"),
    "metrics/calls_traced.py": (
        "def read(ctx):\n"
        "    return float(len(ctx.calls_with_work()))\n"),
}

_TOY_RUNS = r"""
import json, time
from benchmark import harness
cell = harness.Cell(harness.load_spec(), "toy_scan.scan")
for trace, variant in ((False, "program"), (True, "program"),
                       (False, "control")):
    res, _ = harness.run_cell(cell, 2 ** 33 + 5, 0.05, trace, "cpu",
                              time.perf_counter(), variant)
    print(json.dumps(res))
"""


def test_a_configuration_of_another_kind_alone_runs(tmp_path):
    """A configuration whose program and reference are no AL-iLQR solve
    (its own inputs, entry, reference, compared number and work counts),
    with its mix, cell, limits, an end-to-end and a per-layer metric, is
    added as new files and entries alone: it runs, traced and not, and
    its control reads incorrect."""
    root = copy_benchmark(tmp_path)
    for rel, text in _TOY.items():
        (root / "benchmark" / rel).write_text(text)
    s = spec()
    s["configs"].append(dict(name="toy_scan", source="a running sum",
                             file="benchmark/configs/toy_scan.json",
                             reduced=[], why="a program of another kind"))
    s["workloads"].append(dict(name="toy_scan.scan", config="toy_scan",
                               traffic="scan", chips=1, why="a toy"))
    s["end_to_end"].append(dict(name="scans_per_s", unit="scans/s",
                                better="higher", bound=0.05,
                                source="host_clock",
                                workloads=["toy_scan.scan"]))
    s["per_layer"].append(dict(name="calls_traced.toy", unit="calls",
                               better="higher", source="program_counter",
                               layer="toy", moves="scans_per_s"))
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    plain, traced, control = run_in(root, _TOY_RUNS)
    assert plain["correct"] is True and traced["correct"] is True
    assert set(plain["metrics"]) == {"setup_s", "scans_per_s"}
    assert plain["checks"]["widest_gap"]["value"] == 0.0
    assert set(traced["metrics"]) == {"calls_traced.toy"}
    assert traced["metrics"]["calls_traced.toy"]["value"] >= 1
    assert control["correct"] is False
    assert control["checks"]["widest_gap"]["value"] > 1e-12
