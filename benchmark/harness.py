"""
The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
found by its name, so that a cell, configuration, mix or metric is added
by new files and entries of ``BENCHMARK.json`` alone:

- ``configs/<config>.json``: the configuration as it is run;
- ``scenarios/<config>.py``: ``make(cfg, traffic, seed, n, device)``,
  the cell's ``n`` seeded inputs, of the kind the mix's ``inputs`` names;
- ``reference/<config>.py``: ``solve(cfg, scen, rows, dtype)``, the plain
  reference's results for the scenarios ``rows``, and ``gaps(program,
  reference)``, the numbers the check compares;
- ``work/<config>.py``: ``operations(cfg, ref)``, the operations each
  scenario the reference solved needs, and ``reals(cfg, batch)``, the
  reals a call moves;
- ``traffic/<mix>.json``: the mix's parameters, whose ``entry`` names the
  driver ``entries/<entry>.py`` (``Entry``);
- ``limits/<cell>.json``: the limit of each number the check compares,
  and the cell's control (``program`` or ``reference`` at a lower
  ``dtype``);
- ``end_to_end/<metric>.py`` and ``metrics/<reader>.py``: a reader each
  (``read``), which returns None where it finds nothing to read; a
  per-layer metric's reader is named by the metric up to its first dot,
  so that ``device_idle_pct.fleet`` and ``device_idle_pct.solo`` share
  ``metrics/device_idle_pct.py``.

A run makes the inputs from the seed on the device, warms the entry up on
them, measures for the given seconds (traced with ``torch.profiler`` under
``trace``), and then, the window closed, frees the program's state and
judges what the timed calls returned against the reference.
"""

import gc
import importlib
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time

import torch

from benchmark import common, trace_reader
from benchmark.work import peaks

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpl_tpu")
WARM_CALLS = 2


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it is run
    with."""

    def __init__(self, spec, name, root=REPO):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        w = by_name[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.name, self.chips = name, int(w["chips"])
        self.config_name, self.traffic_name = w["config"], w["traffic"]
        with open(os.path.join(root, configs[w["config"]]["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(BENCH_DIR, "traffic",
                               w["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(BENCH_DIR, "limits", name + ".json")) as f:
            judged = json.load(f)
        self.limits, self.control = judged["limits"], judged["control"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def module(self, kind):
        """``scenarios``, ``reference`` or ``work`` of the cell's
        configuration."""
        return importlib.import_module(
            f"benchmark.{kind}.{self.config_name}")

    def entry(self):
        return importlib.import_module(
            f"benchmark.entries.{self.traffic['entry']}").Entry


def load_spec(root=REPO):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(kind, name):
    """The ``read`` of the metric ``name``: ``<kind>/<name>.py``, where
    ``name`` is taken up to its first dot."""
    base = name.split(".")[0]
    path = os.path.join(BENCH_DIR, kind, base + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def p95(values):
    """The 95th percentile by nearest rank: the smallest value that at
    least 95 % of ``values`` do not exceed."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Work:
    """The needed work of each timed call: the operations of the
    scenarios the reference solved, summed over each pool entry's, and
    the bytes a call moves."""

    def __init__(self, cell, batch, results, ref):
        work = cell.module("work")
        cfg = cell.config
        self.dtype = cfg["dtype"]
        size = torch.empty((), dtype=common.DTYPES[self.dtype]).element_size()
        self.slot_ops = {}
        for s, ops in zip(results["scenarios"].tolist(),
                          work.operations(cfg, ref)):
            k = s // (batch or 1)
            self.slot_ops[k] = self.slot_ops.get(k, 0) + ops
        self.bytes = work.reals(cfg, batch) * size

    def ops_of(self, slot):
        return self.slot_ops.get(slot)

    def bound_s(self, slot):
        ops = self.slot_ops.get(slot)
        return None if ops is None else peaks.bound_s(ops, self.bytes,
                                                      self.dtype)


class TraceContext:
    """What a per-layer metric reads: the trace's ``summary``, and for
    each traced call its ``slots`` and the ``work``."""

    def __init__(self, summary, slots, work):
        self.summary, self.slots, self.work = summary, slots, work

    def calls_with_work(self):
        """(call, operations, bound seconds) of each traced call whose
        work is known."""
        out = []
        for call, k in zip(self.summary.calls, self.slots):
            ops = self.work.ops_of(k)
            if ops is not None:
                out.append((call, ops, self.work.bound_s(k)))
        return out


def program_dtype(cell, variant):
    """The dtype the program runs in: the configuration's, or under
    ``variant`` ``control`` the control's where the control is the program
    at a lower precision."""
    control = cell.control if variant == "control" else None
    if control is not None and control["kind"] == "program":
        return common.DTYPES[control["dtype"]]
    return common.DTYPES[cell.config["dtype"]]


def reference_in_place(cell, scen, rows):
    """The control that puts the reference, at the control's lower
    precision, in the program's place: its results as float64."""
    low = cell.module("reference").solve(
        cell.config, scen, rows, common.DTYPES[cell.control["dtype"]])
    return dict({k: (v.to(torch.float64) if v.is_floating_point() else v)
                 for k, v in low.items()}, scenarios=rows)


def judge(numbers, limits):
    """``(correct, lines)``: whether every number is within its limit, and
    one line a number: its value and limit."""
    lines = {name: {"value": numbers.get(name, math.inf), "limit": limit}
             for name, limit in limits.items()}
    return all(v["value"] <= v["limit"] for v in lines.values()), lines


def run_cell(cell, seed, seconds, trace, device, t_start, variant="program"):
    """One run; returns the result's dict (the printed line's keys) and
    the numbers of the check.  ``variant`` ``control`` runs the cell's
    control in the program's place: the program at a lower precision, or
    the reference at one."""
    cfg, traffic = cell.config, cell.traffic
    dtype = program_dtype(cell, variant)
    dev = torch.device(device)
    n = traffic["pool"] * traffic.get("batch", 1)
    scen = cell.module("scenarios").make(cfg, traffic, seed, n, dev)
    if dev.type == "cuda":
        # the peak is the program's: not that of a reference solve that
        # made the inputs (a tick's ticks before it)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    entry = cell.entry()(cfg, traffic, scen, dev, dtype)
    for i in range(WARM_CALLS):
        entry.call(i)
    # each pool entry's result is kept from a seeded round of the window
    # (or its last, where the window ends first)
    pool = traffic["pool"]
    rng = random.Random(seed)
    keep_round = [rng.randrange(traffic["kept_round_max"])
                  for _ in range(pool)]
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    walls, failed = [], 0
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    with torch.profiler.record_function(trace_reader.WINDOW):
        i = 0
        while True:
            s = time.perf_counter()
            try:
                with torch.profiler.record_function(trace_reader.CALL):
                    out = entry.call(i)
            except RuntimeError as err:
                print(f"call {i} failed: {err}", file=sys.stderr)
                failed += 1
                break
            end = time.perf_counter()
            walls.append(end - s)
            k, r = i % pool, i // pool
            if r == 0 or r <= keep_round[k]:
                entry.keep(k, out)
            i += 1
            if end - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0 if failed else end - t0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            summary = trace_reader.read(path)
    slots = [j % pool for j in range(len(walls))]
    batch = entry.batch
    solves = len(walls) * (batch or 1)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    results = entry.results()
    entry.close()
    entry = out = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = results["scenarios"]
    reference = cell.module("reference")
    ref = reference.solve(cfg, scen, rows, torch.float64)
    if variant == "control" and cell.control["kind"] == "reference":
        results = reference_in_place(cell, scen, rows)
    numbers = reference.gaps(results, ref)
    correct, lines = judge(numbers, cell.limits)
    correct = correct and failed == 0 and len(walls) > 0

    if summary is None:
        run = dict(walls=walls, window_s=window_s, solves=solves,
                   setup_s=setup_s)
        metrics = {}
        for m in cell.end_to_end:
            v = reader("end_to_end", m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        work = Work(cell, batch, results, ref)
        n_calls = min(len(summary.calls), len(slots))
        summary.calls = summary.calls[:n_calls]
        ctx = TraceContext(summary, slots[:n_calls], work)
        metrics = {}
        for m in cell.per_layer:
            v = reader("metrics", m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    result = dict(correct=bool(correct), attempted=len(walls) + failed,
                  failed=failed, metrics=metrics)
    result["device"] = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=cell.chips, memory_peak_bytes=int(peak))
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = summary.breakdown
    result["checks"] = lines
    return result, numbers
