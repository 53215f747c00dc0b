"""The metric arithmetic on fixed inputs: a rate over the whole window, a
p95 over every call, and the per-layer readings of a synthetic trace."""

import pytest

from benchmark import harness, trace_reader


def e2e(name, run):
    return harness.reader("end_to_end", name)(run)


def test_rates_and_tails_over_the_whole_window():
    walls = [0.001 * (i + 1) for i in range(100)]       # 1 .. 100 ms
    run = dict(walls=walls, window_s=6.0, solves=100 * 2048, setup_s=9.5)
    assert e2e("fleet_solves_per_s", run) == pytest.approx(100 * 2048 / 6.0)
    assert e2e("fleet_update_ms_p95", run) == pytest.approx(95.0)
    assert e2e("solo_ms_p95", run) == pytest.approx(95.0)
    solo = dict(run, solves=100)
    assert e2e("solo_ms_mean", solo) == pytest.approx(60.0)
    assert e2e("setup_s", run) == 9.5
    assert harness.p95([5.0]) == 5.0
    assert harness.p95(list(range(1, 21))) == 19


def x(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


def synthetic():
    """A window of 1,000 us with two calls: call 1 (0-400 us) runs a
    kernel 100-300 and a copy 300-350; call 2 (500-1,000 us) a kernel
    600-900 and a memset 900-920."""
    return [x(trace_reader.WINDOW, "user_annotation", 0, 1000),
            x(trace_reader.CALL, "user_annotation", 0, 400),
            x(trace_reader.CALL, "user_annotation", 500, 500),
            x("aten::copy_", "cpu_op", 20, 60),
            x("ker_a", "kernel", 100, 200),
            x("Memcpy DtoH", "gpu_memcpy", 300, 50),
            x("ker_b", "kernel", 600, 300),
            x("Memset", "gpu_memset", 900, 20),
            x("cudaLaunchKernel", "cuda_runtime", 560, 10)]


class FakeWork:
    dtype = "float64"

    def ops_of(self, slot):
        return 34e6 * (slot + 1)            # 1 and 2 us at the peak

    def bound_s(self, slot):
        return 1e-6 * (slot + 1)


def test_trace_summary_and_per_layer_readings():
    s = trace_reader.Summary(synthetic())
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(570e-6)
    assert [c["device_ops"] for c in s.calls] == [2, 2]
    assert [c["kernel_s"] for c in s.calls] == pytest.approx([2e-4, 3e-4])
    ctx = harness.TraceContext(s, [0, 1], FakeWork())
    read = lambda n: harness.reader("metrics", n)(ctx)
    assert read("device_idle_pct.fleet") == pytest.approx(43.0)
    assert read("device_idle_pct.solo") == pytest.approx(43.0)
    # walls 400 and 500 us less kernels 200 and 300 us
    assert read("batched_overhead_ms") == pytest.approx(0.2)
    assert read("solver_overhead_ms") == pytest.approx(0.2)
    assert read("device_ops_per_solve") == pytest.approx(2.0)
    # bounds 1 + 2 us over kernels 500 us
    assert read("ilqr_roofline.fleet") == pytest.approx(0.6)
    # 3 us of work at the peak in a window of 1 ms
    assert read("step_mfu.solo") == pytest.approx(0.3)
    gaps = dict(s.breakdown["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(430e-6)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert dict(s.breakdown["device_ops"])["ker_b"] == pytest.approx(3e-4)


def test_a_metric_and_its_dotted_kin_share_one_reader():
    for a, b in (("device_idle_pct.fleet", "device_idle_pct.solo"),
                 ("ilqr_roofline.fleet", "ilqr_roofline.solo"),
                 ("step_mfu.fleet", "step_mfu.solo")):
        assert harness.reader("metrics", a).__code__.co_filename == \
            harness.reader("metrics", b).__code__.co_filename


def test_readers_return_nothing_without_device_operations():
    events = [e for e in synthetic() if e["cat"] not in
              trace_reader.DEVICE_CATS]
    ctx = harness.TraceContext(trace_reader.Summary(events), [0, 1],
                               FakeWork())
    for name in ("device_idle_pct.fleet", "batched_overhead_ms",
                 "device_ops_per_solve", "ilqr_roofline.solo"):
        assert harness.reader("metrics", name)(ctx) is None
