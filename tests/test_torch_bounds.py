"""The kernels' bounds from shapes, the device default and the build key.

``bound_ms`` (roofline) and ``chain_ms`` (critical path) are computed by
Python functions in the kernels' wrapper modules from shapes and iteration
counts alone, so they are held here against byte, operation and step
counts worked out by hand at the main path's sizes (the tracking MPC at
H = 60, the RSTP solves and the rampify scan at H = 250, the DP slice at
S = 201, DS = 37, L = 21).  Only the latencies that ``chain_ms`` multiplies
come from the card; the tests pass made-up ones.
"""

import os

import pytest
import torch

import tpl_tpu_torch
from tpl_tpu_torch import _build, _latency
from tpl_tpu_torch.optim import ilqr, ilqr_rstp, ilqr_tracking_mpc as itm
from tpl_tpu_torch.optim import ilqr_tracking_mpc_time as itt
from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify as rmp


def test_roofline_takes_the_larger_time_and_names_it():
    # 3.35e9 bytes take 1 ms; 6.7e9 float32 operations take 0.1 ms
    ms, by = _latency.roofline_ms(3.35e9, 6.7e9, "float32")
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    # the float64 peak is 34 TFLOP/s: 3.4e10 operations take 1 ms
    ms, by = _latency.roofline_ms(3.35e6, 3.4e10, "float64")
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_chain_ms_prices_each_operation_with_its_latency():
    # 100 adds of 8 cycles and 10 divisions of 100 cycles at 2000 MHz:
    # 1800 cycles = 0.9 us
    ms = _latency.chain_ms({"f64_add": 100, "f64_div": 10},
                           {"f64_add": 8.0, "f64_div": 100.0, "x": 1.0}, 2000)
    assert ms == pytest.approx(0.9e-3)


def test_mpc_bounds_at_h60():
    H, n_ref, T, its = 60, 128, 60, 20
    # in: x 61*7, u 60*2, lam 60*4, u_lims 60*2*2, bw_lim 4*2, cfg 2,
    # alphas 8, 18 scalars, 5 tables of 128; out: x, u, lam, 3
    n_in = 427 + 120 + 240 + 240 + 8 + 2 + 8 + 18 + 640
    n_out = 427 + 120 + 240 + 3
    assert itm.traffic_bytes(H, n_ref) == 8 * (n_in + n_out) == 19944
    # per iteration and step: derivatives 164 (one pass over the step cost,
    # 119, and one operation for each of the 9 gradient, 25 upper Hessian
    # and 11 state-dependent Jacobian entries), a Riccati step 2520, 8
    # candidates of (203 + 119 + 1); once: the open rollout (2*58 + 35),
    # its cost and sum, one multiplier round of 20 per step
    assert itm.OPS["derivatives"] == 119 + 9 + 25 + 11 == 164
    per_it = 60 * (164 + 2520 + 8 * 323)
    once = 60 * (151 + 119 + 1) + 60 * 20
    assert itm.operations(H, T, its) == once + its * per_it == 6339060
    ms, by = itm.bound_ms(H, n_ref, T, its)
    assert by == "operations"
    assert ms == pytest.approx(6339060 / 34e12 * 1e3)
    # the derivatives are counted below one dense forward-mode pass per
    # variable, which any way of forming them exceeds
    assert itm.OPS["derivatives"] < 10 * 58 + 10 * 119
    # the critical path: 21 rollouts' worth of dynamics (2 per step), 20
    # Riccati passes, 21 ordered sums
    ops = itm.chain_ops(H, T, its)
    assert ops["f64_div"] == 60 * (21 * 2 * 2 + 20 * 1) == 6240
    assert ops["f64_cos"] == ops["f64_fmod"] == ops["smem_load"] == 2520
    assert ops["f64_mul"] == 60 * (21 * 6 + 20 * 3 + 2 + 20 * 7) == 19680
    assert ops["f64_add"] == 60 * (21 * 16 + 20 * 11 + 3 + 20 * 19
                                   + 21) == 57600
    # with every latency one cycle at 1000 MHz the path is its length in ns
    one = dict.fromkeys(_latency.PROBES, 1.0)
    assert itm.chain_ms(H, T, its, one, 1000) == pytest.approx(
        sum(ops.values()) * 1e-6)
    # fewer active steps and iterations shrink both
    assert itm.operations(H, 45, 3) < itm.operations(H, T, its)
    assert itm.chain_ops(H, 45, 3)["f64_div"] == 45 * (4 * 4 + 3)


def test_mpc_time_bounds_at_the_demo_horizon():
    """The time-indexed MPC at the demo control set's solve: capacity 60, 40
    active steps, 5 iterations."""
    H, n_ref, T, its = 60, 128, 40, 5
    # in: x 61*6, u 60*2, lam 60*4, u_lims 60*2*2, bw_lim 4*2, cfg 2,
    # alphas 8, 19 scalars, 4 tables of 128; out: x, u, lam, 3
    n_in = 366 + 120 + 240 + 240 + 8 + 2 + 8 + 19 + 512
    n_out = 366 + 120 + 240 + 3
    assert itt.traffic_bytes(H, n_ref) == 8 * (n_in + n_out) == 17952
    # per iteration and active step: derivatives 121 (the step cost 77, the
    # dynamics 18, 8 gradient, 10 upper Hessian and 8 state-dependent
    # Jacobian entries), a Riccati step 1740, 8 candidates of (109 + 77 +
    # 1); once: the lookups 30, the open rollout (2*18 + 31), its cost and
    # sum, one multiplier round of 20 a step
    assert itt.OPS["derivatives"] == 77 + 18 + 8 + 10 + 8 == 121
    once = 40 * (30 + 67 + 77 + 1) + 40 * 20
    per_it = 40 * (121 + 1740 + 8 * 187)
    assert itt.operations(H, T, its) == once + its * per_it == 679200
    ms, by = itt.bound_ms(H, n_ref, T, its)
    assert by == "operations"
    assert ms == pytest.approx(679200 / 34e12 * 1e3)
    # the critical path: 6 rollouts' worth of dynamics (2 a step: tan,
    # atan, cos, two products, a division), 5 Riccati passes, 6 ordered sums
    ops = itt.chain_ops(H, T, its)
    assert set(ops) <= set(_latency.PROBES)
    assert ops["f64_tan"] == ops["f64_atan"] == ops["f64_cos"] \
        == 40 * 6 * 2 == 480
    assert ops["f64_div"] == 40 * (6 * 2 + 5) == 680
    assert ops["f64_mul"] == 40 * (6 * 4 + 5 * 3 + 2 + 5 * 6) == 2840
    assert ops["f64_add"] == 40 * (5 * 10 + 3 + 5 * 17 + 6) == 5760
    one = dict.fromkeys(_latency.PROBES, 1.0)
    assert itt.chain_ms(H, T, its, one, 1000) == pytest.approx(
        sum(ops.values()) * 1e-6)
    # only the active steps count
    assert itt.operations(H, H, its) > itt.operations(H, T, its)


def test_mpc_batch_layout_and_bounds_at_h60():
    H, n_ref = 60, 128
    # the shared part: u_lims 60*2*2, bw_lim 4*2, cfg 2, alphas 8, 5 tables
    # of 128; a scenario's row: x0 7, u 60*2, lam 60*4, 18 scalars
    shared, row = itm.batched_layout(H, n_ref)
    assert ilqr.layout(shared)[1] == 240 + 8 + 2 + 8 + 640 == 898
    assert ilqr.layout(row)[1] == 7 + 120 + 240 + 18 == 385
    # with the packed results (790 a scenario) and both parts read once
    assert itm.traffic_bytes_batched(3, H, n_ref) == 8 * (898 + 3 * (385
                                                                    + 790))
    assert itm.traffic_bytes_batched(3, H, n_ref, 4) == 4 * (898 + 3 * 1175)
    # per iteration the derivatives and the Riccati pass; per candidate
    # rolled a rollout, its step costs and its sum
    once = 60 * (151 + 119 + 1) + 60 * 20
    per_it, per_cand = 60 * (164 + 2520), 60 * (203 + 119 + 1)
    assert itm.operations(H, H, 3, rolled=5) == once + 3 * per_it \
        + 5 * per_cand
    assert itm.operations(H, H, 3) == itm.operations(H, H, 3, rolled=24)
    its, rolled = [1, 8, 3], [8, 16, 5]
    n_ops = sum(once + i * per_it + r * per_cand
                for i, r in zip(its, rolled))
    roof, by = itm.roofline_ms_batched(H, n_ref, H, its, rolled)
    assert by == "operations" and roof == pytest.approx(n_ops / 34e12 * 1e3)
    roof32, _ = itm.roofline_ms_batched(H, n_ref, H, its, rolled,
                                        torch.float32)
    assert roof32 == pytest.approx(n_ops / 67e12 * 1e3)
    # the bound: the larger of the roofline and the longest scenario's
    # chain at its own iteration count (8 here), one rollout an iteration
    one = dict.fromkeys(_latency.PROBES, 1.0)
    chain8 = itm.chain_ms(H, H, 8, one, 1000)
    assert chain8 == pytest.approx(sum(itm.chain_ops(H, H, 8).values())
                                   * 1e-6)
    assert itm.bound_ms_batched(H, n_ref, H, its, rolled, one, 1000) == (
        pytest.approx(chain8), "chain")
    fast = dict.fromkeys(_latency.PROBES, 1e-6)
    assert itm.bound_ms_batched(H, n_ref, H, its, rolled, fast, 1000) == (
        pytest.approx(roof), "operations")
    # rollouts one after the other lengthen the chain; one an iteration is
    # the default
    assert itm.chain_ops(H, H, 8) == itm.chain_ops(H, H, 8, rolled=8)
    assert itm.chain_ops(H, H, 8, rolled=16)["f64_div"] == 60 * (17 * 4 + 8)
    # the design's floor: the longest chain, or the chains over the warps
    assert itm.floor_ms_batched([1.0, 2.0, 3.0], 2, 1) == 3.0
    assert itm.floor_ms_batched([1.0] * 6, 1, 2) == 3.0


def test_mpc_batch_chain_in_float32_takes_float32_latencies():
    """A float32 batch's chain counts the same operations as float64's,
    each priced at its ``f32_*`` probe (the angle distance's mod at
    ``f32_fmod``); the bound of a float32 batch takes those latencies."""
    H, n_ref = 60, 128
    ops64 = itm.chain_ops(H, H, 8, rolled=12)
    ops32 = itm.chain_ops(H, H, 8, rolled=12, dtype=torch.float32)
    assert ops32 == {k.replace("f64_", "f32_"): v for k, v in ops64.items()}
    assert set(ops32) <= set(_latency.PROBES)
    assert ops32["f32_fmod"] == ops64["f64_fmod"] == 2 * 60 * 13
    assert not any(k.startswith("f64_") for k in ops32)
    # float64 latencies twice float32's: the float32 chain is half as long
    # but for its shared-memory loads
    lat = {k: (2.0 if k.startswith("f64_") else 1.0) for k in _latency.PROBES}
    c64 = itm.chain_ms(H, H, 8, lat, 1000, rolled=12)
    c32 = itm.chain_ms(H, H, 8, lat, 1000, rolled=12, dtype=torch.float32)
    loads = ops64["smem_load"] * 1e-6
    assert c32 - loads == pytest.approx((c64 - loads) / 2)
    its, rolled = [1, 8, 3], [8, 16, 5]
    assert itm.bound_ms_batched(H, n_ref, H, its, rolled, lat, 1000,
                                torch.float32) == (
        pytest.approx(itm.chain_ms(H, H, 8, lat, 1000, dtype=torch.float32)),
        "chain")
    with pytest.raises(ValueError, match="no chain"):
        itm.chain_ops(H, H, 8, dtype=torch.float16)


@pytest.mark.parametrize("name,n_tab,n_scal,nc,step_cost,roll,deriv,mult", [
    # deriv: one pass over the step cost and one operation for each
    # gradient, upper Hessian and state-dependent Jacobian entry
    ("lateral_profile", 4, 5, 2, 58, 35, 58 + 3 + 6 + 0, 12),
    ("velocity_profile_space", 6, 4, 5, 79, 46, 79 + 3 + 5 + 3, 25)])
def test_rstp_bounds_at_h250(name, n_tab, n_scal, nc, step_cost, roll, deriv,
                             mult):
    H, n_ref, T, its = 250, 250, 250, 4
    n_in = (251 * 2 + 250 + 250 * nc + 500 + 2 * nc + 2 + 8 + n_scal
            + n_tab * n_ref + 1)
    n_out = 251 * 2 + 250 + 250 * nc + 3
    assert ilqr_rstp.traffic_bytes(name, H, n_ref) == 4 * (n_in + n_out)
    per_it = 250 * (deriv + 113 + 8 * (roll + step_cost + 1))
    once = 250 * (roll - 11 + step_cost + 1) + 250 * mult
    assert ilqr_rstp.operations(name, H, T, its) == once + its * per_it
    ms, by = ilqr_rstp.bound_ms(name, H, n_ref, T, its)
    assert by == "operations"
    assert ms == pytest.approx((once + its * per_it) / 67e12 * 1e3)
    ops = ilqr_rstp.chain_ops(name, H, T, its)
    div = 1 if name == "velocity_profile_space" else 0
    assert ops.get("f32_div", 0) == 250 * (its * (1 + div) + div)
    assert ops["f32_mul"] == 250 * (its * (2 + 5) + 1) == 7250
    assert ops["f32_add"] == 250 * (its * (4 + 5) + 1 + its + 1) == 10500
    # an active horizon below H counts the steps that move
    assert ilqr_rstp.chain_ops(name, H, 100, 1)["f32_mul"] == 100 * 8


def test_rstp_bounds_reject_an_unknown_problem():
    with pytest.raises(ValueError):
        ilqr_rstp.operations("trajectory_tracking_mpc", 60, 60, 1)


def test_rampify_bounds_at_h250():
    H = 250
    # 8 scalars and 250 limits in, 250 rows of 2 out, 4 bytes each
    assert rmp.traffic_bytes(H) == 4 * 258 + 4 * 500 == 3032
    # 250 staged limits, 249 backward steps of 15, 250 forward steps of 17
    assert rmp.operations(H) == 250 + 249 * 15 + 250 * 17 == 8235
    ms, by = rmp.bound_ms(H)
    assert by == "bytes" and ms == pytest.approx(3032 / 3.35e12 * 1e3)
    ops = rmp.chain_ops(H)
    assert ops == {"f32_div": 2 * 249 + 2 * 250, "f32_mul": 2 * 249 + 2 * 250,
                   "f32_add": 4 * 249 + 5 * 250}
    lat = {"f32_div": 40.0, "f32_mul": 4.0, "f32_add": 4.0}
    cycles = 998 * 40 + 998 * 4 + 2246 * 4
    assert rmp.chain_ms(H, lat, 2000) == pytest.approx(cycles / 2000 * 1e-3)


def test_action_min_bounds_at_the_demo_grid():
    S, DS, L = 201, 37, 21
    cells = S * DS * L
    assert cells == 156177
    tables = 3 * 37 * 7 + 7 + 37 * 49 + 37 * 7 + 4 * 7 + 37 + 5
    words = 4 * cells + 2 * cells + S * L * 7 + tables + 4 * cells
    assert lam.traffic_bytes(S, DS, L) == 4 * words == 6376972
    assert lam.operations(S, DS, L) == cells * (49 * 21 + 23) == 164298204
    ms, by = lam.bound_ms(S, DS, L)
    assert by == "operations"
    assert ms == pytest.approx(164298204 / 67e12 * 1e3)
    assert lam.bound_ms(S, DS, L)[0] > 6376972 / 3.35e12 * 1e3
    lat = {"smem_load": 30.0, "f32_add": 4.0, "f32_mul": 4.0}
    assert lam.chain_ms(lat, 1000) == pytest.approx(
        (30 + 12 * 4 + 2 * 4) * 1e-6)


def test_fused_slice_bounds_at_the_demo_grid():
    S, DS, L = 201, 37, 21
    cells = S * DS * L
    tables = 3 * 37 * 7 + 7 + 37 * 49 + 37 * 7 + 4 * 7 + 37 + 5
    # next nodes and nodes (4 words a cell each), the (S, L) distance map,
    # S reference rows of 8, the reference step, 17 slice constants
    words = 4 * cells + S * L + S * 8 + 1 + 17 + tables + 4 * cells
    assert len(lam.SLICE_CONSTS) == 17
    assert lam.slice_traffic_bytes(S, DS, L) == 4 * words == 5032756
    # the two state maps and d_fwd are no longer moved
    assert lam.slice_traffic_bytes(S, DS, L) < lam.traffic_bytes(S, DS, L)
    # per cell 6 operations per searched offset and 49 others; per (s, l)
    # 20; per s 9; per (l, dl) 6; per ds 4
    producers = (cells * (6 * 21 + 49) + S * L * 20 + S * 9 + 21 * 7 * 6
                 + 37 * 4)
    assert lam.slice_operations(S, DS, L) == 164298204 + producers
    assert producers == 27418234
    ms, by = lam.slice_bound_ms(S, DS, L)
    assert by == "operations"
    assert ms == pytest.approx((164298204 + producers) / 67e12 * 1e3)
    lat = {"smem_load": 30.0, "f32_add": 4.0, "f32_mul": 4.0, "f32_div": 40.0}
    assert lam.slice_chain_ms(lat, 1000) == pytest.approx(
        (3 * 30 + 24 * 4 + 6 * 4 + 40) * 1e-6)


def test_phase_names_follow_the_kernels_clock():
    assert len(ilqr.PHASES) == 10
    assert ilqr.PHASES[0] == "load" and ilqr.PHASES[-1] == "store"
    assert set(ilqr.ITERATION_PHASES) < set(ilqr.PHASES)
    assert "riccati" in ilqr.ITERATION_PHASES
    assert "init_rollout" not in ilqr.ITERATION_PHASES


def test_probe_and_profiles_need_the_card():
    """The measuring entry points raise on a CPU tensor or device: they
    have no plain version to fall back to."""
    with pytest.raises(ValueError):
        _latency.measure("cpu")
    with pytest.raises(ValueError):
        itm.profile(torch.zeros(2493, dtype=torch.float64), 60, 128, 60, 1,
                    1, 0)
    n = ilqr.layout(ilqr_rstp.input_layout("lateral_profile", 60, 64))[1]
    with pytest.raises(ValueError):
        ilqr_rstp.profile("lateral_profile",
                          torch.zeros(n, dtype=torch.float32), 60, 64, 60, 1,
                          1)


def test_rampify_profile_needs_the_card():
    """The scan's profiling instantiation has no plain version either, and
    its phase names are the kernel's four."""
    one = torch.ones(1)
    with pytest.raises(ValueError):
        rmp.profile(one, one, torch.ones(8), 8, *([one] * 6))
    assert rmp.PHASES == ("stage", "backward", "forward_stage", "forward")


def test_unset_device_is_the_card():
    """``device()`` without ``use_device`` resolves to cuda, and raises
    where there is no card instead of handing out the CPU."""
    saved = tpl_tpu_torch._DEVICE
    tpl_tpu_torch._DEVICE = None
    try:
        if torch.cuda.is_available():
            assert tpl_tpu_torch.device() == torch.device("cuda")
            assert tpl_tpu_torch._DEVICE == torch.device("cuda")
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tpl_tpu_torch.device()
            with pytest.raises(RuntimeError):
                ilqr.init_state(None, 4)
            assert tpl_tpu_torch._DEVICE is None
        tpl_tpu_torch.use_device("cpu")
        assert tpl_tpu_torch.device() == torch.device("cpu")
    finally:
        tpl_tpu_torch._DEVICE = saved


def test_build_tag_follows_included_headers(tmp_path):
    """An edited ``#include "..."``d header changes the library's tag; an
    unrelated file and a system include do not."""
    (tmp_path / "k.cu").write_text(
        '#include <math.h>\n#include "k_common.cuh"\nint k() { return K; }\n')
    (tmp_path / "k_common.cuh").write_text(
        '#include "k_deep.cuh"\n#define K 1\n')
    (tmp_path / "k_deep.cuh").write_text("// nothing\n")
    (tmp_path / "other.cuh").write_text("#define OTHER 1\n")
    src, so = _build._paths("k", str(tmp_path))
    assert src == str(tmp_path / "k.cu")
    assert os.path.dirname(so) == _build.BUILD_DIR
    assert _build._paths("k", str(tmp_path))[1] == so
    (tmp_path / "other.cuh").write_text("#define OTHER 2\n")
    assert _build._paths("k", str(tmp_path))[1] == so
    (tmp_path / "k_common.cuh").write_text(
        '#include "k_deep.cuh"\n#define K 2\n')
    so2 = _build._paths("k", str(tmp_path))[1]
    assert so2 != so
    (tmp_path / "k_deep.cuh").write_text("// something\n")
    so3 = _build._paths("k", str(tmp_path))[1]
    assert so3 not in (so, so2)
    (tmp_path / "k.cu").write_text(
        '#include "k_common.cuh"\nint k() { return K + 1; }\n')
    assert _build._paths("k", str(tmp_path))[1] not in (so, so2, so3)


def test_kernel_sources_share_the_common_header():
    """Both iLQR kernels include csrc/ilqr_common.cuh, so their tags move
    with it."""
    for name in ("ilqr_tracking_mpc", "ilqr_rstp"):
        seen = set()
        _build._sources(os.path.join(_build.CSRC, name + ".cu"), seen)
        assert os.path.join(_build.CSRC, "ilqr_common.cuh") in seen


def test_dir_dist_bounds_count_the_samples_marched():
    """The field's bound counts the samples this field needed: a ray that
    blocks at sample i marched i + 1, a free one all ``ray_steps``."""
    from tpl_tpu_torch.planning.dyn_prog import dp_environment as dpe

    field = torch.tensor([0.0, 1.5, dpe.FREE_DIST, 0.5],
                         dtype=torch.float32).reshape(1, 1, 1, 4)
    assert dpe.dir_dist_samples(field, 0.5, 72) == 1 + 4 + 72 + 2
    # 4 bytes of occupancy, 4 x 8 of rays, 4 x 4 of field written
    assert dpe.dir_dist_bytes(1, 1, 1, 4) == 4 + 32 + 16
    ms, by = dpe.dir_dist_bound_ms(field, 0.5, 72)
    ops = 79 * dpe.OPS_SAMPLE + 4
    assert by == "operations" and ms == pytest.approx(ops / 67e9)
    # the demo grid with every ray free: operations lead
    T, S, L, D = 10, 201, 21, 21
    free = torch.full((T, S, L, D), dpe.FREE_DIST)
    ms, by = dpe.dir_dist_bound_ms(free, 0.5, 72)
    ops = T * S * L * D * (72 * dpe.OPS_SAMPLE + 1)
    assert by == "operations" and ms == pytest.approx(ops / 67e9)
    cycles = {"f32_mul": 4.0, "f32_add": 4.0, "f32_div": 40.0,
              "smem_load": 30.0}
    assert dpe.dir_dist_chain_ms(free, 0.5, 72, cycles, 2000) == \
        pytest.approx(72 * (4 + 8 + 40 + 30) / 2e6)


def test_graph_dp_bounds_at_the_demo_widths():
    from tpl_tpu_torch.planning.dyn_prog import poly_planner_kernel as ppk

    # 400,000 edges of 37 steps from 1,939 start points over the demo field
    ops = ppk.eval_operations(400_000, 37)
    assert ops == 400_000 * (37 * ppk.OPS_STEP + ppk.OPS_EDGE)
    n_bytes = ppk.eval_bytes(1939, 400_000, (10, 201, 21, 21), 401)
    assert n_bytes == (32 * 1939 + 16 * 400_000 + 4 * 886_410 + 32 * 401
                       + 32 * 400_000)
    ms, by = ppk.eval_bound_ms([1939], [400_000], (10, 201, 21, 21), 401,
                               37)
    assert by == "operations" and ms == pytest.approx(ops / 67e9)
    # a replan's two launches: the root's 1,939 edges, then the 400,000
    ms2, _ = ppk.eval_bound_ms([1, 1939], [1939, 400_000],
                               (10, 201, 21, 21), 401, 37)
    assert ms2 == pytest.approx((ops + ppk.eval_operations(1939, 37))
                                / 67e9)
    # the propagation of a root, 3 level-1 nodes and 5 leaves: the leaves'
    # float32 costs, level 1's float64 ones, 2 + 4 offsets, 4 nodes' costs
    # and edges written (12 bytes each, and the offsets' 4), the trajectory
    node_off, seg_off = [0, 1, 4, 9], [0, 2, 6]
    assert ppk.propagate_bytes(node_off, seg_off) == (
        4 * 5 + 8 * 3 + 4 * 6 + 4 * 4 + 12 * 4 + 8 * 8 * 3)
    cycles = {"f64_add": 8.0, "smem_load": 30.0}
    seg = [0, 3, 0, 2, 2, 5]
    # level 1: the longest range 3 edges, one round; level 0: 3, one round
    assert ppk.propagate_chain_ms(node_off, __import__("numpy").array(seg),
                                  seg_off, cycles, 2000) == pytest.approx(
        (2 * (8 + 30) + 2 * (5 * 8 + 5 * 30) + 2 * 2 * 30) / 2e6)


def test_idm_full_scan_bounds_at_the_bench_width():
    """The full-scan bounds keep their counts: per candidate step 22 per
    hull point, 14 per object, 8 per ref cell, 16 per segment, 300 for the
    speed-limit lookups and 120 for the IDM law and the controller; per
    (candidate, step, object) of the evaluation the gate and a projection
    onto all P - 1 path segments."""
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
    C, T, NR, O, P, K = 16384, 100, 801, 12, 16, 16
    per_step = 22 * O * K + 14 * O + 8 * NR + 16 * (NR - 1) + 300 + 120
    assert idk.rollout_operations(C, T, NR, O, K) == C * (T - 1) * per_step
    per_obj = 10 + 16 * (P - 1) + 8 * P + 12
    sat = 18 * K + (3 * K + 18) * K
    assert idk.evaluate_operations(C, T, O, P, K, 5, 7) == (
        C * T * (O * per_obj + 12) + 12 * sat)


def _hairpin_rollout(C=12, T=40):
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
    from tpl_tpu_torch.scenes import idm_args, idm_hairpin_scene
    import numpy as np
    rl, objs, pp, ir, ic = idm_hairpin_scene()
    l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    d_stops = np.full(C, 1e6, np.float32)
    a = idm_args(rl, objs, pp, ir, ic, l_trgs, d_stops, "cpu")
    refs, cons = idk.rollout_reference(*a[:4], a[4][0], a[5], a[6][0], a[7],
                                       a[8], T)
    return a, refs, cons


def test_idm_needed_work_counts_what_an_exact_search_needs():
    """On the hairpin scene the needed-work bound counts fewer operations
    than the full scan, at least one chunk of segments a step, the cells
    of the chunks the stop point opens, and only the path projections the
    path gate lets through."""
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
    C, T = 12, 40
    a, refs, cons = _hairpin_rollout(C, T)
    NR, (O, P, K) = a[5].shape[0], a[7]["hull_preds"].shape[:3]
    w = idk.rollout_work(refs, cons, a[5], a[6][0], a[8])
    n_sch = (NR - 1 + 31) // 32
    assert w["seg_chunks"] == C * (T - 1) * n_sch
    assert 32 * C * (T - 1) <= w["segments"] < C * (T - 1) * (NR - 1)
    assert w["cells"] > 0 and w["cells"] % 32 == 0
    needed = idk.rollout_operations(C, T, NR, O, K, w)
    assert needed < idk.rollout_operations(C, T, NR, O, K)
    n_coll, n_inter, n_proj = idk.evaluate_work(cons, a[7], a[8],
                                                projections=True)
    assert (n_coll, n_inter) == idk.evaluate_work(cons, a[7], a[8])
    assert 0 < n_proj < C * T * O
    assert idk.evaluate_operations(C, T, O, P, K, n_coll, n_inter, n_proj) < \
        idk.evaluate_operations(C, T, O, P, K, n_coll, n_inter)
    ms, by = idk.rollout_bound_ms(C, T, NR, O, P, K, w)
    assert by in ("bytes", "operations") and ms > 0


def test_idm_box_keys_never_exclude_the_nearest_segment():
    """The exact pruning's premise, on every step of the hairpin rollouts:
    the chunk that holds the projection's nearest segment has a box key
    not above the least squared distance (float32, the kernels' formula),
    and so does every chunk holding a segment at that least distance."""
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
    a, refs, cons = _hairpin_rollout()
    rl = a[5]
    NR = rl.shape[0]
    n_sch = (NR - 1 + 31) // 32
    boxes = idk._grown_boxes(rl[:, 0], rl[:, 1], n_sch)
    ax, ay, vx, vy, vv = (t[:, None] for t in
                          idk._seg_tables(rl[:, :2])[:5])
    px, py = cons[:, 1:, idk.V_X].flatten(), cons[:, 1:, idk.V_Y].flatten()
    q = torch.clamp(((px - ax) * vx + (py - ay) * vy) / vv, 0.0, 1.0)
    ex, ey = px - (ax + vx * q), py - (ay + vy * q)
    d2 = ex * ex + ey * ey                                  # (NR - 1, N)
    best = d2.amin(0)
    key = idk._box_key(boxes[:, None], px, py)              # (n_sch, N)
    at_min = d2 == best
    chunk_of = torch.arange(NR - 1) // 32
    for j in range(n_sch):
        holds = at_min[chunk_of == j].any(0)
        assert bool((key[j][holds] <= best[holds]).all())
    # and the boxes exclude most chunks: the pruning decides here
    assert float((key > best).float().mean()) > 0.5
