"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

On a machine with a card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Tolerances: the action-min kernel as in test_torch_latlon_solver.py (cost
rtol=1e-6, atol=1e-3; constraint atol=1e-4; trajectory atol=1e-3); the
float64 iLQR kernel against its plain version x, u atol=1e-6, traj_costs
rtol=1e-9, mu_step and the iteration count equal; the float64 time-indexed
MPC kernel x, u, lam atol = rtol = 1e-9, traj_costs rtol=1e-9, mu_step and
the iteration count equal, its profiling instantiation bit-equal with phases
that sum to within 5 % of the launch's time; the float32 RSTP iLQR
kernel against its plain version x, u, lam atol=2e-2, traj_costs
rtol=1e-5 (where each solve stops is decided by float32 rounding, see
RSTP_X_ATOL); the rampify scan bit for bit; the fused DP slice for a
scenario batch (and its profiling instantiation) bit for bit against the
one-scenario launches and the plain version (NaN equal to NaN); the batched tracking-MPC kernel
(a warp per scenario, persistent) against the plain batched update at the
float64 kernel's own tolerance (x, u, lam atol=1e-6: on seeded warm starts
a scenario's rounding differences grow to 1e-8 and more over 8 iterations;
chip_smoke.py holds 99 % of the bench's cold batch to 1e-9) with equal
mu_step and iteration counts, each scenario bit-equal to a single launch;
its float32 instantiation
at the float32 tolerance above, with equal mu_step and iteration counts, on
at least 90 % of a seeded batch's scenarios (an accepted or rejected last
step of equal cost to rounding moves a control and the steps after it); the
IDM rollout and evaluation against their plain versions at rtol = atol =
1e-5 (the JAX package's own lanes-vs-vmap tolerance: the card's sin / cos /
atan / tanh / pow and torch's may part by an ulp, and a closed loop carries
it), ``invalid`` equal; the poly-sampling grid's winner equal, its float64
rows to 1e-9 (the coefficient solves sum in another order); the graph DP
planner's directional field cell for cell, its edge evaluation bit for bit
(the same float32 operations in the same order, neither contracted) and
its propagation's selections, costs and trajectory exactly.
"""

import subprocess

import numpy as np
import pytest
import torch

from tpl_tpu_torch.optim import batched, ilqr, ilqr_rstp
from tpl_tpu_torch.optim import ilqr_tracking_mpc as itm
from tpl_tpu_torch.optim import ilqr_tracking_mpc_time as itt
from tpl_tpu_torch.optim import problems, solver
from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as tllk
from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
from tpl_tpu_torch.planning.dyn_prog import lon_kernel as tlk
from tpl_tpu_torch.planning.dyn_prog import poly_chain_kernel as tpck
from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as plk
from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify
from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
from tpl_tpu_torch.planning.idm_sampling import idm_sampling_planner as isp
from tpl_tpu_torch.planning.poly_sampling import poly_kernel as pok
from tpl_tpu_torch.planning.poly_sampling import poly_sampling_planner as psp
from tpl_tpu_torch.planning.dyn_prog import dp_environment as dpe
from tpl_tpu_torch.planning.dyn_prog import poly_planner_kernel as ppk
from tpl_tpu_torch.scenes import (LON_DEMO, LON_EDGE, MPC_TIME_KINDS,
                                  dp_moving_occ, dp_poly_buffers,
                                  dp_poly_env, dp_poly_near_horizon,
                                  dp_poly_propagation_case,
                                  dp_random_occ,
                                  idm_args, idm_bench_scene,
                                  idm_hairpin_scene, idm_scene,
                                  idm_through_states, lon_nodes, lon_scene,
                                  lon_nan_values, lon_shifted_start,
                                  mpc_time_case, NAN_VALUES, poly_lat_scene,
                                  poly_lat_nan_bounds, poly_lat_select_edge,
                                  poly_scene, rampify_args, SELECT_EDGES)
import tpl_tpu_torch

COST_RTOL, COST_ATOL = 1e-6, 1e-3
CONSTR_ATOL = 1e-4
TRAJ_ATOL = 1e-3
DEMO = dict(t_steps=10, s_steps=201, ds_steps=37, l_steps=21)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _seeded(rng, dev, tables, S, DS, L):
    dds_v = tables["dds_vals"].cpu().numpy()
    dl_v = tables["dl_vals"].cpu().numpy()
    nodes = np.stack([rng.uniform(0, 1e4, (S, DS, L)),
                      rng.uniform(0, 5, (S, DS, L))
                      * (rng.uniform(size=(S, DS, L)) < 0.2),
                      rng.choice(dds_v, (S, DS, L)),
                      rng.choice(dl_v, (S, DS, L))], -1)
    arrays = (nodes, rng.uniform(0, 1e3, (S, DS, L)),
              rng.uniform(0, 2, (S, DS, L)),
              rng.uniform(-5, 60, (S, L, lam.NB)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("S,DS,L", [(201, 37, 21), (61, 9, 11), (37, 5, 3)])
def test_action_min_kernel_matches_plain(cuda, S, DS, L):
    rng = np.random.default_rng(S)
    p = tllk.LatLonParams()
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=4, s_steps=S, ds_steps=DS, l_steps=L), cuda)
    pp = tllk.unpack_pp(torch.from_numpy(p.packed()).to(cuda))
    tables = solve.action_tables(pp)
    args = _seeded(rng, cuda, tables, S, DS, L)
    before = lam.launches
    got = lam.action_min(*args, tables)
    torch.cuda.synchronize()
    assert lam.launches == before + 1
    want = lam.action_min_reference(*args, tables)
    np.testing.assert_allclose(got[..., 0].cpu(), want[..., 0].cpu(),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(got[..., 1].cpu(), want[..., 1].cpu(),
                               rtol=0, atol=CONSTR_ATOL)
    # the kernel rounds op for op like the plain version
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S,DS,L,ts_rows", [
    (201, 37, 21, 5), (201, 37, 21, 16), (61, 9, 11, 7), (37, 5, 3, 1),
    (37, 5, 3, 64), (9, 3, 40, 8)])
def test_action_min_tile_edges_match_plain(cuda, S, DS, L, ts_rows):
    """Tiles whose height does not divide S, is larger than S, or fills a
    block of more than 256 threads: the same bits as the plain version and
    as the default tile."""
    rng = np.random.default_rng(S + ts_rows)
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=4, s_steps=S, ds_steps=DS, l_steps=L), cuda)
    pp = tllk.unpack_pp(torch.from_numpy(tllk.LatLonParams().packed())
                        .to(cuda))
    tables = solve.action_tables(pp)
    args = _seeded(rng, cuda, tables, S, DS, L)
    out = torch.empty_like(args[0])
    stream = torch.cuda.current_stream(cuda).cuda_stream
    err = lam._kernel().latlon_action_min_tiled(
        *[a.data_ptr() for a in args], *tables.ptrs, out.data_ptr(), S, DS,
        L, ts_rows, stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, lam.action_min_reference(*args, tables))
    assert torch.equal(out, lam.action_min(*args, tables))


@pytest.mark.cuda
def test_solve_launches_the_kernel_once_per_backward_slice(cuda):
    """A DP solve at T time steps launches the action-min T - 2 times."""
    spec = dict(t_steps=6, s_steps=41, ds_steps=9, l_steps=11)
    T, S, L = spec["t_steps"], spec["s_steps"], spec["l_steps"]
    dist = np.full((T, S, L, 2), 10000.0, np.float32)
    rl = np.zeros((200, 8), np.float32)
    rl[:, 0] = np.arange(200) * 0.5
    rl[:, 4], rl[:, 5], rl[:, 6] = 14.0, 4.0, 4.0
    x0 = np.zeros(12, np.float32)
    x0[tllk.C_DS] = 5.0
    before, before_fused = lam.launches, lam.slice_launches
    tllk.make_latlon_solver(spec, cuda)[0](
        dist, rl, 0.5, tllk.LatLonParams().packed(), x0)
    torch.cuda.synchronize()
    # every one of them through the fused slice kernel
    assert lam.launches == before + T - 2
    assert lam.slice_launches == before_fused + T - 2


def _slice_scene(dev, S, DS, L, T, seed, params=None):
    """A seeded scene for whole backward slices (the scene of
    tests/test_torch_kernel_rehearsal.py slice_case) on ``dev``."""
    rng = np.random.default_rng(seed)
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=T, s_steps=S, ds_steps=DS, l_steps=L), dev)
    p = tllk.LatLonParams()
    for k, v in (params or {}).items():
        setattr(p, k, v)
    dist = np.full((T, S, L, 2), 10000.0, np.float32)
    dist[..., 0] = 10000.0 + (S - np.arange(S))[None, :, None]
    mid = L // 2
    for t in range(T):
        lead = min(S - 1, S // 6 + (S // 25 + 1) * t)
        dist[t, :lead, max(mid - 2, 0):mid + 3, 0] = (
            lead - np.arange(lead))[:, None]
        park = (3 * S) // 5
        dist[t, :park, 1:max(2, L // 4), 0] = np.minimum(
            dist[t, :park, 1:max(2, L // 4), 0],
            (park - np.arange(park))[:, None])
    dist[:, :, [0, L - 1], 0] = 0.0
    dist[..., 0] += rng.uniform(0, 0.5, (T, S, L)).astype(np.float32)
    n_ref = 2 * S + 40
    rl = np.zeros((n_ref, 8), np.float32)
    rl[:, 0] = np.arange(n_ref) * 0.5
    rl[:, 4] = 14.0 - 6.0 * (np.arange(n_ref) > n_ref // 2)
    rl[:, 5] = 4.0 - 1.5 * (np.arange(n_ref) % 50 > 30)
    rl[:, 6] = 4.0 - 2.0 * (np.arange(n_ref) % 70 > 50)
    return (solve, *solve.prepare(dist, rl, 0.5, p.packed()))


@pytest.mark.cuda
@pytest.mark.parametrize("S,DS,L,T,params", [
    (201, 37, 21, 4, None), (61, 9, 11, 6, None), (37, 5, 3, 5, None),
    (61, 9, 11, 5, dict(w_lat_dist=2.0, l_trg=1.5, t_st_min=2.5, s_st=20.0,
                        t_st_max=1.5, d_lat_comf=1.0))])
def test_fused_slice_kernel_matches_plain(cuda, S, DS, L, T, params):
    """``backward_slice`` on the card (one launch of the fused kernel)
    against ``backward_slice_reference`` on the card, every backward slice
    of a seeded scene, chained through the plain version: the same bits."""
    solve, dist_x, rl, step, pp = _slice_scene(cuda, S, DS, L, T, S + T,
                                               params)
    tables = solve.action_tables(pp)
    nxt = solve.final_slice(dist_x, rl, step, pp)
    for i in range(T - 2, 0, -1):
        before = lam.slice_launches
        got = solve.backward_slice(nxt, i, dist_x, rl, step, pp, tables)
        torch.cuda.synchronize()
        assert lam.slice_launches == before + 1
        want = solve.backward_slice_reference(nxt, i, dist_x, rl, step, pp,
                                              tables)
        np.testing.assert_allclose(got[..., 0].cpu(), want[..., 0].cpu(),
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_allclose(got[..., 1].cpu(), want[..., 1].cpu(),
                                   rtol=0, atol=CONSTR_ATOL)
        assert torch.equal(got, want), f"slice {i}"
        nxt = want


def _poison(a, channel):
    """NaN into every channel of ``a`` ("all") or its cost ("cost")."""
    if channel == "all":
        a[...] = float("nan")
    else:
        a[..., 0] = float("nan")


@pytest.mark.cuda
@pytest.mark.parametrize("channel", ["all", "cost"])
def test_action_min_and_fused_slice_nan_rule_match_plain(cuda, channel):
    """A next slice with a NaN row (every channel, or the cost alone): the
    action-min (37 x 5 x 3, row 18) and the fused slice (61 x 9 x 11, slice
    T - 2, row S // 2) on the card against their plain versions on the CPU,
    NaN equal to NaN (a NaN constraint: action 0 with its own cost and
    constraint; a NaN cost of the least constraint: the first one)."""
    rng = np.random.default_rng(37)
    S, DS, L = 37, 5, 3
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=4, s_steps=S, ds_steps=DS, l_steps=L), "cpu")
    pp = tllk.unpack_pp(torch.from_numpy(tllk.LatLonParams().packed()))
    tables = solve.action_tables(pp)
    args = _seeded(rng, "cpu", tables, S, DS, L)
    _poison(args[0][18], channel)
    want = lam.action_min_reference(*args, tables).numpy()
    assert np.isnan(want).any() or channel == "cost"
    solve_g, _ = tllk.make_latlon_solver(
        dict(t_steps=4, s_steps=S, ds_steps=DS, l_steps=L), cuda)
    pp_g = tllk.unpack_pp(torch.from_numpy(
        tllk.LatLonParams().packed()).to(cuda))
    got = lam.action_min(*[a.to(cuda) for a in args],
                         solve_g.action_tables(pp_g))
    np.testing.assert_array_equal(got.cpu().numpy(), want)

    S, DS, L, T = 61, 9, 11, 6
    i = T - 2
    scenes_ = [_slice_scene(dev, S, DS, L, T, S + T) for dev in ("cpu", cuda)]
    (solve, dist_x, rl, step, pp), (solve_g, dist_g, rl_g, step_g, pp_g) = \
        scenes_
    nxt = solve.final_slice(dist_x, rl, step, pp).clone()
    _poison(nxt[S // 2], channel)
    want = solve.backward_slice_reference(nxt, i, dist_x, rl, step, pp,
                                          solve.action_tables(pp)).numpy()
    before = lam.slice_launches
    got = solve_g.backward_slice(nxt.to(cuda), i, dist_g, rl_g, step_g, pp_g,
                                 solve_g.action_tables(pp_g))
    torch.cuda.synchronize()
    assert lam.slice_launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert np.isnan(want).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,DS,L,T", [(1, 61, 9, 11, 5), (3, 61, 9, 11, 5),
                                       (8, 201, 37, 21, 4),
                                       (2, 61, 9, 11, 5), (33, 61, 9, 11, 4)])
def test_latlon_backward_slice_batch_matches_single(cuda, B, S, DS, L, T):
    """The fused slice for a scenario batch (one launch: the resident
    blocks walking the work items; ``scenes.dp_batch_scenes``: per-scenario
    scenes, tables and ``l_trg``, one scenario with NaN distance cells)
    against each scenario's one-scenario launch and the plain version on
    the CPU, every backward slice chained through the plain version: the
    same bits, NaN equal to NaN.  A batch solve launches it T - 2 times for
    any B.  B = 8 at the demo grid and B = 33 have more items than the
    resident blocks; 33 x 27 items do not divide by them."""
    from tpl_tpu_torch import scenes

    dist, rl, pp, x0 = scenes.dp_batch_scenes(B, T, S, L, seed=S + B)
    spec = dict(t_steps=T, s_steps=S, ds_steps=DS, l_steps=L)
    solves = {d: tllk.make_latlon_solver(spec, d)[0] for d in ("cpu", cuda)}
    ins = {d: solves[d].batch_inputs(dist, rl, 0.5, pp) for d in solves}
    tables = {d: lam.BatchTables([solves[d].action_tables(p)
                                  for p in ins[d][3]]) for d in solves}
    solve, (dist_x, rls, step, pps) = solves["cpu"], ins["cpu"]
    dist_g, rls_g, step_g, pps_g = ins[cuda]
    lib = lam._kernel()
    items = -(-S // lib.latlon_action_min_tile_rows(L)) * DS * B
    blocks = lib.latlon_backward_slice_grid(S, DS, L, B)
    assert 1 <= blocks <= items
    if B in (8, 33):    # more items than resident blocks, not a multiple
        assert items > blocks and items % blocks
    nxt = torch.stack([solve.final_slice(dist_x[b], rls[b], step, pps[b])
                       for b in range(B)])
    for i in range(T - 2, 0, -1):
        want = solve.backward_slice_batch_reference(nxt, i, dist_x, rls, step,
                                                    pps, tables["cpu"])
        before = lam.launches, lam.slice_launches, lam.batch_launches
        got = solves[cuda].backward_slice_batch(nxt.to(cuda), i, dist_g,
                                                rls_g, step_g, pps_g,
                                                tables[cuda])
        torch.cuda.synchronize()
        assert (lam.launches, lam.slice_launches, lam.batch_launches) == (
            before[0] + 1, before[1] + (B == 1), before[2] + (B > 1))
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=f"slice {i}")
        for b in range(B):
            single = lam.backward_slice_launch(
                nxt[b:b + 1].to(cuda), dist_g[b:b + 1, i], rls_g[b:b + 1],
                step_g, i, tables[cuda].tables[b])[0]
            np.testing.assert_array_equal(single.cpu().numpy(),
                                          got[b].cpu().numpy(),
                                          err_msg=f"slice {i} scenario {b}")
        nxt = want
    before = lam.launches, lam.slice_launches, lam.batch_launches
    nodes, trajs = solves[cuda].batch(dist, rl, 0.5, pp, x0)
    torch.cuda.synchronize()
    assert (lam.launches, lam.slice_launches, lam.batch_launches) == (
        before[0] + T - 2, before[1] + (T - 2) * (B == 1),
        before[2] + (T - 2) * (B > 1))
    assert nodes.shape == (B, T, S, DS, L, 4) and trajs.shape == (B, T, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,DS,L,T", [(3, 61, 9, 11, 4),
                                       (8, 201, 37, 21, 4)])
def test_latlon_backward_slice_profile_matches_plain_entry(cuda, B, S, DS,
                                                           L, T):
    """The batched slice's profiling instantiation
    (``backward_slice_profile``) on every backward slice of a seeded batch:
    bit-equal to the plain entry (NaN equal to NaN), no launch counted,
    thread 0's cycles in every phase."""
    from tpl_tpu_torch import scenes

    dist, rl, pp, _ = scenes.dp_batch_scenes(B, T, S, L, seed=S + B)
    solve, _ = tllk.make_latlon_solver(
        dict(t_steps=T, s_steps=S, ds_steps=DS, l_steps=L), cuda)
    dist_x, rls, step, pps = solve.batch_inputs(dist, rl, 0.5, pp)
    tables = lam.BatchTables([solve.action_tables(p) for p in pps])
    nxt = torch.stack([solve.final_slice(dist_x[b], rls[b], step, pps[b])
                       for b in range(B)])
    for i in range(T - 2, 0, -1):
        got = lam.backward_slice_launch(nxt, dist_x[:, i], rls, step, i,
                                        tables)
        before = lam.launches, lam.slice_launches, lam.batch_launches
        prof_out, cycles = lam.backward_slice_profile(nxt, dist_x[:, i], rls,
                                                      step, i, tables)
        torch.cuda.synchronize()
        assert (lam.launches, lam.slice_launches,
                lam.batch_launches) == before
        assert torch.equal(torch.isnan(prof_out), torch.isnan(got))
        assert torch.equal(prof_out.nan_to_num(), got.nan_to_num()), i
        assert cycles.shape == (len(lam.SLICE_PHASES),)
        assert bool((cycles > 0).all()), cycles
        nxt = got


@pytest.mark.cuda
def test_solve_on_card_matches_cpu(cuda):
    """The whole solve on the card (kernel) against the CPU (plain)."""
    T, S, L = DEMO["t_steps"], DEMO["s_steps"], DEMO["l_steps"]
    dist = np.full((T, S, L, 2), 10000.0, np.float32)
    for t in range(T):
        lead = 40 + 6 * t
        dist[t, :lead, 7:14, 0] = lead - np.arange(lead)[:, None]
    dist[:, :, [0, L - 1], 0] = 0.0
    rl = np.zeros((500, 8), np.float32)
    rl[:, 0] = np.arange(500) * 0.5
    rl[:, 4], rl[:, 5], rl[:, 6] = 14.0, 4.0, 4.0
    p = tllk.LatLonParams()
    x0 = np.zeros(12, np.float32)
    x0[tllk.C_DS] = 9.0
    n_g, tr_g = tllk.make_latlon_solver(DEMO, cuda)[0](
        dist, rl, 0.5, p.packed(), x0)
    n_c, tr_c = tllk.make_latlon_solver(DEMO, "cpu")[0](
        dist, rl, 0.5, p.packed(), x0)
    np.testing.assert_allclose(n_g[..., 0].cpu(), n_c[..., 0],
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(tr_g.cpu(), tr_c, rtol=COST_RTOL,
                               atol=TRAJ_ATOL)


# ---------------------------------------------------------------------
# the iLQR tracking-MPC kernel

MPC_H = 60


def mpc_params(rng=None):
    """The ``__graft_entry__._mpc_setup`` reference course and weights
    (with a seeded perturbation of the course when ``rng`` is given)."""
    ss = np.arange(128) * 0.5
    ref_y = 2.0 * np.sin(ss * 0.1)
    if rng is not None:
        ref_y = ref_y + np.cumsum(rng.normal(0.0, 0.02, 128))
    phi = np.arctan(np.gradient(ref_y, ss))
    return {"pd": 10.0, "pv": 5.0, "pdelta": 0.0, "min_pdelta_dot": 0.1,
            "pdelta_dot": 0.0, "min_p_phi_dot": 0.0, "p_phi_dot": 0.0,
            "p_phi": 0.01, "p_phi_ref_dot_diff": 0.01, "pa": 2.0,
            "pj": 0.5, "l": 3.165, "v_ch": 32.0, "ref_x": ss, "ref_y": ref_y,
            "ref_phi": phi, "ref_k": np.gradient(phi, ss),
            "ref_v": np.full(128, 8.0), "ref_step": 0.5, "max_delta": 0.7,
            "max_acc": 3.0, "min_acc": -3.0, "a_offset": 0.0}


def mpc_inputs(x0, u=None, lam_=None, lg_limit=1e30):
    H = MPC_H
    x = np.zeros((H + 1, 7))
    x[0] = x0
    return dict(
        x=x, u=np.zeros((H, 2)) if u is None else u,
        lam=np.zeros((H, 4)) if lam_ is None else lam_,
        u_lims=np.tile(np.array([[[-3.0, 1.5], [-1.0, 1.0]]]), (H, 1, 1)),
        bw_lim=np.stack([np.full(4, 1e4), np.full(4, lg_limit)], -1),
        cfg_f=np.array([0.05, 1e-6]))


def _close_solves(got, want):
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["lam"], want["lam"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["traj_costs"], want["traj_costs"],
                               rtol=1e-9)
    assert got["mu_step"] == want["mu_step"]
    assert got["iterations"] == want["iterations"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["setup8", "setup20", "warm", "lg2_T45"])
def test_ilqr_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(len(case))
    x0 = [0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0]
    T, it, lg, mu = MPC_H, 20, 1, 0
    u = lam_ = None
    params = mpc_params()
    if case == "setup8":
        it = 8
    elif case == "warm":
        params = mpc_params(rng)
        x0 = [0.3, 1.4, 0.1, 0.05, 7.0, 0.2, 0.5]
        u = rng.normal(0.0, 0.3, (MPC_H, 2))
        mu = 2
    elif case == "lg2_T45":
        x0 = [0.3, -1.5, -0.1, 0.65, 9.0, 0.0, 2.9]
        u = rng.normal(0.0, 0.3, (MPC_H, 2))
        lam_ = rng.uniform(0.0, 1e-3, (MPC_H, 4))
        T, lg, mu = 45, 2, 1
    host = itm.pack_inputs(mpc_inputs(x0, u, lam_), params)
    buf = torch.from_numpy(host).to(cuda)
    before = itm.launches
    out = itm.update(buf, MPC_H, 128, T, it, lg, mu, ilqr.HEUN)
    torch.cuda.synchronize()
    assert itm.launches == before + 1
    ref = itm.update_reference(buf, MPC_H, 128, T, it, lg, mu, ilqr.HEUN)
    got = itm.unpack_outputs(out.cpu().numpy(), MPC_H)
    want = itm.unpack_outputs(ref.cpu().numpy(), MPC_H)
    _close_solves(got, want)
    assert np.all(np.isfinite(got["x"]))


@pytest.mark.cuda
def test_cuda_solver_launches_kernel_once_per_update(cuda):
    """The tracking-MPC Solver on the card: one kernel launch per update,
    the same result as the same Solver on the CPU, warm start included."""
    sides = []
    for dev in (cuda, torch.device("cpu")):
        prob, spec = problems.trajectory_tracking_mpc(ref_capacity=128)
        s = solver.Solver(prob, spec, horizon_max=MPC_H,
                          dtype=torch.float64, device=dev)
        s.integrator_type = s.HEUN
        s.horizon = MPC_H
        s.max_iterations = 20
        s.barrier_weight[:] = 1e4
        s.lg_mult_limit = 0.0
        s.u_min[:] = [-3.0, -1.0]
        s.u_max[:] = [1.5, 1.0]
        for k, v in mpc_params().items():
            setattr(s.params, k, v)
        s.x[0] = [0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0]
        sides.append(s)
    for tick in range(3):
        before = itm.launches
        sides[0].update()
        assert itm.launches == before + 1
        sides[1].update()
        assert itm.launches == before + 1        # the CPU side: plain
        np.testing.assert_allclose(sides[0].x, sides[1].x, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(sides[0].u, sides[1].u, rtol=0,
                                   atol=1e-6)
        assert sides[0]._mu_step == sides[1]._mu_step
        for s in sides:
            s.shift(1)
            s.x[0] = s.x[0] + np.array([0.0, 0.01, 0.0, 0.0, 0.02, 0.0, 0.0])


# ---------------------------------------------------------------------
# the time-indexed tracking-MPC kernel


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MPC_TIME_KINDS)
def test_mpc_time_kernel_matches_plain(cuda, kind):
    """The seeded cases of the CPU rehearsal against the plain float64
    update on the card: x, u, lam to 1e-9 (atol and rtol), mu_step and the
    iteration count equal, one launch."""
    host, args = mpc_time_case(kind)
    H = args[0]
    buf = torch.from_numpy(host).to(cuda)
    before = itt.launches
    out = itt.update(buf, *args)
    torch.cuda.synchronize()
    assert itt.launches == before + 1
    ref = itt.update_reference(buf, *args)
    got = itt.unpack_outputs(out.cpu().numpy(), H)
    want = itt.unpack_outputs(ref.cpu().numpy(), H)
    for k in ("x", "u", "lam"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["traj_costs"], want["traj_costs"],
                               rtol=1e-9)
    assert got["mu_step"] == want["mu_step"]
    assert got["iterations"] == want["iterations"]


@pytest.mark.cuda
def test_mpc_time_solver_launches_kernel_once_per_update(cuda, monkeypatch):
    """The time-MPC Solver on the card launches the kernel once per update
    and never the plain version; the same Solver on the CPU takes the plain
    version and gives the same result, warm start included."""
    host, args = mpc_time_case("curved")
    H, n_ref, T = args[:3]
    v = ilqr.unpack(host, ilqr.layout(itt.input_layout(H, n_ref))[0])
    sides = []
    for dev in (cuda, torch.device("cpu")):
        prob, spec = problems.trajectory_tracking_mpc_time(ref_capacity=n_ref)
        s = solver.Solver(prob, spec, horizon_max=H, dtype=torch.float64,
                          device=dev)
        s.integrator_type = s.HEUN
        s.horizon = T
        s.max_iterations = 20
        s.barrier_weight[:] = 1e4
        s.lg_mult_limit = 0.0
        s.u_min[:] = [-3.0, -1.0]
        s.u_max[:] = [1.5, 1.0]
        for i, name in enumerate(itt.SCALARS):
            setattr(s.params, name, v["scalars"][i])
        for i, name in enumerate(itt.TABLES):
            setattr(s.params, name, v["tables"][i])
        s.x[0] = v["x"][0]
        sides.append(s)
    plain = itt.update_reference
    for tick in range(3):
        before = itt.launches

        def no_plain(*a, **kw):
            raise AssertionError("the CUDA solve took the plain version")

        monkeypatch.setattr(itt, "update_reference", no_plain)
        sides[0].update()
        monkeypatch.setattr(itt, "update_reference", plain)
        assert itt.launches == before + 1
        sides[1].update()
        assert itt.launches == before + 1        # the CPU side: plain
        for a, b in ((sides[0].x, sides[1].x), (sides[0].u, sides[1].u)):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
        assert sides[0]._mu_step == sides[1]._mu_step
        assert sides[0].iterations == sides[1].iterations
        for s in sides:
            s.shift(1)
            s.x[0] = s.x[0] + np.array([0.0, 0.01, 0.0, 0.0, 0.02, 0.0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MPC_TIME_KINDS)
def test_mpc_time_profile_is_bit_equal_and_covers_the_solve(cuda, kind):
    """The profiling instantiation returns the plain instantiation's bits,
    and its phases' cycles, at the SM clock read under load, sum to within
    5 % of the launch's time by CUDA events: no stretch of the solve falls
    outside a phase."""
    host, args = mpc_time_case(kind)
    buf = torch.from_numpy(host).to(cuda)
    got = itt.update(buf, *args)
    prof, cycles = itt.profile(buf, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, prof)
    assert set(cycles) == set(ilqr.PHASES) and min(cycles.values()) > 0
    cyc = torch.zeros(len(ilqr.PHASES), dtype=torch.int64, device=cuda)
    for _ in range(200):                 # keep the card busy for the read
        itt.launch(buf, *args, cycles=cyc)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", f"--id={cuda.index or 0}"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    n = 20
    for _ in range(5):                   # the queue runs ahead of the card
        itt.launch(buf, *args, cycles=cyc)
    ev[0].record()
    for _ in range(n):
        itt.launch(buf, *args, cycles=cyc)
    ev[1].record()
    torch.cuda.synchronize()
    launch_us = ev[0].elapsed_time(ev[1]) * 1e3 / n
    # the cycles of the last of those launches, at the clock read under load
    phases_us = float(cyc.sum()) / mhz
    assert abs(phases_us - launch_us) <= 0.05 * launch_us, \
        (phases_us, launch_us, mhz)


@pytest.mark.cuda
def test_mpc_time_launch_failures_raise(cuda):
    """A CPU tensor never reaches the launcher; a horizon whose shared
    memory does not fit raises before the launch."""
    host, args = mpc_time_case("curved")
    with pytest.raises(ValueError, match="unsupported device"):
        itt.launch(torch.from_numpy(host), *args)
    H, n_ref = 400, 128
    n = ilqr.layout(itt.input_layout(H, n_ref))[1]
    buf = torch.zeros(n, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        itt.update(buf, H, n_ref, H, 1, 1, 0, ilqr.HEUN)


# ---------------------------------------------------------------------
# the batched tracking-MPC kernel: a warp per scenario, persistent

def mpc_batch(B, dtype, dev, T=MPC_H, iterations=8, warm=True):
    """A seeded batch in the batched update's layout on ``dev``: starts
    near the course (the bench's 0.01 * b on every state would put scenario
    157 beside a pole of tan(delta), where a rollout amplifies a rounding
    without bound: here b wraps at 8) and a seeded offset, warm controls,
    multipliers and mu_steps on all but scenario 0."""
    rng = np.random.default_rng(B + T)
    H = MPC_H
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    x0 = (np.array([0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0])[:, None]
          + 0.01 * (np.arange(B) % 8)[None, :]
          + rng.normal(0.0, 0.3, (7, B))
          * np.array([1, 1, 0.2, 0.1, 3, 0, 0.5])[:, None])
    u, lam_ = np.zeros((H, 2, B)), np.zeros((H, 4, B))
    mu = np.zeros(B, np.int32)
    if warm:
        u[..., 1:] = rng.normal(0.0, 0.3, (H, 2, B - 1))
        lam_[..., 1:] = rng.uniform(0.0, 1e-3, (H, 4, B - 1))
        mu[1:] = rng.integers(0, 4, B - 1)
    x = np.zeros((H + 1, 7, B))
    x[0] = x0
    params = {k: t(v) for k, v in mpc_params().items()}
    cfg = dict(u_min=t(np.tile([-3.0, -1.0], (H, 1))),
               u_max=t(np.tile([1.5, 1.0], (H, 1))),
               barrier_weight=t(np.full(4, 1e4)),
               lg_mult_limit=t(np.full(4, 1e30)), dt=t(0.05),
               min_rel_cost_change=t(1e-6), T=T, max_iterations=iterations,
               max_lg_iterations=1)
    state = (t(x), t(u), t(lam_), torch.from_numpy(mu).to(dev), t(x0))
    return state, params, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,warm", [(5, MPC_H, True), (140, 45, True),
                                      (3, MPC_H, False)])
def test_batched_kernel_float64_matches_plain_and_single_launches(cuda, B, T,
                                                                  warm):
    state, params, cfg = mpc_batch(B, torch.float64, cuda, T=T, warm=warm)
    prob = problems.trajectory_tracking_mpc(128)[0]
    upd = batched.make_batched_update_fn(prob, MPC_H, B, ilqr.HEUN,
                                         torch.float64)
    before, single_before = itm.launches_batched, itm.launches
    got = upd(*state, params, cfg, iterations=True)
    torch.cuda.synchronize()
    assert itm.launches_batched == before + 1       # one launch per update
    assert itm.launches == single_before
    want = upd.reference(*state, params, cfg, iterations=True)
    assert itm.launches_batched == before + 1       # the plain version
    for name, g, w in zip(("x", "u", "lam"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[4].cpu().numpy(), want[4].cpu().numpy(),
                               rtol=1e-9)
    assert torch.equal(got[3], want[3]) and torch.equal(got[5], want[5])
    assert got[3].dtype == torch.int32 and got[0].shape == (MPC_H + 1, 7, B)
    # every scenario returns the bits of a single launch on its row
    x, u, lam_, mu, x0 = state
    shared, rows = itm.pack_inputs_batched(x, u, lam_, x0, params, cfg,
                                           torch.float64)
    out = itm.launch_batched(shared, rows, mu.to(torch.int32), MPC_H, 128, T,
                             8, 1, ilqr.HEUN)
    single = itm.rows_of_batch(shared, rows, MPC_H, 128)
    for b in sorted({0, 1, B // 2, B - 1}):
        one = itm.update(single[b].contiguous(), MPC_H, 128, T, 8, 1,
                         int(mu[b]), ilqr.HEUN)
        assert torch.equal(out[b], one), f"scenario {b}"
    assert torch.equal(itm.unpack_outputs_batched(out, MPC_H)[0], got[0])


@pytest.mark.cuda
def test_batched_kernel_float32_matches_plain(cuda):
    B = 64
    state, params, cfg = mpc_batch(B, torch.float32, cuda, warm=False)
    prob = problems.trajectory_tracking_mpc(128)[0]
    upd = batched.make_batched_update_fn(prob, MPC_H, B, ilqr.HEUN,
                                         torch.float32)
    before = itm.launches_batched
    got = upd(*state, params, cfg, iterations=True)
    torch.cuda.synchronize()
    assert itm.launches_batched == before + 1
    assert got[0].dtype == torch.float32
    want = upd.reference(*state, params, cfg, iterations=True)
    ok = (got[3] == want[3]) & (got[5] == want[5])
    ok &= (got[4] - want[4]).abs() <= RSTP_COST_RTOL * want[4].abs()
    for g, w in zip(got[:3], want[:3]):
        ok &= torch.isclose(g, w, rtol=0, atol=RSTP_X_ATOL).all(0).all(0)
    assert float(ok.float().mean()) >= 0.9, ok
    assert all(bool(torch.isfinite(g).all()) for g in got[:3])


@pytest.mark.cuda
def test_batched_update_on_cuda_raises_for_other_problems(cuda):
    """A CUDA tensor launches the kernel or raises: no plain version in
    silence."""
    prob = problems.lateral_profile(128)[0]
    upd = batched.make_batched_update_fn(prob, 20, 2, ilqr.EULER,
                                         torch.float32)
    x, u, lam_, mu = batched.init_batch(prob, 20, 2, torch.float32, cuda)
    cfg = dict(T=20, max_iterations=2, max_lg_iterations=1)
    with pytest.raises(NotImplementedError, match="no batched kernel"):
        upd(x, u, lam_, mu, x[0], {}, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        itm.launch_batched(torch.zeros(4), torch.zeros((2, 4)), mu.cpu(), 20,
                           128, 20, 2)


def _single_launches(shared, rows, mu, T, indices):
    """Single launches on the batch's rows ``indices``: {b: result}."""
    single = itm.rows_of_batch(shared, rows, MPC_H, 128)
    return {b: itm.update(single[b].contiguous(), MPC_H, 128, T, 8, 1,
                          int(mu[b]), ilqr.HEUN) for b in indices}


@pytest.mark.cuda
def test_batched_kernel_every_scenario_equals_a_single_launch(cuda):
    """A seeded B=300 batch (warm starts, mixed iteration counts): every
    scenario's result has the bits of a single launch on its row."""
    B = 300
    state, params, cfg = mpc_batch(B, torch.float64, cuda)
    x, u, lam_, mu, x0 = state
    shared, rows = itm.pack_inputs_batched(x, u, lam_, x0, params, cfg,
                                           torch.float64)
    mu = mu.to(torch.int32)
    out = itm.launch_batched(shared, rows, mu, MPC_H, 128, MPC_H, 8)
    its = itm.unpack_outputs_batched(out, MPC_H)[5]
    assert len(set(its.tolist())) > 2
    for b, one in _single_launches(shared, rows, mu, MPC_H,
                                   range(B)).items():
        assert torch.equal(out[b], one), f"scenario {b}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_team_geometry_matches_a_warp_a_scenario(cuda, dtype):
    """The largest batch of the team geometry (a block a scenario) and the
    same rows with one scenario more (a warp a scenario): every scenario of
    the first has the second's bits; in float64 also those of single
    launches (every 16th and the last)."""
    team = itm.team_scenarios(MPC_H, 128, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert team >= 1
    B = sms * team
    state, params, cfg = mpc_batch(B + 1, dtype, cuda)
    x, u, lam_, mu, x0 = state
    shared, rows = itm.pack_inputs_batched(x, u, lam_, x0, params, cfg, dtype)
    mu = mu.to(torch.int32)
    warp = itm.launch_batched(shared, rows, mu, MPC_H, 128, MPC_H, 8)
    out = itm.launch_batched(shared, rows[:B].contiguous(), mu[:B], MPC_H,
                             128, MPC_H, 8)
    assert torch.equal(out, warp[:B])
    its = itm.unpack_outputs_batched(out, MPC_H)[5]
    assert len(set(its.tolist())) > 2
    if dtype == torch.float64:
        picks = sorted(set(range(0, B, 16)) | {B - 1})
        for b, one in _single_launches(shared, rows, mu, MPC_H,
                                       picks).items():
            assert torch.equal(out[b], one), f"scenario {b}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_kernel_above_the_resident_scenarios(cuda, dtype):
    """More scenarios than the card holds at once: each warp takes several
    in turn.  In float64 every 64th scenario and the last bit-equal to
    single launches, and against the plain batched update mu_step and the
    iteration counts equal on every scenario, x, u, lam within the tolerance
    above on 99 % of them (chip_smoke.py's BATCH_MIN_SHARE: over a thousand
    seeded warm starts a few carry their rounding differences to 2e-5); in
    float32, on cold starts as test_batched_kernel_float32_matches_plain
    (on warm starts float32 rounding decides mu_step and the stopping
    iteration of more scenarios than this share allows: chip_smoke.py
    prints, on its seeded warm starts, how often the kernel parts from plain
    float32 beside how often plain float32 parts from float64, and holds the
    float32 kernel to its parent's bits there), the tolerance above on 90 %
    of them."""
    per_sm, slots = itm.resident_scenarios(MPC_H, 128, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert slots >= 1 and per_sm >= slots
    B = sms * per_sm + 37
    state, params, cfg = mpc_batch(B, dtype, cuda,
                                   warm=dtype == torch.float64)
    upd = batched.make_batched_update_fn(
        problems.trajectory_tracking_mpc(128)[0], MPC_H, B, ilqr.HEUN, dtype)
    got = upd(*state, params, cfg, iterations=True)
    want = upd.reference(*state, params, cfg, iterations=True)
    if dtype == torch.float64:
        ok = torch.ones(B, dtype=torch.bool, device=cuda)
        for g, w in zip(got[:3], want[:3]):
            ok &= torch.isclose(g, w, rtol=0, atol=1e-6).all(0).all(0)
        assert float(ok.float().mean()) >= 0.99
        assert torch.equal(got[3], want[3]) and torch.equal(got[5], want[5])
        x, u, lam_, mu, x0 = state
        shared, rows = itm.pack_inputs_batched(x, u, lam_, x0, params, cfg,
                                               dtype)
        mu = mu.to(torch.int32)
        out = itm.launch_batched(shared, rows, mu, MPC_H, 128, MPC_H, 8)
        picks = sorted(set(range(0, B, 64)) | {B - 1})
        for b, one in _single_launches(shared, rows, mu, MPC_H,
                                       picks).items():
            assert torch.equal(out[b], one), f"scenario {b}"
    else:
        ok = (got[3] == want[3]) & (got[5] == want[5])
        ok &= (got[4] - want[4]).abs() <= RSTP_COST_RTOL * want[4].abs()
        for g, w in zip(got[:3], want[:3]):
            ok &= torch.isclose(g, w, rtol=0, atol=RSTP_X_ATOL).all(0).all(0)
        assert float(ok.float().mean()) >= 0.9
    assert all(bool(torch.isfinite(g).all()) for g in got[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["team", "warp"])
def test_batched_profiling_instantiation_is_bit_equal(cuda, geometry):
    """The batch's profiling instantiation returns the normal one's bits,
    a cycle count for each phase scenario 0 ran and the line searches by
    candidates rolled, one a scenario and iteration; in the team geometry
    (B=64) and a warp a scenario (one scenario more than the team geometry
    takes).  The team keeps dense derivative blocks: no expansion."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = (64 if geometry == "team"
         else sms * itm.team_scenarios(MPC_H, 128, torch.float64) + 1)
    state, params, cfg = mpc_batch(B, torch.float64, cuda)
    x, u, lam_, mu, x0 = state
    shared, rows = itm.pack_inputs_batched(x, u, lam_, x0, params, cfg,
                                           torch.float64)
    mu = mu.to(torch.int32)
    out = itm.launch_batched(shared, rows, mu, MPC_H, 128, MPC_H, 8)
    prof, phases, hist = itm.profile_batched(shared, rows, mu, MPC_H, 128,
                                             MPC_H, 8)
    assert torch.equal(out, prof)
    assert set(phases) == set(itm.batch_phases(torch.float64))
    for k in ("load", "init_rollout", "derivatives", "expansion", "riccati",
              "candidates_0_1", "pick_copy", "store"):
        if geometry == "team" and k == "expansion":
            assert phases[k] == 0
        else:
            assert phases[k] > 0, k
    its = itm.unpack_outputs_batched(out, MPC_H)[5]
    assert sum(hist) == int(its.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["rows_width", "shared_length",
                                   "shared_dtype", "mu_dtype", "mu_length",
                                   "rows_strided", "table_per_scenario"])
def test_batched_layout_checks_raise(cuda, fault):
    """The split layout's shape checks: a launch the kernel cannot take
    raises before it is made."""
    B = 4
    state, params, cfg = mpc_batch(B, torch.float64, cuda)
    x, u, lam_, mu, x0 = state
    shared, rows = itm.pack_inputs_batched(x, u, lam_, x0, params, cfg,
                                           torch.float64)
    mu = mu.to(torch.int32)
    before = itm.launches_batched
    with pytest.raises(ValueError):
        if fault == "table_per_scenario":
            itm.pack_inputs_batched(
                x, u, lam_, x0,
                dict(params, ref_x=params["ref_x"].expand(B, -1)), cfg,
                torch.float64)
        else:
            if fault == "rows_width":
                rows = rows[:, :-1].contiguous()
            elif fault == "shared_length":
                shared = shared[:-1]
            elif fault == "shared_dtype":
                shared = shared.float()
            elif fault == "mu_dtype":
                mu = mu.long()
            elif fault == "mu_length":
                mu = mu[:-1]
            else:
                rows = torch.cat([rows, rows], 1)[:, ::2]
            itm.launch_batched(shared, rows, mu, MPC_H, 128, MPC_H, 8)
    assert itm.launches_batched == before


# ---------------------------------------------------------------------
# the float32 RSTP iLQR kernel and the rampify scan

RSTP_N_REF = 512
# kernel against plain, both float32: each stops at a relative cost change
# of 1e-6, which near convergence is a few float32 roundings of the cost, so
# a line-search acceptance, mu_step and the iteration at which a solve stops
# are decided by rounding; along the weakly determined directions of a
# converged profile the two then part by a few 1e-3 (m, m/s, s)
RSTP_X_ATOL = 2e-2
RSTP_COST_RTOL = 1e-5


def rstp_solver(name, H, T, dev, rng, warm):
    """A float32 Solver of an RSTP problem on ``dev``: the lateral / velocity
    profile configurations of tests/test_torch_ilqr.py at n_ref = 512, with
    a seeded start (and warm start)."""
    n = RSTP_N_REF
    prob, spec = getattr(problems, name)(ref_capacity=n)
    s = solver.Solver(prob, spec, horizon_max=H, dtype=torch.float32,
                      device=dev)
    s.horizon = T
    s.step = 0.5
    s.barrier_weight[:] = 1000.0
    s.u_min[:] = -2.5
    s.u_max[:] = 2.5
    s.params.ref_step = 0.5
    s.max_lg_iterations = 1
    if name == "lateral_profile":
        s.max_iterations = 5
        s.lg_mult_limit = 0.0
        s.params.k_ref = (0.01 * np.sin(np.arange(n) * 0.1)
                          + rng.normal(0.0, 0.002, n))
        s.params.d_offset = np.zeros(n)
        lower = np.full(n, -2.0)
        lower[40:60] = 1.0
        s.params.d_lower_constr = lower
        s.params.d_upper_constr = np.full(n, 2.0)
        s.params.w_d, s.params.w_v_d = 0.01, 1.0
        s.params.w_a_d, s.params.w_k = 200.0, 1.0
        s.x[0] = [rng.normal(0.0, 0.5), 0.0]
    else:
        s.max_iterations = 20
        s.lg_mult_limit = 0.1
        v_ref = np.full(n, 10.0)
        v_ref[60:] = 3.0
        s.params.ref_v = v_ref
        s.params.ref_k = 0.02 * np.sin(np.arange(n) * 0.05)
        t_min = np.zeros(n)
        t_min[80] = 12.0
        s.params.ref_t_min = t_min
        s.params.ref_t_max = np.full(n, 1e10)
        s.params.ref_t_offset = np.ones(n)
        s.params.ref_v_weight = np.ones(n)
        s.params.p_a = 2.0
        s.x[0] = [rng.uniform(0.5, 9.0), 0.0]
    if warm:
        nc = ilqr_rstp.PROBLEMS[name]["nc"]
        s.u = rng.normal(0.0, 0.3, T)
        s.lagrange_multiplier = (rng.uniform(0.0, 0.05, (T, nc))
                                 * (rng.uniform(size=(T, nc)) < 0.3))
        s._mu_step = int(rng.integers(0, 4))
    return s


def _close_rstp(got, want, max_iterations):
    for k in ("x", "u", "lam"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RSTP_X_ATOL)
    np.testing.assert_allclose(got["traj_costs"], want["traj_costs"],
                               rtol=RSTP_COST_RTOL)
    assert 1 <= got["iterations"] <= max_iterations
    assert np.all(np.isfinite(got["x"]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lateral_profile",
                                  "velocity_profile_space"])
@pytest.mark.parametrize("H,T,warm", [(250, 250, False), (250, 200, True),
                                      (60, 45, True)])
def test_rstp_kernel_matches_plain(cuda, name, H, T, warm):
    rng = np.random.default_rng(H + T + warm)
    s = rstp_solver(name, H, T, "cpu", rng, warm)
    host = ilqr_rstp.pack_inputs(name, s._inputs(), s.params._values,
                                 s._mu_step)
    buf = torch.from_numpy(host).to(cuda)
    run = (H, RSTP_N_REF, T, s.max_iterations, 1)
    before = ilqr_rstp.launches
    out = ilqr_rstp.update(name, buf, *run)
    torch.cuda.synchronize()
    assert ilqr_rstp.launches == before + 1
    ref = ilqr_rstp.update_reference(name, buf, *run)
    _close_rstp(ilqr_rstp.unpack_outputs(name, out.cpu().numpy(), H),
                ilqr_rstp.unpack_outputs(name, ref.cpu().numpy(), H),
                s.max_iterations)


@pytest.mark.cuda
def test_rstp_solver_launches_kernel_once_per_update(cuda):
    """A float32 velocity-profile Solver on the card: one ilqr_rstp launch
    per update, the result of the same Solver on the CPU (plain)."""
    sides = [rstp_solver("velocity_profile_space", 250, 250, dev,
                         np.random.default_rng(3), False)
             for dev in (cuda, torch.device("cpu"))]
    for tick in range(3):
        before = ilqr_rstp.launches
        sides[0].update()
        assert ilqr_rstp.launches == before + 1
        sides[1].update()
        assert ilqr_rstp.launches == before + 1       # the CPU side: plain
        np.testing.assert_allclose(sides[0].x, sides[1].x, rtol=0,
                                   atol=RSTP_X_ATOL)
        np.testing.assert_allclose(sides[0].traj_costs, sides[1].traj_costs,
                                   rtol=RSTP_COST_RTOL)
        for s in sides:
            s.shift(1)


@pytest.mark.cuda
@pytest.mark.parametrize("H,T", [(250, 250), (250, 180), (64, 64), (2, 1)])
def test_rampify_kernel_matches_plain_bit_for_bit(cuda, H, T):
    args = rampify_args(cuda, H, T, H + T)
    before = rstp_rampify.launches
    got = rstp_rampify.scan(*args)
    torch.cuda.synchronize()
    assert rstp_rampify.launches == before + 1
    want = rstp_rampify.scan_reference(*args)
    assert got.shape == (H, 2)
    # the same float32 operations in the same order, no FMA contraction
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("H,T", [(250, 250), (250, 180), (2, 1)])
def test_rampify_profiling_instantiation_is_bit_equal(cuda, H, T):
    """The scan's profiling instantiation returns the normal one's bits and
    a cycle count for every phase; each call is one launch."""
    args = rampify_args(cuda, H, T, H + T)
    before = rstp_rampify.launches
    out = rstp_rampify.scan(*args)
    prof, cycles = rstp_rampify.profile(*args)
    torch.cuda.synchronize()
    assert rstp_rampify.launches == before + 2
    assert torch.equal(out, prof)
    assert tuple(cycles) == rstp_rampify.PHASES
    assert all(v > 0 for v in cycles.values())
    if H == 250:
        assert cycles["backward"] > cycles["stage"]


@pytest.mark.cuda
def test_rampify_reads_scalars_where_they_lie(cuda):
    """The scalars as slices of one vector (as the fused step passes them)
    and a NaN limit: the plain version's values, NaN for NaN."""
    args = list(rampify_args(cuda, 64, 50, 7))
    vec = torch.stack([a.reshape(()) for a in args[4:]])
    args[4:] = [vec[i] for i in range(6)]
    assert torch.equal(rstp_rampify.scan(*args),
                       rstp_rampify.scan_reference(*args))
    args[2] = args[2].clone()
    args[2][20] = float("nan")
    got = rstp_rampify.scan(*args).cpu().numpy()
    want = rstp_rampify.scan_reference(*args).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any()


# ---------------------------------------------------------------------
# the profiling instantiations and the latency probe

@pytest.mark.cuda
def test_ilqr_profiling_instantiation_is_bit_equal(cuda):
    """The tracking-MPC kernel's profiling instantiation returns the normal
    one's bits and a cycle count for every phase."""
    host = itm.pack_inputs(mpc_inputs([0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0]),
                           mpc_params())
    buf = torch.from_numpy(host).to(cuda)
    run = (MPC_H, 128, MPC_H, 8, 1, 0, ilqr.HEUN)
    out = itm.update(buf, *run)
    prof, cycles = itm.profile(buf, *run)
    torch.cuda.synchronize()
    assert torch.equal(out, prof)
    assert set(cycles) == set(ilqr.PHASES)
    assert all(v > 0 for v in cycles.values())
    assert cycles["rollouts"] > cycles["pick_copy"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lateral_profile",
                                  "velocity_profile_space"])
def test_rstp_profiling_instantiation_is_bit_equal(cuda, name):
    s = rstp_solver(name, 250, 250, "cpu", np.random.default_rng(5), False)
    host = ilqr_rstp.pack_inputs(name, s._inputs(), s.params._values,
                                 s._mu_step)
    buf = torch.from_numpy(host).to(cuda)
    run = (250, RSTP_N_REF, 250, s.max_iterations, 1)
    out = ilqr_rstp.update(name, buf, *run)
    prof, cycles = ilqr_rstp.profile(name, buf, *run)
    torch.cuda.synchronize()
    assert torch.equal(out, prof)
    assert all(v > 0 for v in cycles.values())


@pytest.mark.cuda
def test_latency_probe_and_sincos_check(cuda):
    """The probe returns a positive latency for every operation, ordered as
    the hardware orders them, and the card's sincos() has the bits of its
    sin() and cos() (the tracking-MPC rollouts rely on it)."""
    from tpl_tpu_torch import _latency

    lat = _latency.measure(cuda)
    assert set(lat) == set(_latency.PROBES)
    assert all(v > 0 for v in lat.values())
    assert lat["f64_div"] > lat["f64_add"] and lat["f32_div"] > lat["f32_add"]
    assert lat["f64_sin"] > lat["f64_mul"]
    assert _latency.sincos_mismatches(cuda, -50.0, 50.0, 1_000_000) == 0


# ---------------------------------------------------------------------
# the poly chain's kernels (lon DP, lateral sweep and selection, the
# rampify start mode): bit for bit against the plain versions on the CPU,
# but the sweep (float64 sums in another order, sinf / cosf of another
# library: the cost to rtol 1e-12, the collision distance exactly)

def _on(dev, *arrays):
    return tuple(torch.as_tensor(np.asarray(a)).to(dev) for a in arrays)


@pytest.mark.cuda
def test_lon_backward_kernel_matches_plain_bit_for_bit(cuda):
    """Every slice of a demo-width solve (the final one included), each
    from the plain version's next slice."""
    T, S, V, A, P = (LON_DEMO[k] for k in "TSVAP")
    pp, path, dist, _ = lon_scene(S, V, A, P, T, 5, demo=True)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    args = _on(cuda, pp, path, dist)
    for i in range(T - 1, 0, -1):
        before = tlk.backward_launches
        got = tlk.backward_slice(nodes[min(i + 1, T - 1)].to(cuda), *args, i,
                                 i == T - 1)
        torch.cuda.synchronize()
        assert tlk.backward_launches == before + 1
        assert torch.equal(got.cpu(), nodes[i]), f"slice {i}"
    assert (nodes[1:T - 1, ..., 1] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("grid", LON_EDGE)
def test_lon_backward_kernel_edge_grids_bit_for_bit(cuda, grid):
    """Every slice of the edge grids of ``scenes.LON_EDGE`` (the fastest v
    shifts past the last s row, the next v and a clamp at both ends, tiles
    that do not divide S) bit for bit against the plain version on the
    CPU, one launch each."""
    T, S, V, A, P = grid
    pp, path, dist, _ = lon_scene(S, V, A, P, T, 3)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    args = _on(cuda, pp, path, dist)
    for i in range(T - 1, 0, -1):
        before = tlk.backward_launches
        got = tlk.backward_slice(nodes[min(i + 1, T - 1)].to(cuda), *args, i,
                                 i == T - 1)
        torch.cuda.synchronize()
        assert tlk.backward_launches == before + 1
        assert torch.equal(got.cpu(), nodes[i]), f"slice {i}"


@pytest.mark.cuda
def test_lon_backward_box_limit_raises_before_launch(cuda):
    """A grid whose one-row block does not fit a block's shared memory
    raises, naming the limit, and launches nothing."""
    T, S, V, A, P = 3, 11, 5, 480, 20
    pp, path, dist, _ = lon_scene(S, V, A, P, T, 3)
    nxt = torch.zeros((S, V, A, 4), dtype=torch.float32, device=cuda)
    before = tlk.backward_launches
    with pytest.raises(ValueError, match="shared memory"):
        tlk.backward_slice(nxt, *_on(cuda, pp, path, dist), 1, False)
    assert tlk.backward_launches == before


@pytest.mark.cuda
def test_lon_forward_and_reeval_kernel_match_plain_bit_for_bit(cuda):
    T, S, V, A, P = (LON_DEMO[k] for k in "TSVAP")
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, 6, demo=True)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    args = _on("cpu", pp, path, dist)
    # a replan's start (the previous plan's cost and constraint at its
    # head), then the scene's
    for start in (lon_shifted_start(x0), x0):
        want = tlk.forward_reference(nodes, *args, torch.from_numpy(start))
        before = tlk.forward_launches
        got = tlk.forward(nodes.to(cuda), *_on(cuda, pp, path, dist),
                          torch.from_numpy(start).to(cuda))
        torch.cuda.synchronize()
        assert tlk.forward_launches == before + 1
        assert torch.equal(got.cpu(), want)
    traj = want.clone()
    traj[2:, tlk.LC_J] = float(pp[tlk.LON_PP_KEYS.index("j_min")])
    traj = torch.cat([traj, traj[-3:]])
    want_r = tlk.reeval_reference(nodes, *args, traj)
    got_r = tlk.reeval_pass(nodes.to(cuda), *_on(cuda, pp, path, dist),
                            traj.to(cuda))
    assert torch.equal(got_r.cpu(), want_r)


@pytest.mark.cuda
@pytest.mark.parametrize("channel", ["all", "cost"])
def test_lon_kernels_nan_rule_match_plain(cuda, channel):
    """``lon_scene(41, 13, 5, 90, 5)``: slice T - 2 from a next slice whose
    row S // 2 is NaN (every channel, or the cost alone), the slice after
    it from that one, and the forward and reeval passes over nodes whose
    slice 2 is NaN at a index 1, on the card against the plain versions on
    the CPU, NaN equal to NaN (a NaN constraint: cost inf, the first jerk;
    a NaN cost of the least constraint: the first one)."""
    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    args = _on("cpu", pp, path, dist)
    args_g = _on(cuda, pp, path, dist)
    nxt = nodes[T - 1].clone()
    _poison(nxt[S // 2], channel)
    for i in (T - 2, T - 3):
        want = tlk.backward_slice_reference(nxt, *args, i, False)
        got = tlk.backward_slice(nxt.to(cuda), *args_g, i, False)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        assert torch.isnan(want).any()
        nxt = want
    bad = nodes.clone()
    _poison(bad[2, :, :, 1], channel)
    want = tlk.forward_reference(bad, *args, torch.from_numpy(x0))
    got = tlk.forward(bad.to(cuda), *args_g, torch.from_numpy(x0).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.isnan(want[1]).any()
    traj = tlk.forward_reference(nodes, *args, torch.from_numpy(x0))
    traj = torch.cat([traj, traj[-2:]])
    want = tlk.reeval_reference(bad, *args, traj)
    got = tlk.reeval_pass(bad.to(cuda), *args_g, traj.to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_lon_forward_profile_is_bit_equal(cuda):
    """The forward pass's profiling instantiation: the plain
    instantiation's rows bit for bit, every phase counted."""
    T, S, V, A, P = (LON_DEMO[k] for k in "TSVAP")
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, 6, demo=True)
    nodes = lon_nodes(pp, path, dist, T, S, V, A, dev=cuda)
    a = (nodes,) + _on(cuda, pp, path, dist, x0)
    got, phases = tlk.forward_profile(*a)
    assert torch.equal(got, tlk.forward(*a))
    assert set(phases) == set(tlk.FORWARD_PHASES)
    assert all(v > 0 for v in phases.values())


@pytest.mark.cuda
def test_lon_forward_staging_limit_raises_before_launch(cuda):
    """A distance map whose staging does not fit a block's shared memory
    raises, naming the limit, and launches nothing."""
    T, S, V, A, P = 2, 30000, 2, 2, 20
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, 3)
    nodes = torch.zeros((T, S, V, A, 4), dtype=torch.float32, device=cuda)
    before = tlk.forward_launches
    with pytest.raises(ValueError, match="shared memory"):
        tlk.forward(nodes, *_on(cuda, pp, path, dist, x0))
    assert tlk.forward_launches == before


@pytest.mark.cuda
def test_lon_solve_launches_one_kernel_per_slice_and_one_forward(cuda):
    T, S, V, A, P = (LON_DEMO[k] for k in "TSVAP")
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, 7, demo=True)
    solve, _ = tlk.make_lon_solver(dict(t_steps=T, s_steps=S, v_steps=V,
                                        a_steps=A, path_steps=P))
    b0, f0 = tlk.backward_launches, tlk.forward_launches
    nodes, traj = solve(*_on(cuda, dist, path, pp, x0))
    torch.cuda.synchronize()
    assert (tlk.backward_launches - b0, tlk.forward_launches - f0) == (T - 1,
                                                                       1)
    want_nodes = lon_nodes(pp, path, dist, T, S, V, A)
    assert torch.equal(nodes.cpu(), want_nodes)
    assert torch.equal(traj.cpu(), tlk.forward_reference(
        want_nodes, *_on("cpu", pp, path, dist), torch.from_numpy(x0)))


@pytest.mark.cuda
@pytest.mark.parametrize("LD,SD,S", [(1, 20, 201), (21, 13, 201),
                                     (6, 4, 61)])
def test_poly_lat_sweep_kernel_matches_plain(cuda, LD, SD, S):
    scene = poly_lat_scene(LD, SD, S, LD + SD + S)
    occ, rl, step, pp, env, start = scene
    step = np.array([step], np.float32)
    want_cd, want_tc = plk.evaluate_reference(
        *_on("cpu", occ, rl, step, pp, env, start), LD, SD, S)
    before = plk.launches
    cd, tc = plk.sweep(*_on(cuda, occ, rl, step, pp, env, start), LD, SD, S)
    torch.cuda.synchronize()
    assert plk.launches == before + 1
    assert (cd.dtype, tc.dtype) == (torch.float32, torch.float64)
    assert torch.equal(cd.cpu(), want_cd)
    np.testing.assert_allclose(tc.cpu().numpy(), want_tc.numpy(), rtol=1e-12,
                               atol=0)


@pytest.mark.cuda
def test_poly_lat_sweep_profile_is_bit_equal(cuda):
    """The sweep's profiling instantiation: the plain instantiation's
    results (the maps, the winner and its cost) bit for bit, every phase
    counted, the selection's too."""
    LD, SD, S = 1, 20, 201
    occ, rl, step, pp, env, start = poly_lat_scene(LD, SD, S, 9)
    a = _on(cuda, occ, rl, np.array([step], np.float32), pp, env, start)
    *got, phases = plk.sweep_profile(*a, LD, SD, S)
    want = plk.sweep_select(*a, LD, SD, S)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert set(phases) == set(plk.SWEEP_PHASES)
    assert all(v > 0 for v in phases.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("clean", "nan") + SELECT_EDGES)
def test_poly_lat_select_kernel_matches_plain(cuda, case):
    """The sweep's last block's selection at 21 x 13, 1 x 20, 4 x 3 and
    5 x 11 on seeded scenes: clean, with NaN lane bounds
    (``poly_lat_nan_bounds``: NaN costs) and driven into each of its edges
    (``poly_lat_select_edge``: every collision distance tied, every cost
    past the feasibility limit, the first update's cost NaN, every cost NaN
    so that the winner stays the first update's index at cost inf).  The
    winner and its cost are the plain selection's on the kernel's own
    maps, and the maps the plain sweep's; one launch each."""
    for LD, SD in ((21, 13), (1, 20), (4, 3), (5, 11)):
        S = 61
        scene = poly_lat_scene(LD, SD, S, LD + SD)
        occ, rl, step, pp, env, start = scene
        if case == "nan":
            rl = poly_lat_nan_bounds(rl)
        elif case != "clean":
            occ, rl, step, pp, env, start = poly_lat_select_edge(scene, SD,
                                                                 case)
        a = (occ, rl, np.array([step], np.float32), pp, env, start)
        want_cd, want_tc = plk.evaluate_reference(*_on("cpu", *a), LD, SD, S)
        before = plk.launches
        cd, tc, best, cost = plk.sweep_select(*_on(cuda, *a), LD, SD, S)
        torch.cuda.synchronize()
        assert plk.launches == before + 1
        assert torch.equal(cd.cpu(), want_cd)
        assert torch.equal(torch.isnan(tc.cpu()), torch.isnan(want_tc))
        np.testing.assert_allclose(tc.cpu().numpy(), want_tc.numpy(),
                                   rtol=1e-12, atol=0)
        want_b, want_c = plk.select_reference(
            cd.cpu(), tc.cpu(), pp[plk.PL_PP_KEYS.index("length_veh")],
            LD, SD)
        assert int(best) == int(want_b), (LD, SD)
        assert float(cost) == float(want_c), (LD, SD)
        nan = torch.isnan(tc.cpu()).flatten()
        init = min(LD // 2 + 1, LD - 1) * SD + SD - 1
        if case == "nan":
            assert nan.any() and not nan.all()
        elif case == "empty":
            assert (cd == 1000.0).all()
        elif case == "infeasible":
            assert (tc.float() >= 1e6).all()
        elif case == "nan_init":
            assert nan[init] and not nan.all()
        elif case == "nan_all":
            assert nan.all() and int(best) == init
            assert float(cost) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("where", NAN_VALUES)
def test_lon_kernels_nan_value_match_plain(cuda, where):
    """``lon_scene(41, 13, 5, 90, 5)`` with a NaN in the distance map or in
    the path's v_max (``lon_nan_values``): the final slice and slice T - 2
    from the clean next slice, the forward pass and the reeval pass of the
    clean trajectory over clean nodes, on the card against the plain
    versions on the CPU, NaN equal to NaN (the terms keep it)."""
    T, S, V, A, P = 5, 41, 13, 5, 90
    pp, path, dist, x0 = lon_scene(S, V, A, P, T, S + A)
    nodes = lon_nodes(pp, path, dist, T, S, V, A)
    traj = tlk.forward_reference(nodes, *_on("cpu", pp, path, dist),
                                 torch.from_numpy(x0))
    traj = torch.cat([traj, traj[-2:]])
    path, dist = lon_nan_values(path, dist, where)
    args = _on("cpu", pp, path, dist)
    args_g = _on(cuda, pp, path, dist)
    for i, last in ((T - 1, True), (T - 2, False)):
        nxt = nodes[min(i + 1, T - 1)]
        want = tlk.backward_slice_reference(nxt, *args, i, last)
        got = tlk.backward_slice(nxt.to(cuda), *args_g, i, last)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.isnan(want).any()
    want = tlk.forward_reference(nodes, *args, torch.from_numpy(x0))
    got = tlk.forward(nodes.to(cuda), *args_g, torch.from_numpy(x0).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.isnan(want).any()
    want = tlk.reeval_reference(nodes, *args, traj)
    got = tlk.reeval_pass(nodes.to(cuda), *args_g, traj.to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.isnan(want).any()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["distance", "lane_bounds"])
def test_action_min_and_fused_slice_nan_value_match_plain(cuda, where):
    """Slice T - 2 of the seeded 61 x 9 x 11 scene from its clean final
    slice, with NaN cells in the DP distance map or NaN lane bounds: the
    fused slice, and the action-min on the slice's inputs, on the card
    against their plain versions on the CPU, NaN equal to NaN."""
    S, DS, L, T = 61, 9, 11, 6
    i = T - 2
    (solve, dist_x, rl, step, pp), (solve_g, _, _, step_g, pp_g) = [
        _slice_scene(dev, S, DS, L, T, S + T) for dev in ("cpu", cuda)]
    nxt = solve.final_slice(dist_x, rl, step, pp)
    dist_x, rl = dist_x.clone(), rl.clone()
    if where == "distance":
        dist_x[i, 20:22, L // 2 + 1] = float("nan")
    else:
        rl[40:44, 5] = float("nan")
        rl[80:82, 6] = float("nan")
    tables = solve.action_tables(pp)
    want = solve.backward_slice_reference(nxt, i, dist_x, rl, step, pp,
                                          tables).numpy()
    assert np.isnan(want).any()
    got = solve_g.backward_slice(nxt.to(cuda), i, dist_x.to(cuda),
                                 rl.to(cuda), step_g, pp_g,
                                 solve_g.action_tables(pp_g))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    ins = solve.slice_inputs(i, dist_x, rl, step, pp)
    want = lam.action_min_reference(nxt, *ins, tables).numpy()
    got = lam.action_min(nxt.to(cuda), *[a.to(cuda) for a in ins],
                         solve_g.action_tables(pp_g))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [200, 37, 2])
def test_rampify_start_mode_matches_plain_bit_for_bit(cuda, H):
    args = rampify_args(cuda, H, H, H)
    lim = args[2].clone()
    lim[H // 3] = 0.0
    scal = args[4:]
    before = (rstp_rampify.launches, rstp_rampify.start_launches)
    got = rstp_rampify.scan_start(lim, *scal)
    torch.cuda.synchronize()
    assert (rstp_rampify.launches, rstp_rampify.start_launches) == (
        before[0] + 1, before[1] + 1)
    want = rstp_rampify.scan_start_reference(lim.cpu(),
                                             *[a.cpu() for a in scal])
    assert torch.equal(got.cpu(), want)
    # the RSTP mode of the same source is unchanged
    assert torch.equal(rstp_rampify.scan(*args).cpu(),
                       rstp_rampify.scan_reference(*[
                           a.cpu() if torch.is_tensor(a) else a
                           for a in args]))


@pytest.mark.cuda
def test_chain_replan_launch_counts(cuda):
    """One replan of the chain on the card at the demo set's widths: one
    launch of the sweep and its selection, one rampify scan, T - 1 backward
    slices and one forward pass; the same winner and trajectory as the
    plain chain on the CPU."""
    import tpl_tpu_torch
    from tpl_tpu_torch.planning.dyn_prog.dp_environment import (
        DpEnvironment, DpEnvParams)

    def straight_env():
        env = DpEnvironment()
        p = DpEnvParams()
        p.l_steps = 31
        env.reinit_buffers(p)
        rl = np.zeros((401, 9))
        rl[:, 0] = np.arange(401) * 0.5
        rl[:, 3] = rl[:, 0]
        rl[:, 5] = 10.0
        rl[:, 6] = rl[:, 7] = 6.0
        env.set_ref_line(rl, 0.5)
        quad = np.array([[38.0, -1.0], [42.0, -1.0], [42.0, 1.0],
                         [38.0, 1.0]])
        env.insert_geometry([(quad, t) for t in np.arange(10.0)],
                            stationary=True)
        env.update()
        return env

    lat = plk.PolyLatParams()
    lat.l_dst_min = lat.l_dst_max = 0.0
    lat.l_dst_steps, lat.s_dst_steps = 1, 20
    lat.s_dst_min, lat.s_dst_max = 2.0, 80.0
    lon = tlk.LonParams()
    lon.a_steps, lon.path_step_size = 20, 1.0
    start = np.array([0.3, 0.0, 0.0, 0.0, 8.0], np.float32)
    old = np.zeros((tpck.KEEP_CAP, 12), np.float32)
    x0 = np.zeros(7)
    x0[tlk.LC_V] = 8.0
    prev = np.array([0.5, 0.1], np.float32)
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            tpl_tpu_torch.use_device(dev)
            env = straight_env()
            counts = (plk.launches, rstp_rampify.start_launches,
                      tlk.backward_launches, tlk.forward_launches)
            out[dev] = tpck.ChainRunner().replan(env, lat, lon, start, old, 0,
                                                 x0, prev)
            counts = tuple(a - b for a, b in zip(
                (plk.launches, rstp_rampify.start_launches,
                 tlk.backward_launches, tlk.forward_launches), counts))
            want = (0, 0, 0, 0) if dev == "cpu" else (
                1, 1, lon.t_steps - 1, 1)
            assert counts == want, (dev, counts)
    finally:
        tpl_tpu_torch.use_device("cuda")
    new_c, path_c, il_c, isd_c, cost_c, traj_c, arc_c = out["cpu"]
    new_g, path_g, il_g, isd_g, cost_g, traj_g, arc_g = out["cuda"]
    assert (il_g, isd_g) == (il_c, isd_c)
    np.testing.assert_allclose(path_g, path_c, rtol=0, atol=1e-4)
    np.testing.assert_allclose(traj_g, traj_c, rtol=0, atol=TRAJ_ATOL)


IDM_RTOL = IDM_ATOL = 1e-5


def _idm_rollout_case(dev, scene, C, T):
    if scene == "bench":
        rl, objs, pp, init_ref, init_con, l_trgs, d_stops = \
            idm_bench_scene(C)
        return idm_args(rl, objs, pp, init_ref, init_con, l_trgs, d_stops,
                        dev)
    if scene == "hairpin":
        rl, objs, pp, init_ref, init_con = idm_hairpin_scene()
    else:
        rl, objs, pp, init_ref, init_con = idm_scene(
            stop_cell=scene == "stop_cell", oncoming=scene == "oncoming")
    l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(np.float32)
    return idm_args(rl, objs, pp, init_ref, init_con, l_trgs, d_stops, dev)


def _cpu(args):
    return tuple({k: v.cpu() for k, v in a.items()} if isinstance(a, dict)
                 else a.cpu() if torch.is_tensor(a) else a for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,C,T", [("stop_cell", 48, 30),
                                       ("free", 13, 100),
                                       ("bench", 64, 100),
                                       ("oncoming", 24, 100),
                                       ("hairpin", 24, 100)])
def test_idm_rollout_kernel_matches_plain(cuda, scene, C, T):
    args = _idm_rollout_case(cuda, scene, C, T)
    before = (idk.rollout_launches, idk.evaluate_launches)
    refs, cons = idk.rollout(*args, T)
    torch.cuda.synchronize()
    assert (idk.rollout_launches, idk.evaluate_launches) == (before[0] + 1,
                                                             before[1])
    want = idk.rollout_reference(*args[:4], args[4][0], args[5], args[6][0],
                                 args[7], args[8], T)
    np.testing.assert_allclose(refs.cpu().numpy(), want[0].cpu().numpy(),
                               rtol=IDM_RTOL, atol=IDM_ATOL)
    np.testing.assert_allclose(cons.cpu().numpy(), want[1].cpu().numpy(),
                               rtol=IDM_RTOL, atol=IDM_ATOL)


@pytest.mark.cuda
def test_idm_evaluate_step_cap_raises_before_launch(cuda):
    """T = 513 steps, one past the evaluation's cap (``T <= 512``,
    ``csrc/idm_evaluate.cu``): a ValueError naming it, no launch."""
    C, T = 8, 513
    a = _idm_rollout_case(cuda, "free", C, T)
    refs = torch.zeros((C, T, 10), dtype=torch.float32, device=cuda)
    cons = torch.zeros((C, T, 9), dtype=torch.float32, device=cuda)
    lg = torch.zeros(1, dtype=torch.float32, device=cuda)
    before = idk.evaluate_launches
    with pytest.raises(ValueError, match="at most 512"):
        idk.evaluate(refs, cons, a[2], a[7], a[5], a[6], a[8], lg)
    assert idk.evaluate_launches == before


@pytest.mark.cuda
def test_idm_rollout_ref_cap_raises_before_launch(cuda):
    """4,097 ref line points, one past the rollout's cap (4,096,
    ``csrc/idm_rollout.cu``): a ValueError naming it, no launch."""
    a = list(_idm_rollout_case(cuda, "free", 8, 20))
    rl = a[5]
    a[5] = torch.cat([rl, rl[-1:].expand(4097 - rl.shape[0], 7)]).contiguous()
    before = idk.rollout_launches
    with pytest.raises(ValueError, match="at most 4096"):
        idk.rollout(*a, 20)
    assert idk.rollout_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["collider", "rollout", "oncoming",
                                  "hairpin"])
def test_idm_evaluate_kernel_matches_plain(cuda, case):
    """The parked collider (the collision screen hits), a rollout of the
    stop-cell scene, one of an oncoming car (the interaction screen's hull
    tests run and hit) and one of the hairpin scene (the path gate lets a
    part of the projections through)."""
    if case == "hairpin":
        rl, objs, pp, init_ref, init_con = idm_hairpin_scene()
    else:
        rl, objs, pp, init_ref, init_con = idm_scene(
            stop_cell=case == "rollout", collider=case == "collider",
            oncoming=case == "oncoming")
    if case == "collider":
        C, T = 64, 20
        refs, cons = (torch.from_numpy(a).to(cuda)
                      for a in idm_through_states(C, T))
        l_trgs = np.linspace(-3, 3, C).astype(np.float32)
    else:
        C, T = 40, 100
        l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    a = idm_args(rl, objs, pp, init_ref, init_con, l_trgs,
                 np.full(C, 1e6, np.float32), cuda)
    if case != "collider":
        refs, cons = idk.rollout(*a, T)
    lg = torch.zeros(1, dtype=torch.float32, device=cuda)
    before = (idk.rollout_launches, idk.evaluate_launches)
    got = idk.evaluate(refs, cons, a[2], a[7], a[5], a[6], a[8], lg)
    torch.cuda.synchronize()
    assert (idk.rollout_launches, idk.evaluate_launches) == (before[0],
                                                             before[1] + 1)
    want = idk.evaluate_reference(refs, cons, a[2], a[7], a[5], a[6][0],
                                  a[8], lg[0]).cpu().numpy()
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got, want, rtol=IDM_RTOL, atol=IDM_ATOL)
    if case == "collider":
        assert want[4].any()
    if case == "oncoming":
        assert idk.evaluate_work(cons, a[7], a[8])[1] > 0
        assert (want[2] > 0).any() and (want[3] > 0).any()
    if case == "hairpin":
        n_proj = idk.evaluate_work(cons, a[7], a[8], projections=True)[2]
        assert 0 < n_proj < C * 100 * objs["pred_t"].shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["obstacles", "free", "bench"])
def test_poly_sampling_kernel_matches_plain(cuda, scene):
    start, path, obs, pp = poly_scene(obstacles=scene == "obstacles",
                                      bench=scene == "bench")
    a = psp.device_inputs(start, path, obs, pp, cuda)
    before = pok.launches
    packed, cost, best = pok.run(*a)
    torch.cuda.synchronize()
    assert pok.launches == before + 1
    want_p, want_c, want_b = pok.run_reference(*a)
    assert int(best) == int(want_b)
    assert int(best) == psp._eval_candidates(start, path, obs, pp)["best"]
    np.testing.assert_allclose(packed.cpu().numpy(), want_p.cpu().numpy(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(cost), float(want_c), rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan", "tie"])
def test_poly_sampling_kernel_selection_nan_and_tie(cuda, case):
    """A NaN cost at an index > 0 wins (the first NaN, as ``torch.argmin``
    takes it); an exact tie of the least cost goes to the smaller index:
    the plain version's winner, its rows to 1e-9 (NaN equal to NaN)."""
    start, path, obs, pp = poly_scene()
    a = [x.clone() for x in psp.device_inputs(start, path, obs, pp, cuda)]
    if case == "nan":
        a[1][17] = float("nan")
    else:
        b = int(pok.run_reference(*a)[2])
        for i in (1, 2, 3):
            a[i][29] = a[i][b]
    packed, cost, best = pok.run(*a)
    want_p, want_c, want_b = pok.run_reference(*a)
    assert int(best) == int(want_b)
    if case == "nan":
        assert int(best) == 17 and torch.isnan(cost)
    np.testing.assert_allclose(packed.cpu().numpy(), want_p.cpu().numpy(),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_one_launch_kernels_replay_from_a_cuda_graph(cuda):
    """The poly grid, the propagation and the lateral sweep with its
    selection captured in a CUDA graph and replayed three times: each
    replay's results those of a direct launch, and the stream's arrival
    counter back at 0 after each."""
    from tpl_tpu_torch import _build

    start, path, obs, pp = poly_scene(bench=True)
    a = psp.device_inputs(start, path, obs, pp, cuda)
    want = [x.clone() for x in pok.run(*a)]
    lat = _on(cuda, *poly_lat_scene(21, 13, 61, 3)[:2],
              np.array([0.5], np.float32), *poly_lat_scene(21, 13, 61, 3)[3:])
    want_lat = [x.clone() for x in plk.sweep_select(*lat, 21, 13, 61)]
    node_pts, edge_steps = dp_poly_propagation_case(0, n1=300, e2=20_000)
    bufs = dp_poly_buffers(node_pts, edge_steps, cuda)
    ppk.propagate_and_backtrack(*bufs)
    want_prop = [bufs[i].clone() for i in (1, 2, 6)]
    # the capture stream's counter exists before the capture, so the graph
    # holds no reset of its own
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        pok.run(*a)
        counter = _build.arrival_counter(torch.device(cuda),
                                         side.cuda_stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        got = pok.run(*a)
        ppk.propagate_and_backtrack(*bufs)
        got_lat = plk.sweep_select(*lat, 21, 13, 61)
    for _ in range(3):
        for i in (1, 2, 6):
            bufs[i].zero_()
        for x in got_lat:
            x.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert int(counter.item()) == 0
        for x, y in zip([*got, *got_lat], want + want_lat):
            assert torch.equal(x, y)
        for i, w in zip((1, 2, 6), want_prop):
            assert torch.equal(torch.nan_to_num(bufs[i]), torch.nan_to_num(w))


@pytest.mark.cuda
def test_rollout_planner_wrappers_never_take_the_plain_version(cuda,
                                                               monkeypatch):
    """On CUDA tensors the three entries launch their kernels: with the
    plain versions replaced by a function that raises, they still run."""
    def plain(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((idk, "rollout_reference"),
                      (idk, "evaluate_reference"), (pok, "run_reference")):
        monkeypatch.setattr(mod, name, plain)
    a = _idm_rollout_case(cuda, "stop_cell", 16, 20)
    before = (idk.rollout_launches, idk.evaluate_launches, pok.launches)
    refs, cons = idk.rollout(*a, 20)
    idk.evaluate(refs, cons, a[2], a[7], a[5], a[6], a[8],
                 torch.zeros(1, dtype=torch.float32, device=cuda))
    start, path, obs, pp = poly_scene()
    pok.run(*psp.device_inputs(start, path, obs, pp, cuda))
    torch.cuda.synchronize()
    assert (idk.rollout_launches, idk.evaluate_launches,
            pok.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
def test_idm_replan_is_one_upload_two_launches_one_download(cuda):
    """``run_kernels`` on the card: one rollout and one evaluation launch;
    its costs those of the CPU path (the plain versions)."""
    rl, objs, pp, init_ref, init_con = idm_scene(stop_cell=True)
    C, T = 8, 100
    l_trgs = np.linspace(-3, 3, C).astype(np.float32)
    d_stops = np.full(C, 1e6, np.float32)
    inputs = (init_ref, init_con, l_trgs, d_stops, 0.05, rl, 0.5, objs,
              pp.packed(), 0.0, T)
    before = (idk.rollout_launches, idk.evaluate_launches)
    refs, cons, costs = isp.run_kernels(*inputs, cuda)
    assert (idk.rollout_launches, idk.evaluate_launches) == (before[0] + 1,
                                                             before[1] + 1)
    refs_c, cons_c, costs_c = isp.run_kernels(*inputs, torch.device("cpu"))
    np.testing.assert_allclose(cons, cons_c, rtol=IDM_RTOL, atol=IDM_ATOL)
    np.testing.assert_allclose(costs, costs_c, rtol=IDM_RTOL, atol=IDM_ATOL)


# ---------------------------------------------------------------------
# the graph DP planner's kernels

def _field_args(dev):
    p = dpe.DpEnvParams()
    ray, step = dpe.ray_table(p.dir_min, p.dir_max, p.dir_steps,
                              p.s_step_size, p.l_step_size)
    scal = [float(np.float32(x)) for x in (p.s_min, p.s_step_size, p.l_min,
                                           p.l_step_size)]
    return ray.to(dev), scal, step


@pytest.mark.cuda
@pytest.mark.parametrize("case,R", [("scene", 72), ("random", 72),
                                    ("random", 40)])
def test_dir_dist_kernel_matches_plain(cuda, case, R):
    tpl_tpu_torch.use_device("cuda")
    occ = (dp_poly_env(True).grid.occ_map if case == "scene" else
           torch.from_numpy(dp_random_occ(7)).to(cuda))
    ray, scal, step = _field_args(cuda)
    before = dpe.dir_dist_launches
    got = dpe.dir_dist_map(occ, ray, *scal, step, R)
    want = dpe.dir_dist_reference(occ, ray, *scal, step, R)
    cpu = dpe.dir_dist_reference(occ.cpu(), ray.cpu(), *scal, step, R)
    torch.cuda.synchronize()
    assert dpe.dir_dist_launches == before + 1
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 10, 40])
@pytest.mark.parametrize("R", [40, 72])
def test_dir_dist_kernel_one_march_for_all_slices(cuda, T, R):
    """One march a ray for every slice of a group (T = 40: groups of 32 and
    8) on occupancy that changes over t, at the demo grid's 201 stations:
    cell for cell the plain version's field on the card and on the CPU;
    the profiling instantiation bit-equal, with every phase counted."""
    tpl_tpu_torch.use_device("cuda")
    occ = torch.from_numpy(dp_moving_occ(T + R, T, S=201)).to(cuda)
    ray, scal, step = _field_args(cuda)
    got = dpe.dir_dist_map(occ, ray, *scal, step, R)
    prof, cycles, blocks = dpe.dir_dist_profile(occ, ray, *scal, step, R)
    want = dpe.dir_dist_reference(occ, ray, *scal, step, R)
    cpu = dpe.dir_dist_reference(occ.cpu(), ray.cpu(), *scal, step, R)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
    assert torch.equal(prof, got)
    assert blocks == 201 * (2 if T > 32 else 1)
    assert all(v > 0 for v in cycles.values())


def _graph_levels(dev, key, small):
    env = dp_poly_env(True)
    dd = env.update_dir_dist_map()
    p = ppk.DpPolyParams()
    if small:
        p.ds_steps, p.l_steps = 8, 9
    node_steps, edge_steps = ppk.build_eval_graph(p, *key)
    ev = ppk.eval_params(p, env.params, np.float32(env.ref_step))
    init = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    init[0, ppk.PP_DS] = p.ds_min + key[0] * p.ds_step_size + 0.3
    init[0, ppk.PP_DDS] = -0.4
    init[0, ppk.PP_L] = p.l_min + key[1] * p.l_step_size - 0.1
    return env, dd, p, node_steps, edge_steps, ev, init


@pytest.mark.cuda
@pytest.mark.parametrize("key,small", [((2, 4), True), ((7, 10), False)])
def test_poly_planner_kernels_match_plain(cuda, key, small):
    """Both levels' evaluation bit for bit (against the plain version on
    the card and on the CPU), then the propagation on those end points:
    every selection, cost and the trajectory equal."""
    tpl_tpu_torch.use_device("cuda")
    env, dd, p, node_steps, edge_steps, ev, init = _graph_levels(cuda, key,
                                                                 small)
    level = [init]
    K = len(edge_steps)
    for k in range(K):
        starts = torch.from_numpy(edge_steps[k]).to(cuda)
        specs = torch.from_numpy(node_steps[k + 1].astype(np.float32)).to(
            cuda)
        got = ppk.eval_edges(level[k], starts, specs, k == K - 1, ev, dd,
                             env.grid.ref_line, p.n_int_steps())
        want = ppk.eval_edges_reference(level[k], starts, specs, k == K - 1,
                                        ev, dd, env.grid.ref_line,
                                        p.n_int_steps())
        cpu = ppk.eval_edges_reference(level[k].cpu(), starts.cpu(),
                                       specs.cpu(), k == K - 1, ev, dd.cpu(),
                                       env.grid.ref_line.cpu(),
                                       p.n_int_steps())
        assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
        level.append(got)
    node_pts = [x.double().cpu().numpy() for x in level]
    a = dp_poly_buffers(node_pts, edge_steps, cuda)
    b = dp_poly_buffers(node_pts, edge_steps, "cpu")
    ppk.propagate_and_backtrack(*a)
    ppk.propagate_reference(*b)
    inner = a[4][-2]
    assert torch.equal(a[2][:inner].cpu(), b[2][:inner])
    assert torch.equal(a[1][:inner].cpu(), b[1][:inner])
    assert torch.equal(a[6].cpu(), b[6])


@pytest.mark.cuda
@pytest.mark.parametrize("key,small", [((2, 4), True), ((5, 1), True),
                                       ((7, 8), True), ((7, 10), False)])
def test_poly_eval_profiling_kernel_is_bit_equal(cuda, key, small):
    """The evaluation's profiling instantiation: both levels' end points
    bit-equal to the kernel's, and the steps it took those the edges need
    (:func:`ppk.eval_steps_needed`)."""
    tpl_tpu_torch.use_device("cuda")
    env, dd, p, node_steps, edge_steps, ev, init = _graph_levels(cuda, key,
                                                                 small)
    level = [init]
    K = len(edge_steps)
    for k in range(K):
        starts = torch.from_numpy(edge_steps[k]).to(cuda)
        specs = torch.from_numpy(node_steps[k + 1].astype(np.float32)).to(
            cuda)
        args = (level[k], starts, specs, k == K - 1, ev, dd,
                env.grid.ref_line, p.n_int_steps())
        got = ppk.eval_edges(*args)
        prof, counts = ppk.eval_edges_profile(*args)
        assert torch.equal(prof, got)
        assert (counts["poly_steps"], counts["tail_steps"]) == \
            ppk.eval_steps_needed(*args[:5], args[-1])
        level.append(got)


@pytest.mark.cuda
@pytest.mark.parametrize("is_last", [True, False])
def test_poly_eval_kernel_near_the_horizon(cuda, is_last):
    """Edges from start points near the horizon (an edge ends at it, some
    end past it): bit for bit the plain version's end points on the card
    and on the CPU, the profiling instantiation too."""
    tpl_tpu_torch.use_device("cuda")
    env = dp_poly_env(True)
    dd = env.update_dir_dist_map()
    p = ppk.DpPolyParams()
    ev = ppk.eval_params(p, env.params, np.float32(env.ref_step))
    pts, starts, specs = (torch.from_numpy(a).to(cuda)
                          for a in dp_poly_near_horizon(p))
    args = (pts, starts, specs, is_last, ev, dd, env.grid.ref_line,
            p.n_int_steps())
    got = ppk.eval_edges(*args)
    want = ppk.eval_edges_reference(*args)
    cpu = ppk.eval_edges_reference(*[a.cpu() if torch.is_tensor(a) else a
                                     for a in args])
    prof, counts = ppk.eval_edges_profile(*args)
    assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
    assert torch.equal(prof, got)
    assert (counts["tail_steps"] > 0) == is_last


@pytest.mark.cuda
@pytest.mark.parametrize("seed,ties,nan", [(0, True, True), (1, True, False),
                                           (2, False, True)])
def test_poly_propagate_kernel_matches_plain(cuda, seed, ties, nan):
    node_pts, edge_steps = dp_poly_propagation_case(seed, n1=300, e2=20_000,
                                                    ties=ties, nan=nan)
    a = dp_poly_buffers(node_pts, edge_steps, cuda)
    b = dp_poly_buffers(node_pts, edge_steps, "cpu")
    before = ppk.propagate_launches
    ppk.propagate_and_backtrack(*a)
    ppk.propagate_reference(*b)
    torch.cuda.synchronize()
    assert ppk.propagate_launches == before + 1
    inner = a[4][-2]
    assert torch.equal(a[2][:inner].cpu(), b[2][:inner])
    nan_eq = torch.nan_to_num
    assert torch.equal(nan_eq(a[1][:inner].cpu(), posinf=1e308),
                       nan_eq(b[1][:inner], posinf=1e308))
    assert torch.equal(nan_eq(a[6].cpu()), nan_eq(b[6]))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3])
def test_poly_propagate_kernel_levels(cuda, levels):
    """K = 1 and K = 3 graphs (the last block takes level 1's 2,000 nodes
    a warp each, then the root): one launch, the plain version's
    selections, costs and trajectory."""
    node_pts, edge_steps = dp_poly_propagation_case(
        4, n1=2000, e2=20_000, e3=40_000, levels=levels)
    a = dp_poly_buffers(node_pts, edge_steps, cuda)
    b = dp_poly_buffers(node_pts, edge_steps, "cpu")
    before = ppk.propagate_launches
    ppk.propagate_and_backtrack(*a)
    ppk.propagate_reference(*b)
    torch.cuda.synchronize()
    assert ppk.propagate_launches == before + 1
    inner = a[4][-2]
    nan_eq = torch.nan_to_num
    assert torch.equal(a[2][:inner].cpu(), b[2][:inner])
    assert torch.equal(nan_eq(a[1][:inner].cpu(), posinf=1e308),
                       nan_eq(b[1][:inner], posinf=1e308))
    assert torch.equal(nan_eq(a[6].cpu()), nan_eq(b[6]))


@pytest.mark.cuda
def test_graph_dp_replan_on_card_matches_cpu(cuda, monkeypatch):
    """``DpPolyPlannerKernel.update`` on the card: 2 evaluations (2
    launches each: the field's slice, the edges) and 1 propagation
    launch, no plain version, and the CPU path's trajectory; the field
    through one launch."""
    def plain(*args, **kw):
        raise AssertionError("a plain version ran on CUDA tensors")

    init = np.zeros(8)
    init[ppk.PP_DS], init[ppk.PP_L] = 8.0, 0.4
    tpl_tpu_torch.use_device("cpu")
    env_c = dp_poly_env(True)
    env_c.update_dir_dist_map()
    want = ppk.DpPolyPlannerKernel().update(init, env_c)
    tpl_tpu_torch.use_device("cuda")
    env = dp_poly_env(True)
    for mod, name in ((dpe, "dir_dist_reference"),
                      (ppk, "eval_edges_reference"),
                      (ppk, "propagate_reference")):
        monkeypatch.setattr(mod, name, plain)
    before = (dpe.dir_dist_launches, ppk.eval_launches,
              ppk.propagate_launches)
    env.update_dir_dist_map()
    got = ppk.DpPolyPlannerKernel().update(init, env)
    assert (dpe.dir_dist_launches, ppk.eval_launches,
            ppk.propagate_launches) == (before[0] + 1, before[1] + 4,
                                        before[2] + 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_graph_dp_replan_moves_one_state_up_and_one_trajectory_down(cuda):
    """A replan on a cached graph, traced by torch.profiler in a process
    that has run no sim loop: one host-to-device copy (the start state),
    the 2 slice, 2 evaluation and 1 propagation kernels, one device-to-host
    copy (the trajectory); no level's end points leave the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tpl_tpu_torch.use_device("cuda")
    env = dp_poly_env(True)
    env.update_dir_dist_map()
    k = ppk.DpPolyPlannerKernel()
    init = np.zeros(8)
    init[ppk.PP_DS], init[ppk.PP_L] = 8.0, 0.4
    want = k.update(init, env)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = k.update(init, env)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    up = [n for n in names if "HtoD" in n]
    down = [n for n in names if "DtoH" in n]
    kernels = [n for n in names if "Memcpy" not in n and "Memset" not in n]
    assert len(up) == 1 and len(down) == 1, names
    assert sorted(n.split("(")[0].split("<")[0].split("::")[-1]
                  for n in kernels) == [
        "eval_edges_kernel", "eval_edges_kernel", "field_slice_kernel",
        "field_slice_kernel", "propagate_kernel"], names
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_multiprocess_apps_launch_their_kernels_on_the_card(cuda,
                                                              monkeypatch):
    """A short attach loop: the env, planning and control mains as three
    processes on the card (no ``--cpu``), ``SimAttach`` here, 30 ticks on
    ``demo/country_follow`` with the scenario's own sets (the vendored RSTP
    planner, fused, H=250; the tracking MPC), each tick after a control
    solve (``tests/torch_deploy.py``).  The kernels are built here first,
    so that the children load them from ``build/``.  The planning process
    launched ``ilqr_rstp`` and ``rstp_rampify``, the control process the
    tracking MPC; no rule violation; every process exits 0."""
    import uuid

    import torch_deploy as deploy
    from tpl_tpu_torch import _build, util
    from tpl_tpu_torch.simulation import SimAttach
    from tpl_tpu_torch.util.shm_store import remove_app_stores

    _build.build(["ilqr_tracking_mpc", "ilqr_rstp", "rstp_rampify"])
    monkeypatch.setenv("TPL_TPU_SHM", "1")
    util.StoreRegistry.clear()
    app_id = "card" + uuid.uuid4().hex[:6]
    procs = deploy.start_mains(app_id, cpu=False)
    try:
        sim = SimAttach(app_id=app_id, scenario_path="demo/country_follow",
                        timeout=300)
        deploy.cut_and_start(sim, cut=False)
        deploy.wait_for_plan(sim, procs, 250)
        ci = util.StoreRegistry.get(util.store_paths(app_id).control_input)
        for _ in range(30):
            deploy.paced_tick(sim, ci, procs)
        with sim.core.sh_state.lock():
            assert sim.core.sh_state.sim.rule_checker.violations == []
    finally:
        out = deploy.stop_mains(procs)
        remove_app_stores(app_id)
        util.StoreRegistry.clear()
    for name, (code, text) in out.items():
        assert code == 0, f"{name} exited {code}:\n{text[-3000:]}"
    planning = deploy.launches(out["planning"][1])
    control = deploy.launches(out["control"][1])
    assert planning["ilqr_rstp"] > 0 and planning["rstp_rampify"] > 0
    assert planning["ilqr_tracking_mpc"] == 0
    # the collision screen's latch (t=0.04-1.03 s) hands most of these ticks
    # to the constant-deceleration fallback, which launches nothing
    assert control["ilqr_tracking_mpc"] > 0
    assert control["ilqr_rstp"] == 0
