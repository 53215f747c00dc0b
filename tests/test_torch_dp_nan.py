"""The plain versions' NaN rule against the JAX package's, on the CPU.

The hand-written kernels of the lon DP (``csrc/lon_dp.cu``), of the DP
action-min (``csrc/latlon_action_min.cu``) and of the lateral sweep
(``csrc/poly_lat.cu``) follow their plain versions where a value is NaN (tests/test_torch_kernel_rehearsal.py, the card tests);
here the plain versions are held to the JAX programs on the same NaN
inputs:

- the lon DP's ``_lex_min`` (``backward_slice_reference``,
  ``_eval_single``, ``reeval_reference``) against the JAX ``eval_grid`` /
  ``eval_single`` (the closures of ``make_lon_solver``'s solve) and its
  ``reeval``, on next slices with a NaN row (every channel: a NaN
  constraint, which makes the least constraint NaN, so cost inf and the
  first jerk; the cost alone: the first NaN cost of the least constraint
  wins);
- the DP action-min (``action_min_reference`` and the fused slice's
  ``backward_slice_reference``) against the XLA backward's
  ``backward_slice`` (``backward="xla"``), on a next slice with a NaN row
  (a NaN constraint: action 0 with its own cost and constraint);
- a NaN in a value input, which the terms keep (``torch.clamp``,
  ``jnp.maximum``): the lon DP with NaN cells of the path distance map or
  a NaN in the path's v_max, the action-min and the fused slice with NaN
  cells of the DP distance map or NaN lane bounds, and the candidate sweep
  with NaN lane bounds against the JAX ``evaluate``, its selection against
  ``select_path_device``.

The NaN and inf entries, the chosen jerk or action where an action is NaN,
exactly; elsewhere the tolerances of tests/test_torch_poly_chain.py (lon,
the sweep) and tests/test_torch_latlon_solver.py (action-min).
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpl_tpu.planning.dyn_prog import dp_environment as jdpe
from tpl_tpu.planning.dyn_prog import lat_lon_kernel as jllk
from tpl_tpu.planning.dyn_prog import lon_kernel as jlk
from tpl_tpu.planning.dyn_prog import poly_chain_kernel as jpck
from tpl_tpu.planning.dyn_prog import poly_lat_kernel as jplk

import tpl_tpu_torch
from tpl_tpu_torch.planning.dyn_prog import dp_environment as tdpe
from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as tllk
from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam
from tpl_tpu_torch.planning.dyn_prog import lon_kernel as tlk
from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as tplk
from tests.test_torch_latlon_solver import (
    SPEC as LATLON_SPEC, _action_ids, _jax_solve, _params, _samples,
    _tie_mask, _world, _x0)
from tests.test_torch_poly_chain import (
    SWEEP_RTOL, _check_slice, _demo_lat, _lon_scene, _straight_env,
    _sweep_spec)

COST_RTOL, COST_ATOL = 1e-6, 1e-3
CONSTR_ATOL = 1e-4
TRAJ_ATOL = 1e-3

# A = 8: the JAX program pads the a axis to a multiple of 8
LON_SPEC = dict(t_steps=5, s_steps=41, v_steps=13, a_steps=8, path_steps=50)


@pytest.fixture(autouse=True)
def _cpu_device():
    tpl_tpu_torch.use_device("cpu")


def _poison(a, channel):
    if channel == "all":
        a[...] = np.nan
    else:
        a[..., 0] = np.nan


def _closures(solve):
    return inspect.getclosurevars(solve.__wrapped__).nonlocals


def _lon_case(seed=21):
    """The JAX solve's nodes on a seeded scene, with what both packages
    need to evaluate them."""
    p, path, dist, x0 = _lon_scene(LON_SPEC, seed)
    j_solve, j_reeval = jlk.make_lon_solver(LON_SPEC)
    nodes, traj = j_solve(jnp.asarray(dist), jnp.asarray(path), p.packed(),
                          jnp.asarray(x0))
    pp_j = {k: jnp.float32(v) for k, v in
            jlk.unpack_lon_pp(p.packed()).items()}
    pp_t = torch.from_numpy(p.packed())
    return (p, path, dist, np.array(nodes), np.array(traj),
            j_solve, j_reeval, pp_j, pp_t)


def _js(p, n):
    return np.float32(p.j_min) + np.float32(p.j_max - p.j_min) \
        * np.arange(n, dtype=np.float32) / np.float32(n - 1)


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_lon_backward_nan_rule_matches_jax(channel):
    """Slice T - 2 from a next slice with a NaN row: the NaN / inf entries
    and their nodes' jerks exactly, the other nodes as in
    tests/test_torch_poly_chain.py."""
    p, path, dist, nodes, _, j_solve, _, pp_j, pp_t = _lon_case()
    T, S = LON_SPEC["t_steps"], LON_SPEC["s_steps"]
    eval_grid = _closures(j_solve)["eval_grid"]
    i = T - 2
    nxt = nodes[i + 1].copy()
    _poison(nxt[S // 2], channel)
    t = pp_j["dt_start"] + np.float32(i - 1) * pp_j["dt"]
    want = np.asarray(eval_grid(jnp.asarray(nxt), t, i, jnp.asarray(dist),
                                jnp.asarray(path), pp_j, pp_j["dt"], False))
    got = tlk.backward_slice_reference(
        torch.from_numpy(nxt), pp_t, torch.from_numpy(path),
        torch.from_numpy(dist), i, False).numpy()
    hit = np.isnan(want).any(axis=-1)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[hit][:, 2], want[hit][:, 2])
    if channel == "all":
        assert np.isinf(want[hit][:, 0]).all()
        assert (want[hit][:, 2] == _js(p, tlk.NB)[0]).all()
    _check_slice(got[~hit], want[~hit], p, f"slice {i}")


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_lon_forward_nan_rule_matches_jax(channel):
    """Each state of the JAX trajectory evaluated over its 21 jerks
    (``eval_single``) on a next slice whose a index 1 is NaN: the NaN / inf
    results and their jerk exactly, the rest to the trajectory's
    tolerance; then the reeval pass of that trajectory over the NaN nodes
    against the JAX ``reeval``."""
    p, path, dist, nodes, traj, j_solve, j_reeval, pp_j, pp_t = _lon_case()
    T = LON_SPEC["t_steps"]
    eval_single = _closures(j_solve)["eval_single"]
    bad = nodes.copy()
    for k in range(1, T):
        _poison(bad[k, :, :, 1], channel)
    bad_t = torch.from_numpy(bad)
    args_t = (torch.from_numpy(dist), torch.from_numpy(path))
    js = torch.from_numpy(_js(p, tlk.NF))
    pp = tlk.unpack_lon_pp(pp_t)
    n_nan = 0
    for i in range(T - 1):
        tp = traj[i]
        dt = pp_j["dt_start"] if i == 0 else pp_j["dt"]
        t_idx = tlk._t_index(torch.tensor(tp[tlk.LC_T]), pp, T)
        want = np.asarray(eval_single(
            jnp.asarray(tp), jnp.asarray(bad[min(i + 1, T - 1)]), t_idx,
            jnp.asarray(dist), jnp.asarray(path), pp_j, dt, True, tlk.NF))
        _, cost, cmin, j = tlk._eval_single(
            torch.from_numpy(tp), bad_t[min(i + 1, T - 1)], t_idx,
            *args_t, pp, float(dt), js)
        got = np.array([float(j), float(cost), float(cmin)], np.float32)
        ref = want[[tlk.LC_J, tlk.LC_COST, tlk.LC_CONSTR]]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        if np.isnan(ref).any():
            n_nan += 1
            assert got[0] == ref[0]
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=COST_RTOL,
                                   atol=TRAJ_ATOL)
    assert n_nan > 0

    want_r = np.asarray(j_reeval(jnp.asarray(dist), jnp.asarray(path),
                                 p.packed(), jnp.asarray(traj),
                                 jnp.asarray(bad)))
    got_r = tlk.reeval_reference(bad_t, pp_t, args_t[1], args_t[0],
                                 torch.from_numpy(traj)).numpy()
    np.testing.assert_array_equal(np.isnan(got_r), np.isnan(want_r))
    np.testing.assert_array_equal(np.isinf(got_r), np.isinf(want_r))
    fin = np.isfinite(want_r)
    np.testing.assert_allclose(got_r[fin], want_r[fin], rtol=COST_RTOL,
                               atol=TRAJ_ATOL)


@pytest.mark.parametrize("channel", ["all", "cost"])
def test_action_min_nan_rule_matches_xla_backward(channel):
    """Slice T - 2 of the XLA backward from a next slice with a NaN row
    (``backward_slice``, the closure of the ``backward="xla"`` solve)
    against the plain action-min and the plain fused slice: the NaN / inf
    entries exactly, the action of every cell whose actions hold a NaN
    exactly, the rest as in tests/test_torch_latlon_solver.py."""
    dist, rl, step, rng = _world("stationary", 0)
    p = _params()
    nodes_j, _, _ = _jax_solve("xla", dist, rl, step, p, _x0(rng))
    j_solve, _ = jllk.make_latlon_solver(LATLON_SPEC, backward="xla")
    backward_slice = _closures(j_solve)["backward_slice"]
    S = LATLON_SPEC["s_steps"]
    i = LATLON_SPEC["t_steps"] - 2
    nxt = nodes_j[i + 1].astype(np.float32).copy()
    _poison(nxt[S // 2], channel)
    pp_j = {k: jnp.asarray(v, jnp.float32)
            for k, v in jllk.unpack_pp(p.packed()).items()}
    want = np.asarray(backward_slice(
        jnp.asarray(nxt), jnp.int32(i), jnp.asarray(dist, jnp.float32)[..., 0],
        jnp.asarray(rl, jnp.float32), jnp.float32(step), pp_j))

    solve, _ = tllk.make_latlon_solver(LATLON_SPEC, "cpu")
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, step, p.packed())
    tables = solve.action_tables(pp)
    nxt_t = torch.from_numpy(nxt)
    ins = solve.slice_inputs(i, dist_x, rl_t, step_t, pp)
    got, constr_o, cost_o = lam.action_min_reference(nxt_t, *ins, tables,
                                                     return_actions=True)
    fused = solve.backward_slice_reference(nxt_t, i, dist_x, rl_t, step_t,
                                           pp, tables)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())
    got = got.numpy()
    touched = (torch.isnan(constr_o) | torch.isnan(cost_o)).any(-1).numpy()
    assert touched.any() and not touched.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    dds_vals, dl_vals = _samples(p)
    ids_g = _action_ids(got, dds_vals, dl_vals)
    ids_w = _action_ids(want, dds_vals, dl_vals)
    np.testing.assert_array_equal(ids_g[touched], ids_w[touched])
    if channel == "all":
        assert (ids_g[touched] == 0).all()
    fin = np.isfinite(want[..., :2])
    np.testing.assert_allclose(got[..., 0][fin[..., 0]],
                               want[..., 0][fin[..., 0]], rtol=COST_RTOL,
                               atol=COST_ATOL)
    np.testing.assert_allclose(got[..., 1][fin[..., 1]],
                               want[..., 1][fin[..., 1]], atol=CONSTR_ATOL,
                               rtol=0)
    tie = _tie_mask(constr_o, cost_o)
    differ = np.any(ids_g != ids_w, axis=-1)
    assert not np.any(differ & ~tie & ~touched)


# ---------------------------------------------------------------------
# A NaN in a value input: the path distance map, the path's v_max column,
# the DP distance map, the reference line's lane bounds.  The JAX programs
# and the plain versions keep it in their terms (jnp.maximum, torch.clamp);
# no NaN reaches an index.

def _poison_lon(dist, path, where):
    """NaN into a band of s cells of every row of the path distance map
    (``where`` "dist_path") or into rows of the path's v_max column
    ("v_max")."""
    dist, path = dist.copy(), path.copy()
    if where == "dist_path":
        S = dist.shape[1]
        dist[:, 3 * S // 10:3 * S // 10 + 3] = np.nan
    else:
        P = path.shape[0]
        path[P // 5:P // 5 + 2, tlk.PC_VMAX] = np.nan
    return dist, path


@pytest.mark.parametrize("where", ["dist_path", "v_max"])
def test_lon_backward_nan_value_matches_jax(where):
    """Slice T - 2 from the clean next slice with a NaN in the path
    distance map or the path's v_max: every node whose terms meet the NaN
    has a NaN constraint (cost inf, the first jerk), in both packages; the
    NaN / inf entries and those nodes' jerks exactly, the rest as in
    tests/test_torch_poly_chain.py."""
    p, path, dist, nodes, _, j_solve, _, pp_j, pp_t = _lon_case()
    dist, path = _poison_lon(dist, path, where)
    T = LON_SPEC["t_steps"]
    eval_grid = _closures(j_solve)["eval_grid"]
    i = T - 2
    nxt = nodes[i + 1]
    t = pp_j["dt_start"] + np.float32(i - 1) * pp_j["dt"]
    want = np.asarray(eval_grid(jnp.asarray(nxt), t, i, jnp.asarray(dist),
                                jnp.asarray(path), pp_j, pp_j["dt"], False))
    got = tlk.backward_slice_reference(
        torch.from_numpy(nxt), pp_t, torch.from_numpy(path),
        torch.from_numpy(dist), i, False).numpy()
    hit = np.isnan(want).any(axis=-1)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(want[hit][:, 0]).all()
    assert (want[hit][:, 2] == _js(p, tlk.NB)[0]).all()
    np.testing.assert_array_equal(got[hit][:, 2], want[hit][:, 2])
    _check_slice(got[~hit], want[~hit], p, f"slice {i}")


@pytest.mark.parametrize("where", ["dist_path", "v_max"])
def test_lon_forward_nan_value_matches_jax(where):
    """Each state of the JAX trajectory evaluated over its 21 jerks on the
    clean nodes with a NaN in the path distance map or the path's v_max
    (``eval_single``), then the reeval pass of that trajectory: the NaN /
    inf results and the jerk exactly, the rest to the trajectory's
    tolerance."""
    p, path, dist, nodes, traj, j_solve, j_reeval, pp_j, pp_t = _lon_case()
    dist, path = _poison_lon(dist, path, where)
    T = LON_SPEC["t_steps"]
    eval_single = _closures(j_solve)["eval_single"]
    args_t = (torch.from_numpy(dist), torch.from_numpy(path))
    nodes_t = torch.from_numpy(nodes)
    js = torch.from_numpy(_js(p, tlk.NF))
    pp = tlk.unpack_lon_pp(pp_t)
    n_nan = 0
    for i in range(T - 1):
        tp = traj[i]
        dt = pp_j["dt_start"] if i == 0 else pp_j["dt"]
        t_idx = tlk._t_index(torch.tensor(tp[tlk.LC_T]), pp, T)
        want = np.asarray(eval_single(
            jnp.asarray(tp), jnp.asarray(nodes[min(i + 1, T - 1)]), t_idx,
            jnp.asarray(dist), jnp.asarray(path), pp_j, dt, True, tlk.NF))
        _, cost, cmin, j = tlk._eval_single(
            torch.from_numpy(tp), nodes_t[min(i + 1, T - 1)], t_idx,
            *args_t, pp, float(dt), js)
        got = np.array([float(j), float(cost), float(cmin)], np.float32)
        ref = want[[tlk.LC_J, tlk.LC_COST, tlk.LC_CONSTR]]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        if np.isnan(ref).any():
            n_nan += 1
            assert got[0] == ref[0]
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=COST_RTOL,
                                   atol=TRAJ_ATOL)
    assert 0 < n_nan < T - 1

    want_r = np.asarray(j_reeval(jnp.asarray(dist), jnp.asarray(path),
                                 p.packed(), jnp.asarray(traj),
                                 jnp.asarray(nodes)))
    got_r = tlk.reeval_reference(nodes_t, pp_t, args_t[1], args_t[0],
                                 torch.from_numpy(traj)).numpy()
    assert np.isnan(want_r).any()
    np.testing.assert_array_equal(np.isnan(got_r), np.isnan(want_r))
    np.testing.assert_array_equal(np.isinf(got_r), np.isinf(want_r))
    fin = np.isfinite(want_r)
    np.testing.assert_allclose(got_r[fin], want_r[fin], rtol=COST_RTOL,
                               atol=TRAJ_ATOL)


def test_action_min_nan_distance_matches_xla_backward():
    """Slice T - 2 of the XLA backward from the clean next slice, with NaN
    cells in the DP distance map (``backward_slice``) against the plain
    action-min (on ``slice_inputs`` from the same map) and the plain fused
    slice: the forward distances' running minimum and the occupancy and
    safety terms keep the NaN, so the cells whose lateral sweep meets it
    take action 0 with their own cost and constraint; the NaN / inf entries
    and those cells' actions exactly, the rest as in
    tests/test_torch_latlon_solver.py."""
    dist, rl, step, rng = _world("stationary", 0)
    p = _params()
    nodes_j, _, _ = _jax_solve("xla", dist, rl, step, p, _x0(rng))
    S, L = LATLON_SPEC["s_steps"], LATLON_SPEC["l_steps"]
    i = LATLON_SPEC["t_steps"] - 2
    dist = dist.copy()
    dist[i, S // 3:S // 3 + 2, L // 2 + 1, 0] = np.nan
    j_solve, _ = jllk.make_latlon_solver(LATLON_SPEC, backward="xla")
    backward_slice = _closures(j_solve)["backward_slice"]
    nxt = nodes_j[i + 1].astype(np.float32)
    pp_j = {k: jnp.asarray(v, jnp.float32)
            for k, v in jllk.unpack_pp(p.packed()).items()}
    want = np.asarray(backward_slice(
        jnp.asarray(nxt), jnp.int32(i), jnp.asarray(dist, jnp.float32)[..., 0],
        jnp.asarray(rl, jnp.float32), jnp.float32(step), pp_j))

    solve, _ = tllk.make_latlon_solver(LATLON_SPEC, "cpu")
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, step, p.packed())
    tables = solve.action_tables(pp)
    nxt_t = torch.from_numpy(nxt)
    ins = solve.slice_inputs(i, dist_x, rl_t, step_t, pp)
    got, constr_o, cost_o = lam.action_min_reference(nxt_t, *ins, tables,
                                                     return_actions=True)
    fused = solve.backward_slice_reference(nxt_t, i, dist_x, rl_t, step_t,
                                           pp, tables)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())
    got = got.numpy()
    touched = torch.isnan(constr_o).any(-1).numpy()
    assert touched.any() and not touched.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    dds_vals, dl_vals = _samples(p)
    ids_g = _action_ids(got, dds_vals, dl_vals)
    ids_w = _action_ids(want, dds_vals, dl_vals)
    np.testing.assert_array_equal(ids_g[touched], ids_w[touched])
    assert (ids_g[touched] == 0).all()
    fin = np.isfinite(want[..., :2])
    np.testing.assert_allclose(got[..., 0][fin[..., 0]],
                               want[..., 0][fin[..., 0]], rtol=COST_RTOL,
                               atol=COST_ATOL)
    np.testing.assert_allclose(got[..., 1][fin[..., 1]],
                               want[..., 1][fin[..., 1]], atol=CONSTR_ATOL,
                               rtol=0)
    tie = _tie_mask(constr_o, cost_o)
    differ = np.any(ids_g != ids_w, axis=-1)
    assert not np.any(differ & ~tie & ~touched)


def test_action_min_nan_lane_bound_matches_xla_backward():
    """The same slice with a NaN left lane bound in some reference-line
    rows: the lane-bound cost keeps it (jnp.maximum, torch.clamp), so the
    cells of those rows cost NaN in both; the rest as above."""
    dist, rl, step, rng = _world("stationary", 0)
    p = _params()
    nodes_j, _, _ = _jax_solve("xla", dist, rl, step, p, _x0(rng))
    i = LATLON_SPEC["t_steps"] - 2
    rl = rl.copy()
    rl[40:44, 5] = np.nan       # the left lane bound (dl)
    rl[80:82, 6] = np.nan       # the right lane bound (dr)
    j_solve, _ = jllk.make_latlon_solver(LATLON_SPEC, backward="xla")
    backward_slice = _closures(j_solve)["backward_slice"]
    nxt = nodes_j[i + 1].astype(np.float32)
    pp_j = {k: jnp.asarray(v, jnp.float32)
            for k, v in jllk.unpack_pp(p.packed()).items()}
    want = np.asarray(backward_slice(
        jnp.asarray(nxt), jnp.int32(i), jnp.asarray(dist, jnp.float32)[..., 0],
        jnp.asarray(rl, jnp.float32), jnp.float32(step), pp_j))
    solve, _ = tllk.make_latlon_solver(LATLON_SPEC, "cpu")
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, step, p.packed())
    tables = solve.action_tables(pp)
    got = solve.backward_slice_reference(torch.from_numpy(nxt), i, dist_x,
                                         rl_t, step_t, pp, tables).numpy()
    hit = np.isnan(want[..., 0])
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want[..., :2])
    np.testing.assert_allclose(got[..., 0][fin[..., 0]],
                               want[..., 0][fin[..., 0]], rtol=COST_RTOL,
                               atol=COST_ATOL)
    np.testing.assert_allclose(got[..., 1][fin[..., 1]],
                               want[..., 1][fin[..., 1]], atol=CONSTR_ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", ["default_21x13", "demo_1x20"])
def test_sweep_nan_lane_bounds_match_jax(case):
    """The candidate sweep with NaN left and right lane bounds in some
    reference-line rows (channels 5 / 6): the constraints keep them,
    so every candidate whose polynomial reaches those rows costs NaN, in
    the JAX ``evaluate`` and the plain version alike (the collision
    distance and the other costs as tests/test_torch_poly_chain.py holds
    them); the selection (JAX ``select_path_device``, the plain
    ``select_reference``) skips the NaN candidates and picks the same
    winner and cost."""
    jenv, tenv = _straight_env(jdpe), _straight_env(tdpe)
    lat = jplk.PolyLatParams() if case == "default_21x13" else _demo_lat()
    LD, SD = lat.l_dst_steps, lat.s_dst_steps
    start = np.array([0.4, 0.05, 0.0, 0.0, 8.0], np.float32)
    rl = np.array(jenv.grid.ref_line, np.float32)
    rl[60:64, 5] = np.nan       # the left lane bound (dl)
    rl[90:92, 6] = np.nan       # the right lane bound (dr)
    j_eval = jplk.make_poly_lat_kernel(_sweep_spec(jenv, LD, SD))
    cd_j, tc_j = j_eval(jenv.grid.occ_map, jnp.asarray(rl),
                        jnp.float32(jenv.ref_step), lat.packed(),
                        jplk.pack_env_pp(jenv.params), jnp.asarray(start))
    cd_j, tc_j = np.asarray(cd_j), np.asarray(tc_j)
    T = torch.from_numpy
    cd_t, tc_t, best_t, cost_t = tplk.sweep_select(
        tenv.grid.occ_map, T(rl), T(np.array([tenv.ref_step], np.float32)),
        T(lat.packed()), T(tplk.pack_env_pp(tenv.params)), T(start), LD, SD,
        _sweep_spec(tenv, LD, SD)["s_steps"])
    hit = np.isnan(tc_j)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(cd_t.numpy(), cd_j)
    np.testing.assert_array_equal(np.isnan(tc_t.numpy()), hit)
    np.testing.assert_allclose(tc_t.numpy()[~hit], tc_j[~hit],
                               rtol=SWEEP_RTOL, atol=0)
    il_j, isd_j, c_j = jpck.select_path_device(
        jnp.asarray(cd_j), jnp.asarray(tc_j), jnp.float32(lat.length_veh),
        LD, SD)
    assert int(best_t) == int(il_j) * SD + int(isd_j)
    assert float(cost_t) == float(c_j)
    assert not hit.reshape(-1)[int(best_t)]
