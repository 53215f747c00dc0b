"""The graph DP planner's slice of the port against the JAX package, on the
CPU, seeded numpy inputs through both packages:

- the directional distance field (``dp_environment._dir_dist_map`` /
  ``update_dir_dist_map``), cell for cell: tests/test_dp_poly_planner.py's
  scene with and without its obstacle, seeded random occupancy at the demo
  grid (10 x 201 x 21, 21 directions), and ``ray_steps`` = 40 given to both;
- ``build_eval_graph`` at four demo start indices (two with a level capped
  at 400,000 edges), equal, and the cap's warning once per process;
- the edge evaluation (``eval_edges_reference`` against JAX
  ``make_edge_eval``) at the demo width on both levels of two start
  indices: t, ds, l and the unset fields exact; s and the cost to rtol
  EVAL_RTOL (XLA sums the 37 step costs and the coefficient products in its
  own order, with FMAs; measured on these inputs: s exact, cost 6.5e-7);
- the propagation (``propagate_reference`` against the JAX numpy
  ``propagate_and_backtrack``) on identical float64 inputs, exactly: seeded
  graphs with equal least costs in a node's range, NaN costs and nodes
  without edges, and the demo graph's own costs;
- ``DpPolyPlannerKernel.update`` against JAX on three scenes: the
  trajectory to TRAJ_RTOL (measured: 2.4e-7), with the root's two least
  edge costs more than that apart, so that no near tie passes by luck;
- the demo ``dp_poly_planner`` block loads into equal ``Params`` /
  ``DpPolyParams`` / ``DpEnvParams`` on both sides;
- ``lat_lon_kernel.HostEval`` (numpy float64 on both sides) on
  tests/test_dp_planner.py's inputs: ``eval_state`` and ``reeval`` to 1e-12.

    python -m pytest tests/test_torch_dp_poly.py -q
"""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_dp_planner import _bad_traj, _straight_env
from tests.test_dp_poly_planner import _env
from tpl_tpu import util as jutil
from tpl_tpu.planning.dyn_prog import dp_environment as jde
from tpl_tpu.planning.dyn_prog import dp_poly_planner as jdpp
from tpl_tpu.planning.dyn_prog import lat_lon_kernel as jllk
from tpl_tpu.planning.dyn_prog import poly_planner_kernel as jpk

import tpl_tpu_torch
from tpl_tpu_torch import util as tutil
from tpl_tpu_torch.planning.dyn_prog import dp_environment as tde
from tpl_tpu_torch.planning.dyn_prog import dp_poly_planner as tdpp
from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as tllk
from tpl_tpu_torch.planning.dyn_prog import poly_planner_kernel as ppk
from tpl_tpu_torch.scenes import (dp_poly_buffers, dp_poly_env, dp_poly_keys,
                                  dp_poly_propagation_case, dp_random_occ)

EVAL_RTOL = 2e-6
TRAJ_RTOL = 2e-6
HOST_TOL = 1e-12

f32 = np.float32


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on one torch thread: on a loaded host (the
    suite's parallel workers) torch's intra-op pool stalls on these large
    tensor programs, many times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_env(je):
    """The port's environment over the JAX environment's own grids (numpy
    in, CPU tensors), with the JAX field adopted."""
    te = tde.DpEnvironment()
    te.reinit_buffers(tde.DpEnvParams())
    te.ref_line, te.ref_step = je.ref_line.copy(), je.ref_step
    te.adopt_grid(torch.from_numpy(je.get_occ_map().copy()),
                  torch.from_numpy(je.get_dist_map_lon().copy()))
    te.adopt_dir_dist_map(np.asarray(je.grid.dir_dist_map))
    return te


def _jax_field(occ, ray_steps):
    p = jde.DpEnvParams()
    return np.asarray(jde._dir_dist_map(
        jnp.asarray(occ), f32(p.s_min), f32(p.s_step_size), f32(p.l_min),
        f32(p.l_step_size), f32(p.dir_min), f32(p.dir_max), f32(p.ds_max),
        p.dir_steps, ray_steps))


# ---------------------------------------------------------------------
# the directional field

@pytest.mark.parametrize("obstacle", [True, False])
def test_dir_dist_map_matches_jax_on_the_scene(obstacle):
    je = _env(obstacle)
    te = dp_poly_env(obstacle)
    np.testing.assert_array_equal(te.get_occ_map(), je.get_occ_map())
    dd = te.update_dir_dist_map()
    assert te.grid.dir_dist_map is dd and dd.dtype == torch.float32
    np.testing.assert_array_equal(dd.numpy(), np.asarray(je.grid.dir_dist_map))
    for t in (0, 9):
        np.testing.assert_array_equal(te.get_dist_map_dir(t),
                                      je.get_dist_map_dir(t))


@pytest.mark.parametrize("seed,density,ray_steps", [(0, 0.02, None),
                                                    (1, 0.1, None),
                                                    (2, 0.3, None),
                                                    (3, 0.1, 40)])
def test_dir_dist_map_matches_jax_on_random_occupancy(seed, density,
                                                      ray_steps):
    occ = dp_random_occ(seed, density=density)
    te = tde.DpEnvironment()
    te.reinit_buffers(tde.DpEnvParams())
    te.set_ref_line(np.zeros((401, 9)), 0.5)
    te.adopt_grid(torch.from_numpy(occ), None)
    R = te.ray_steps_default() if ray_steps is None else ray_steps
    assert te.ray_steps_default() == 72
    dd = te.update_dir_dist_map(ray_steps)
    np.testing.assert_array_equal(dd.numpy(), _jax_field(occ, R))


def test_ray_table_is_the_jax_programs():
    """The angles as XLA computes them (the reciprocal product contracted
    into the addition): the straight-ahead angle is 4.7e-8, not 0."""
    p = tde.DpEnvParams()
    ray, step = tde.ray_table(p.dir_min, p.dir_max, p.dir_steps,
                              p.s_step_size, p.l_step_size)
    assert step == 0.5 and ray.shape == (21, 2)
    assert 0.0 < float(ray[10, 1]) < 1e-7 and float(ray[10, 0]) == 0.5
    # the two side rays run across the road: ds a rounding of 0
    assert float(ray[0, 1]) == -0.5 and float(ray[20, 1]) == 0.5
    assert abs(float(ray[0, 0])) < 1e-7 and abs(float(ray[20, 0])) < 1e-7


def test_dir_dist_wrapper_takes_the_plain_version_on_the_cpu():
    occ = torch.from_numpy(dp_random_occ(4, T=2, S=31, L=9))
    p = tde.DpEnvParams()
    ray, step = tde.ray_table(p.dir_min, p.dir_max, 5, 1.0, 0.5)
    before = tde.dir_dist_launches
    args = (occ, ray, 0.0, 1.0, -2.0, 0.5, step)
    for R in (3, 40):
        np.testing.assert_array_equal(
            tde.dir_dist_map(*args, R).numpy(),
            tde.dir_dist_reference(*args, R).numpy())
    assert tde.dir_dist_launches == before
    with pytest.raises(ValueError):
        tde.dir_dist_map(*args, 0)
    with pytest.raises(TypeError):
        tde.dir_dist_map(occ.double(), ray, 0.0, 1.0, -2.0, 0.5, step, 3)


# ---------------------------------------------------------------------
# the graph

@pytest.mark.parametrize("key", dp_poly_keys())
def test_build_eval_graph_matches_jax(key):
    jp, tp = jpk.DpPolyParams(), ppk.DpPolyParams()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jn, je = jpk.build_eval_graph(jp, *key)
        tn, te = ppk.build_eval_graph(tp, *key)
    assert len(jn) == len(tn) == 3 and len(je) == len(te) == 2
    for a, b in zip(jn, tn):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(je, te):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b, a)
        assert np.all(np.diff(b) >= 0)
    capped = key in ((3, 10), (7, 10))
    assert (len(te[1]) == 400_000) == capped


def test_edge_cap_warns_once_per_process(monkeypatch):
    monkeypatch.setattr(ppk, "_warned_cap", False)
    with pytest.warns(RuntimeWarning, match="max_edges=400000"):
        ppk.build_eval_graph(ppk.DpPolyParams(), 3, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        _, es = ppk.build_eval_graph(ppk.DpPolyParams(), 7, 10)
    assert len(es[1]) == 400_000


def test_segment_offsets_and_layout():
    starts = np.array([0, 0, 2, 2, 2, 4], np.int32)
    np.testing.assert_array_equal(ppk.segment_offsets(starts, 6),
                                  [0, 2, 2, 5, 5, 6, 6])
    node_off, seg, seg_off = ppk.graph_layout(
        [1, 6, 6], [np.zeros(6, np.int32), starts])
    assert node_off == [0, 1, 7, 13] and seg_off == [0, 2, 9]
    np.testing.assert_array_equal(seg, [0, 6, 0, 2, 2, 5, 5, 6, 6])


# ---------------------------------------------------------------------
# the edge evaluation

def _jax_eval(je, p):
    """JAX ``make_edge_eval`` over ``je``'s grids with the JAX params ``p``,
    as the JAX driver calls it."""
    ep = je.params
    n_int = int(np.ceil((p.t_steps - 1) * p.dt / 0.25)) + 1
    fn = jpk.make_edge_eval(n_int, ep.t_steps, ep.s_steps, ep.l_steps,
                            ep.dir_steps)
    env_pp = {k: jnp.float32(getattr(ep, k)) for k in (
        "dt_start", "dt", "s_min", "s_max", "l_min", "l_max", "dir_min",
        "dir_max")}
    pp = p.dynamic_dict()

    def run(start, starts, ends, is_last):
        return np.asarray(fn(
            jnp.asarray(start), jnp.asarray(starts),
            jnp.asarray(ends, dtype=jnp.float32),
            jnp.asarray(np.full(len(starts), is_last)),
            jnp.float32((p.t_steps - 1) * p.dt), je.grid.dir_dist_map,
            je.grid.ref_line, jnp.float32(je.ref_step), pp, env_pp))
    return run


@pytest.mark.parametrize("key", [(1, 10), (7, 10)])
def test_eval_edges_reference_matches_jax(key):
    """Both levels at the demo width (level 2 of (7, 10) capped at 400,000
    edges), each fed the JAX level's own start points."""
    je = _env(True)
    te = _port_env(je)
    p = ppk.DpPolyParams()
    run = _jax_eval(je, jpk.DpPolyParams())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        node_steps, edge_steps = ppk.build_eval_graph(p, *key)
    ev = ppk.eval_params(p, te.params, f32(te.ref_step))
    start = np.zeros((1, 8), np.float32)
    start[0, ppk.PP_DS] = p.ds_min + key[0] * p.ds_step_size + 0.3
    start[0, ppk.PP_DDS] = -0.4
    start[0, ppk.PP_L] = 0.2
    start[0, ppk.PP_DL] = 0.1
    for k in range(2):
        is_last = k == 1
        want = run(start, edge_steps[k], node_steps[k + 1], is_last)
        got = ppk.eval_edges(
            torch.from_numpy(start), torch.from_numpy(edge_steps[k]),
            torch.from_numpy(node_steps[k + 1].astype(np.float32)), is_last,
            ev, te.grid.dir_dist_map, te.grid.ref_line,
            p.n_int_steps()).numpy()
        exact = [ppk.PP_T, ppk.PP_DS, ppk.PP_DDS, ppk.PP_L, ppk.PP_DL,
                 ppk.PP_DDL]
        np.testing.assert_array_equal(got[:, exact], want[:, exact])
        for c in (ppk.PP_S, ppk.PP_COST):
            np.testing.assert_allclose(got[:, c], want[:, c], rtol=EVAL_RTOL,
                                       atol=0)
        # the occupancy cost acts on some edges (the block ahead)
        assert np.ptp(want[:, ppk.PP_COST]) > 100.0
        start = want.copy()


# ---------------------------------------------------------------------
# the propagation

def _both_propagations(node_pts, edge_steps):
    """The JAX numpy function (in place on float64 copies) and the port's
    plain version on the same inputs: (JAX trajectory, JAX node costs of
    levels 0..K-1, port trajectory, port node costs)."""
    jn = [p.copy() for p in node_pts]
    j_traj = jpk.propagate_and_backtrack(jn, edge_steps, 1)
    pts, node_cost, best, seg, node_off, seg_off, traj = dp_poly_buffers(
        node_pts, edge_steps, "cpu")
    ppk.propagate_and_backtrack(pts, node_cost, best, seg, node_off, seg_off,
                                traj)
    inner = node_off[-2]
    return (j_traj, np.concatenate([p[:, ppk.PP_COST] for p in jn[:-1]]),
            traj.numpy(), node_cost.numpy()[:inner])


@pytest.mark.parametrize("seed,ties,nan", [(0, True, True), (1, True, False),
                                           (2, False, True), (3, True, True)])
def test_propagate_reference_matches_jax_exactly(seed, ties, nan):
    node_pts, edge_steps = dp_poly_propagation_case(seed, ties=ties, nan=nan)
    j_traj, j_cost, t_traj, t_cost = _both_propagations(node_pts, edge_steps)
    np.testing.assert_array_equal(t_traj, j_traj)
    np.testing.assert_array_equal(t_cost, j_cost)
    assert np.isinf(t_cost[1:]).any()
    assert np.isnan(t_cost).any() == nan


def test_propagate_reference_matches_jax_on_the_demo_graph():
    je = _env(True)
    p = jpk.DpPolyParams()
    run = _jax_eval(je, p)
    node_steps, edge_steps = jpk.build_eval_graph(p, 2, 10)
    start = np.zeros((1, 8), np.float32)
    start[0, ppk.PP_DS] = 5.0
    pts = [start]
    for k in range(2):
        pts.append(run(pts[k], edge_steps[k], node_steps[k + 1], k == 1))
    node_pts = [np.asarray(x, np.float64) for x in pts]
    j_traj, j_cost, t_traj, t_cost = _both_propagations(node_pts, edge_steps)
    np.testing.assert_array_equal(t_traj, j_traj)
    np.testing.assert_array_equal(t_cost, j_cost)


# ---------------------------------------------------------------------
# the kernel driver

@pytest.mark.parametrize("obstacle,ds0,l0", [(True, 8.0, 0.4),
                                             (False, 8.0, 0.0),
                                             (True, 20.0, 1.0)])
def test_kernel_update_matches_jax(obstacle, ds0, l0):
    je = _env(obstacle)
    te = _port_env(je)
    init = np.zeros(8)
    init[ppk.PP_DS], init[ppk.PP_L], init[ppk.PP_DDS] = ds0, l0, 0.3
    jk, tk = jpk.DpPolyPlannerKernel(), ppk.DpPolyPlannerKernel()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jk.update(init, je)
        got = tk.update(init, te)
    assert got.shape == (3, 8) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)
    # row 0 is the float32 start state in float64
    np.testing.assert_array_equal(got[0, :7], init.astype(np.float32)[:7])
    costs = np.sort(tk.root_edge_costs())
    assert costs[1] - costs[0] > 2 * TRAJ_RTOL * abs(costs[1]), costs[:2]
    # on the CPU nothing was launched
    assert ppk.eval_launches == ppk.propagate_launches == 0


def test_kernel_keeps_graphs_per_start_index():
    te = _port_env(_env(True))
    k = ppk.DpPolyPlannerKernel()
    p = ppk.DpPolyParams()
    p.ds_steps, p.l_steps = 8, 9
    k.reinit_buffers(p)
    init = np.zeros(8)
    init[ppk.PP_DS] = 8.0
    a = k.update(init, te)
    assert list(k._graphs) == [k.start_key(init)]
    init[ppk.PP_DS] = 20.0
    k.update(init, te)
    init[ppk.PP_DS] = 8.0
    np.testing.assert_array_equal(k.update(init, te), a)
    assert len(k._graphs) == 2
    q = ppk.DpPolyParams()
    q.ds_steps, q.l_steps = 8, 7
    k.reinit_buffers(q)
    assert k._graphs == {}


# ---------------------------------------------------------------------
# parameters

def _fields(obj, prefix=""):
    out = {}
    for k, v in vars(obj).items():
        if hasattr(v, "__dict__") and not isinstance(v, type):
            out.update(_fields(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_demo_param_block_lands_equal():
    def load(util, mod):
        data = util.load_state_dict(util.resolve_data("params",
                                                      "planning/demo"))
        p = mod.Params()
        util.merge_into(p, data["dp_poly_planner"]["params"])
        return p

    jp, tp = load(jutil, jdpp), load(tutil, tdpp)
    fa, fb = _fields(jp), _fields(tp)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert type(fa[k]) is type(fb[k]), k
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    assert isinstance(tp.dp_planner, ppk.DpPolyParams)
    assert isinstance(tp.dp_env, tde.DpEnvParams)
    assert (tp.dp_planner.ds_steps, tp.dp_env.dir_steps) == (15, 21)
    for a, b in ((jpk.DpPolyParams(), ppk.DpPolyParams()),
                 (jde.DpEnvParams(), tde.DpEnvParams())):
        assert _fields(a) == _fields(b)


# ---------------------------------------------------------------------
# HostEval

def _host_evals():
    env = _straight_env()
    cpp = jllk.LatLonParams()
    solver, _ = jllk.make_latlon_solver(dict(
        t_steps=10, s_steps=201, ds_steps=37, l_steps=21))
    x0 = np.zeros(12, np.float32)
    x0[jllk.C_DS] = 8.0
    _, traj = solver(env.grid.dist_map_lon, env.grid.ref_line,
                     jnp.float32(0.5), cpp.dynamic_dict(), jnp.asarray(x0))
    traj = np.asarray(traj, dtype=np.float64)
    tp = tllk.LatLonParams()
    for k in vars(cpp):
        setattr(tp, k, getattr(cpp, k))
    dist, rl = env.get_dist_map_lon(), env.ref_line
    return (jllk.HostEval(dist, rl, 0.5, cpp),
            tllk.HostEval(torch.from_numpy(dist.copy()), rl, 0.5, tp), traj)


def test_host_eval_matches_jax():
    jh, th, traj = _host_evals()
    for cand in (traj, _bad_traj(traj)):
        for i in range(len(cand)):
            for dt in (0.0, 0.5, 1.0):
                a, b = jh.eval_state(cand[i], dt), th.eval_state(cand[i], dt)
                np.testing.assert_allclose(b, a, rtol=HOST_TOL, atol=HOST_TOL)
        want, got = jh.reeval(cand), th.reeval(cand)
        np.testing.assert_allclose(got, want, rtol=HOST_TOL, atol=HOST_TOL)
    # the bad trajectory re-evaluates as infeasible on both sides
    assert np.any(th.reeval(_bad_traj(traj))[:, tllk.C_CONSTR] > 0.0)
