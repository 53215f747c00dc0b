"""The port's FAS-2025 planner chain (poly-lat sweep -> lon DP) against the
JAX package, module by module.

Each case makes its inputs from one numpy seed and hands the same arrays to
both packages; the port runs on the CPU, where every kernel entry takes its
plain PyTorch version.  Tolerances, per case:

- splines: 1e-12 (rtol and atol) in float64, numpy and tensor inputs;
- ``project_polyline``: the segment index exactly, lengths and points to
  1e-5 (float32; XLA contracts multiply-adds);
- ``polygons_intersect`` and ``_dist_map_path``: exactly;
- lon ``solve``: each backward slice from the same next slice: node cost
  rtol=1e-6 atol=1e-3, constraint atol=1e-4, the chosen jerks as indices
  on all but 0.1 % of nodes, and those near ties (see ``_check_slice``; a
  whole solve chains the slices, and a node that a tie flips then moves
  its neighbours' values upstream, so whole solves are compared by their
  trajectories); the trajectory and ``reeval`` to atol=1e-3.  Against the exhaustive numpy
  oracle of tests/test_dp_oracle.py at its tolerances (rtol 2e-5,
  atol 2e-3) with the jerks exactly.  The JAX backward sums its (v, a)
  corners as a one-hot matrix product, the port in column order, so values
  part by ulps;
- the candidate sweep: the collision distance exactly, the cost to rtol
  1e-9 (float64; the JAX program's sums take another order), and the JAX
  dtypes recorded (collision float32, cost float64);
- the selection: exactly, host and device twins;
- ``rampify_device``: atol 1e-4 (float32; XLA contracts multiply-adds);
- the two stages from the same inputs: the winner exactly, the lateral
  points and path to 1e-4, the lon trajectory to 1e-3, the projection to
  1e-5.

The two caps kept for parity (``KEEP_CAP`` of the splice prefix,
``DpEnvironment.MAX_QUADS``) are pinned: both packages cut at the same row,
and the port warns once per process when a cap applies.
"""

import types
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpl_tpu.ops import jgeometry as jjg
from tpl_tpu.ops import splines as jsp
from tpl_tpu.planning.dyn_prog import dp_environment as jdpe
from tpl_tpu.planning.dyn_prog import lon_kernel as jlk
from tpl_tpu.planning.dyn_prog import poly_chain_kernel as jpck
from tpl_tpu.planning.dyn_prog import poly_lat_kernel as jplk
from tpl_tpu.planning.dyn_prog.poly_lat_dp_lon_planner import (
    PolyLatDpLonPlanner as JPolyLatDpLonPlanner)

import tpl_tpu_torch
from tpl_tpu_torch.ops import jgeometry as tjg
from tpl_tpu_torch.ops import splines as tsp
from tpl_tpu_torch.planning.dyn_prog import dp_environment as tdpe
from tpl_tpu_torch.planning.dyn_prog import lon_kernel as tlk
from tpl_tpu_torch.planning.dyn_prog import poly_chain_kernel as tpck
from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as tplk
from tpl_tpu_torch.planning.dyn_prog.poly_lat_dp_lon_planner import (
    PolyLatDpLonPlanner as TPolyLatDpLonPlanner)

from tests.test_dp_oracle import _lon_pp, lon_oracle_backward
from tests.test_torch_dp_environment import _both

SPLINE_TOL = 1e-12
GEOM_ATOL = 1e-5
COST_RTOL, COST_ATOL = 1e-6, 1e-3
CONSTR_ATOL = 1e-4
TRAJ_ATOL = 1e-3
MAX_TIE_SHARE = 1e-3
SWEEP_RTOL = 1e-9
RAMP_ATOL = 1e-4
PTS_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_device():
    tpl_tpu_torch.use_device("cpu")


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------
# splines

SPLINES = {
    "cubic": (3, 2),
    "quintic": (5, 3),
    "septic": (7, 4),
    "quartic": (None, None),
}


def _spline_args(name, rng, n):
    x0 = rng.uniform(-5.0, 5.0, n)
    x1 = x0 + rng.uniform(0.5, 40.0, n)
    if name == "quartic":
        return [x0, rng.normal(size=n), rng.normal(size=n),
                rng.normal(size=n), x1, rng.normal(size=n),
                rng.normal(size=n)], x0, x1
    _, nd = SPLINES[name]
    bc = [rng.normal(size=n) for _ in range(2 * nd)]
    return [x0, *bc[:nd], x1, *bc[nd:]], x0, x1


def _build(mod, name, args):
    cls = dict(cubic=mod.PolyCubic, quintic=mod.PolyQuintic,
               septic=mod.PolySeptic, quartic=mod.PolyQuartic)[name]
    return cls(*args)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("name", list(SPLINES))
def test_splines_match_jax(name, kind):
    rng = np.random.default_rng(len(name))
    n = 17
    args, x0, x1 = _spline_args(name, rng, n)
    x = x0 + (x1 - x0) * rng.uniform(-0.2, 1.2, n)
    if kind == "numpy":
        jp, tp = _build(jsp, name, args), _build(tsp, name, args)
        xj, xt = x, x
    else:
        jp = _build(jsp, name, [jnp.asarray(a) for a in args])
        tp = _build(tsp, name, [T(a, torch.float64) for a in args])
        xj, xt = jnp.asarray(x), T(x, torch.float64)
    fns = ["f", "df", "ddf", "dddf"]
    for fn in fns:
        want = np.asarray(getattr(jp, fn)(xj))
        got = getattr(tp, fn)(xt)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, want, rtol=SPLINE_TOL,
                                   atol=SPLINE_TOL, err_msg=fn)
    if name != "quartic":
        ic0, ic1 = rng.normal(size=n), rng.normal(size=n)
        for fn, ics in (("i1", (ic0,)), ("i2", (ic0, ic1))):
            want = np.asarray(getattr(jp, fn)(xj, *ics))
            if kind == "tensor":
                ics = [T(v, torch.float64) for v in ics]
            got = getattr(tp, fn)(xt, *ics)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_allclose(got, want, rtol=SPLINE_TOL,
                                       atol=SPLINE_TOL, err_msg=fn)


def test_quintic_promotes_float32_to_float64_as_jax_does():
    """The float64 Hermite inverse promotes float32 boundary values and
    queries (the JAX package runs with x64 on)."""
    args = [np.float32(v) for v in (0.0, 0.4, 0.05, 0.0, 10.0, 3.5, 0.0,
                                    0.0)]
    jp = jsp.PolyQuintic(*[jnp.float32(a) for a in args])
    tp = tsp.PolyQuintic(*[torch.tensor(a) for a in args])
    x = np.arange(12, dtype=np.float32)
    want = jp.f(jnp.asarray(x))
    got = tp.f(torch.from_numpy(x))
    assert str(want.dtype) == "float64" and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SPLINE_TOL, atol=SPLINE_TOL)


# ---------------------------------------------------------------------
# jgeometry

def test_project_polyline_matches_jax():
    rng = np.random.default_rng(7)
    s = np.cumsum(rng.uniform(0.3, 1.5, 40))
    pts = np.stack([s, 3.0 * np.sin(s / 6.0)], -1).astype(np.float32)
    pos = np.concatenate([
        pts[rng.integers(0, 40, 25)] + rng.normal(0, 1.5, (25, 2)),
        [pts[0] - [2.0, 0.3], pts[-1] + [2.0, 0.1]]]).astype(np.float32)
    want = jjg.project_polyline(jnp.asarray(pts), jnp.asarray(pos))
    got = tjg.project_polyline(torch.from_numpy(pts), torch.from_numpy(pos))
    np.testing.assert_array_equal(got["index"].numpy(),
                                  np.asarray(want["index"]))
    np.testing.assert_array_equal(got["in_bounds"].numpy(),
                                  np.asarray(want["in_bounds"]))
    assert not got["in_bounds"][-1] and not got["in_bounds"][-2]
    for k in ("arc_len", "distance", "angle", "point", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=GEOM_ATOL, err_msg=k)
    # one position, as the lon stage projects it
    one = tjg.project_polyline(torch.from_numpy(pts),
                               torch.from_numpy(pos[3]))
    assert one["arc_len"].shape == ()
    np.testing.assert_allclose(float(one["arc_len"]),
                               float(np.asarray(want["arc_len"])[3]),
                               atol=GEOM_ATOL)


def test_polygons_intersect_matches_jax():
    rng = np.random.default_rng(8)
    n = 64
    a = rng.normal(0, 1.0, (n, 4, 2)) + rng.uniform(-3, 3, (n, 1, 2))
    b = rng.normal(0, 1.0, (n, 4, 2)) + rng.uniform(-3, 3, (n, 1, 2))
    b[:4, 1] = b[:4, 0]                 # degenerate repeated vertices
    want = np.asarray(jjg.polygons_intersect(jnp.asarray(a), jnp.asarray(b)))
    got = tjg.polygons_intersect(T(a, torch.float64), T(b, torch.float64))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------
# the path distance map

def test_dist_map_path_matches_jax():
    rng = np.random.default_rng(9)
    Tn, S, L = 6, 81, 21
    occ = (rng.random((Tn, S, L)) < 0.03).astype(np.float32) \
        * rng.integers(1, 4, (Tn, S, L)).astype(np.float32)
    path_sl = np.stack([np.linspace(-1.7, 95.0, S),
                        2.5 * np.sin(np.arange(S) / 9.0) - 0.3], -1)
    path_sl = path_sl.astype(np.float32)
    scal = (0.0, 1.0, -5.0, 0.5)
    want = np.asarray(jdpe._dist_map_path(
        jnp.asarray(occ), jnp.asarray(path_sl),
        *[jnp.float32(v) for v in scal]))
    got = tdpe._dist_map_path(torch.from_numpy(occ),
                              torch.from_numpy(path_sl),
                              *[torch.tensor(np.float32(v)) for v in scal])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 1000.0).any() and (want >= 10000.0).any()


# ---------------------------------------------------------------------
# the lon DP

def _lon_scene(spec, seed, s_max=None):
    """A LonParams and seeded (path (P, 7), dist_path (T, S), x0 (7,))."""
    rng = np.random.default_rng(seed)
    p = jlk.LonParams()
    for k in ("t_steps", "s_steps", "v_steps", "a_steps", "path_steps"):
        setattr(p, k, spec[k])
    p.s_max = s_max if s_max is not None else float(spec["s_steps"] - 1)
    p.a_min, p.a_max, p.j_min, p.j_max = -3.0, 1.5, -3.0, 2.0
    p.path_step_size = p.s_max / (spec["path_steps"] - 1)
    P, S, Tn = spec["path_steps"], spec["s_steps"], spec["t_steps"]
    path = np.zeros((P, 7), np.float32)
    d = np.arange(P, dtype=np.float32) * np.float32(p.path_step_size)
    path[:, jlk.PC_X] = d
    path[:, jlk.PC_S] = d
    path[:, jlk.PC_VMAX] = np.clip(12.0 + np.cumsum(rng.normal(0, 0.5, P)),
                                   2.0, 25.0)
    path[:, jlk.PC_DIST] = d
    s = np.linspace(0.0, p.s_max, S)
    dist = np.maximum(0.0, 0.6 * p.s_max - s)[None, :] \
        + 3.0 * np.arange(Tn)[:, None] + rng.uniform(0, 0.5, (Tn, S))
    dist[:, -2:] = 10000.0
    x0 = np.array([0.0, 0.7, 7.3, 0.4, 0.0, 0.0, 0.0], np.float32)
    return p, path, dist.astype(np.float32), x0


def _jerk_index(vals, pp, n=tlk.NB):
    js = np.float32(pp.j_min) + np.float32(pp.j_max - pp.j_min) \
        * np.arange(n, dtype=np.float32) / np.float32(n - 1)
    return np.argmin(np.abs(vals[..., None] - js), axis=-1)


def _check_slice(got, want, pp, what):
    """A backward slice of the port against the JAX one computed from the
    same next slice.  The jerks agree as indices on all but MAX_TIE_SHARE
    of the nodes, and where they differ the node is a tie: its two winners'
    constraints agree to CONSTR_ATOL, and either their costs agree too or
    the constraint is active (then the lexicographic minimum is decided by
    a constraint that the two sums round apart).  Elsewhere cost and
    constraint agree to their tolerances."""
    differ = _jerk_index(got[..., 2], pp) != _jerk_index(want[..., 2], pp)
    assert differ.mean() <= MAX_TIE_SHARE, (what, differ.mean())
    d_constr = np.abs(got[..., 1] - want[..., 1])
    cost_ok = np.abs(got[..., 0] - want[..., 0]) \
        <= COST_ATOL + COST_RTOL * np.abs(want[..., 0])
    assert (d_constr <= CONSTR_ATOL).all(), what
    tie = cost_ok | (want[..., 1] > 0.0)
    assert tie[differ].all(), what
    assert cost_ok[~differ].all(), what


LON_SPECS = {
    "cut": dict(t_steps=5, s_steps=41, v_steps=13, a_steps=6, path_steps=50),
    "demo_width": dict(t_steps=10, s_steps=201, v_steps=37, a_steps=20,
                       path_steps=200),
}


@pytest.mark.parametrize("name", list(LON_SPECS))
def test_lon_solve_and_reeval_match_jax(name):
    """Every backward slice from the JAX next slice, the final slice, the
    forward pass of each package's own solve, and the reeval pass on the
    JAX nodes."""
    spec = LON_SPECS[name]
    p, path, dist, x0 = _lon_scene(spec, 11 + len(name),
                                   s_max=200.0 if name == "demo_width"
                                   else None)
    Tn, A = spec["t_steps"], spec["a_steps"]
    j_solve, j_reeval = jlk.make_lon_solver(spec)
    nodes_jp, traj_j = j_solve(jnp.asarray(dist), jnp.asarray(path),
                               p.packed(), jnp.asarray(x0))
    nodes_j = np.ascontiguousarray(np.asarray(nodes_jp)[..., :A, :])
    t_solve, t_reeval = tlk.make_lon_solver(spec)
    pp = torch.from_numpy(p.packed())
    args = (pp, torch.from_numpy(path), torch.from_numpy(dist))

    final = tlk.backward_slice_reference(torch.zeros(nodes_j.shape[1:]),
                                         *args, Tn - 1, True).numpy()
    # the final slice has no constraint channel
    assert not final[..., 1:].any()
    np.testing.assert_allclose(final, nodes_j[-1], rtol=COST_RTOL,
                               atol=COST_ATOL)
    for i in range(Tn - 2, 0, -1):
        got = tlk.backward_slice_reference(torch.from_numpy(nodes_j[i + 1]),
                                           *args, i, False).numpy()
        _check_slice(got, nodes_j[i], p, f"slice {i}")
    assert (nodes_j[1:-1, ..., 1] > 0).any()        # constraints in play

    nodes_t, traj_t = t_solve(torch.from_numpy(dist), torch.from_numpy(path),
                              pp, torch.from_numpy(x0))
    assert nodes_t.shape == nodes_j.shape and nodes_t.dtype == torch.float32
    assert not nodes_t[0].any()
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j),
                               rtol=0, atol=TRAJ_ATOL)

    traj = np.asarray(traj_j).copy()
    traj[2:, jlk.LC_J] = np.float32(p.j_min)
    want = np.asarray(j_reeval(jnp.asarray(dist), jnp.asarray(path),
                               p.packed(), jnp.asarray(traj), nodes_jp))
    got = t_reeval(torch.from_numpy(dist), torch.from_numpy(path), pp,
                   torch.from_numpy(traj), torch.from_numpy(nodes_j))
    np.testing.assert_allclose(got.numpy(), want, rtol=COST_RTOL,
                               atol=TRAJ_ATOL)


def test_lon_backward_matches_exhaustive_oracle():
    """The port's solve against the numpy oracle of tests/test_dp_oracle.py
    on its scene (its tolerances; jerks exactly)."""
    spec = dict(t_steps=4, s_steps=7, v_steps=5, a_steps=3, path_steps=8)
    pp = _lon_pp(spec)
    Tn, S = pp.t_steps, pp.s_steps
    rng = np.random.default_rng(3)
    F = np.float32
    path = np.zeros((pp.path_steps, 7), F)
    dists = np.arange(pp.path_steps, dtype=F) * F(pp.path_step_size)
    path[:, jlk.PC_X] = dists
    path[:, jlk.PC_S] = dists
    path[:, jlk.PC_VMAX] = 10.0 - 0.3 * np.arange(pp.path_steps)
    path[:, jlk.PC_DIST] = dists
    dist_path = np.maximum(0.0, 18.0 - np.arange(S, dtype=F)
                           * F(pp.s_step))[None, :] \
        + np.arange(Tn, dtype=F)[:, None] * 1.3
    dist_path = dist_path.astype(F)
    dist_path += rng.uniform(0.0, 0.1, dist_path.shape).astype(F)

    solve, _ = tlk.make_lon_solver(spec)
    nodes, _ = solve(torch.from_numpy(dist_path), torch.from_numpy(path),
                     torch.from_numpy(pp.packed()), torch.zeros(7))
    nodes = nodes.numpy()
    AL = pp.a_steps
    oracle = lon_oracle_backward(dist_path, path, pp)[..., :AL, :]
    np.testing.assert_allclose(nodes[1:, ..., 0], oracle[1:, ..., 0],
                               rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(nodes[1:, ..., 1], oracle[1:, ..., 1],
                               rtol=2e-5, atol=2e-3)
    np.testing.assert_array_equal(_jerk_index(nodes[1:Tn - 1, ..., 2], pp),
                                  _jerk_index(oracle[1:Tn - 1, ..., 2], pp))


# ---------------------------------------------------------------------
# the lateral sweep and the selection

def _straight_env(pkg, obstacle_s=40.0, half_width=6.0, obstacle_halfw=1.0):
    env = pkg.DpEnvironment()
    env.reinit_buffers(pkg.DpEnvParams())
    rl = np.zeros((401, 9))
    rl[:, 0] = np.arange(401) * 0.5
    rl[:, 3] = rl[:, 0]
    rl[:, 5] = 10.0
    rl[:, 6] = half_width
    rl[:, 7] = half_width
    env.set_ref_line(rl, 0.5)
    if obstacle_s is not None:
        w = obstacle_halfw
        quad = np.array([[obstacle_s - 2, -w], [obstacle_s + 2, -w],
                         [obstacle_s + 2, w], [obstacle_s - 2, w]])
        env.insert_geometry([(quad, t) for t in np.arange(10.0)],
                            stationary=True)
    env.update()
    return env


def _sweep_spec(env, LD, SD, S=201):
    return dict(s_steps=S, l_dst_steps=LD, s_dst_steps=SD,
                t_steps_env=env.params.t_steps,
                s_steps_env=env.params.s_steps,
                l_steps_env=env.params.l_steps)


def _demo_lat():
    """The demo planning set's lateral block (1 x 20 candidates)."""
    p = jplk.PolyLatParams()
    p.l_dst_min = p.l_dst_max = 0.0
    p.s_dst_min, p.s_dst_max = 2.0, 80.0
    p.l_dst_steps, p.s_dst_steps = 1, 20
    p.w_l, p.w_k, p.w_dl, p.w_dddl, p.w_right, p.w_len = \
        10.0, 0.0, 0.1, 10.0, 1.0, 0.0
    p.length_veh = 4.895
    return p


@pytest.mark.parametrize("case", ["default_21x13", "demo_1x20"])
def test_candidate_sweep_matches_jax_with_its_dtypes(case):
    jenv, tenv = _straight_env(jdpe), _straight_env(tdpe)
    lat = jplk.PolyLatParams() if case == "default_21x13" else _demo_lat()
    LD, SD = lat.l_dst_steps, lat.s_dst_steps
    start = np.array([0.4, 0.05, 0.0, 0.0, 8.0], np.float32)
    j_eval = jplk.make_poly_lat_kernel(_sweep_spec(jenv, LD, SD))
    cd_j, tc_j = j_eval(jenv.grid.occ_map, jenv.grid.ref_line,
                        jnp.float32(jenv.ref_step), lat.packed(),
                        jplk.pack_env_pp(jenv.params), jnp.asarray(start))
    # the JAX program's dtypes (x64 on): the collision distance float32,
    # the cost float64 (the float64 Hermite inverse promotes the quintics)
    assert (str(cd_j.dtype), str(tc_j.dtype)) == ("float32", "float64")
    t_eval = tplk.make_poly_lat_kernel(_sweep_spec(tenv, LD, SD))
    cd_t, tc_t = t_eval(tenv.grid.occ_map, tenv.grid.ref_line,
                        np.float32(tenv.ref_step), lat.packed(),
                        tplk.pack_env_pp(tenv.params), start)
    assert (cd_t.dtype, tc_t.dtype) == (torch.float32, torch.float64)
    np.testing.assert_array_equal(cd_t.numpy(), np.asarray(cd_j))
    np.testing.assert_allclose(tc_t.numpy(), np.asarray(tc_j),
                               rtol=SWEEP_RTOL, atol=0)
    # the obstacle and the limits reach the outputs
    assert (np.asarray(cd_j) < 1000.0).any()
    if LD > 1:
        assert (np.asarray(tc_j) >= 1e6).any()


def test_selection_matches_jax():
    """The host select_path and the device twin's plain version, on random
    candidate maps (as tests/test_poly_chain.py draws them) and on float64
    costs."""
    rng = np.random.default_rng(0)
    for LD, SD in ((21, 13), (1, 20)):
        for trial in range(20):
            cd = rng.uniform(0.0, 60.0, (LD, SD)).astype(np.float32)
            cd[rng.random((LD, SD)) < 0.3] = 1000.0
            tc = rng.uniform(0.0, 100.0, (LD, SD))
            tc[rng.random((LD, SD)) < 0.2] = 1e7
            want_h = jplk.select_path(cd, tc, 2.0, LD, SD)
            assert tplk.select_path(cd, tc, 2.0, LD, SD) == want_h
            il_j, isd_j, c_j = jpck.select_path_device(
                jnp.asarray(cd), jnp.asarray(tc), jnp.float32(2.0), LD, SD)
            best_t, c_t = tplk.select_reference(
                torch.from_numpy(cd), torch.from_numpy(tc),
                torch.tensor([2.0]), LD, SD)
            assert divmod(int(best_t), SD) == (int(il_j), int(isd_j))
            assert float(c_t) == float(c_j)


@pytest.mark.parametrize("case", ["default_21x13", "demo_1x20"])
def test_poly_lat_planner_update_matches_jax(case):
    """The stateful wrapper (sweep, host selection, host expansion of the
    winner) against ``PolyLatPlannerJax.update`` on the same environment:
    the points to PTS_ATOL, the cost to SWEEP_RTOL."""
    jenv, tenv = _straight_env(jdpe), _straight_env(tdpe)
    lat = jplk.PolyLatParams() if case == "default_21x13" else _demo_lat()
    tlat = tplk.PolyLatParams()
    tlat.__dict__.update(vars(lat))
    start = dict(l=0.4, dl=0.05, ddl=0.0, s=0.0, v=8.0)
    jp, tp = jplk.PolyLatPlannerJax(), tplk.PolyLatPlanner()
    jp.reinit_buffers(lat)
    tp.reinit_buffers(tlat)
    want, got = jp.update(start, jenv), tp.update(start, tenv)
    assert got.points.shape == want.points.shape == (lat.s_steps, 12)
    np.testing.assert_allclose(got.points, np.asarray(want.points), rtol=0,
                               atol=PTS_ATOL)
    np.testing.assert_allclose(got.cost, want.cost, rtol=SWEEP_RTOL, atol=0)
    # the obstacle at 40 m moves the winner off the line (21 x 13)
    if lat.l_dst_steps > 1:
        assert np.abs(got.points[:, tplk.TC_L]).max() > 0.5


def test_rampify_device_matches_jax():
    rng = np.random.default_rng(1)
    for trial in range(5):
        lim_v = rng.uniform(0.5, 15.0, 200)
        lim_v[rng.random(200) < 0.1] = 0.0          # stop cells
        step = 1.0 if trial % 2 else 0.5
        want = np.asarray(jpck.rampify_device(
            jnp.asarray(lim_v, jnp.float32), -2.0, 2.0, -2.0, 2.0, 1.0,
            step))
        one = [torch.tensor([v], dtype=torch.float32)
               for v in (-2.0, 2.0, -2.0, 2.0, 1.0, step)]
        got = tpck.rampify_device(T(lim_v), *one)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RAMP_ATOL,
                                   err_msg=f"trial {trial}")


# ---------------------------------------------------------------------
# the two stages

def _chain_spec(env, lat, lon):
    return dict(s_steps=lat.s_steps, l_dst_steps=lat.l_dst_steps,
                s_dst_steps=lat.s_dst_steps, t_steps_env=env.params.t_steps,
                s_steps_env=env.params.s_steps,
                l_steps_env=env.params.l_steps, t_steps=lon.t_steps,
                s_steps_lon=lon.s_steps, v_steps=lon.v_steps,
                a_steps=lon.a_steps, path_steps=lon.path_steps)


def _prev_trajectory(env, s0):
    prev = np.zeros((12, 12))
    prev[:, jplk.TC_S] = np.arange(12) * 1.0
    prev[:, jplk.TC_X] = env.x_offset + prev[:, jplk.TC_S]
    prev[:, jplk.TC_Y] = env.y_offset + 0.2
    prev[:, jplk.TC_L] = 0.2
    prev[:, jplk.TC_V] = 8.0
    return prev


@pytest.mark.parametrize("splice", [False, True])
def test_lat_and_lon_stages_match_jax(splice):
    jenv, tenv = _straight_env(jdpe), _straight_env(tdpe)
    lat = jplk.PolyLatParams()
    lon = jlk.LonParams()
    lon.a_steps = 20
    s0 = 6.0 if splice else 0.0
    start = np.array([0.4, 0.05, 0.0, s0, 8.0], np.float32)
    old = np.zeros((jpck.KEEP_CAP, 12), np.float32)
    n_keep = 0
    if splice:
        old, n_keep = tpck.splice_prefix(_prev_trajectory(tenv, s0), s0,
                                         tenv.x_offset, tenv.y_offset)
        assert n_keep == 6
    j_lat, j_lon = jpck.make_poly_chain(_chain_spec(jenv, lat, lon))
    out_j = j_lat(jenv.grid.occ_map, jenv.grid.ref_line,
                  jnp.float32(jenv.ref_step), lat.packed(),
                  jplk.pack_env_pp(jenv.params), lon.packed(),
                  jnp.asarray(start), jnp.asarray(old), jnp.int32(n_keep))
    t_lat, t_lon = tpck.make_poly_chain(_chain_spec(tenv, lat, lon))
    out_t = t_lat(tenv.grid.occ_map, tenv.grid.ref_line, T([tenv.ref_step]),
                  T(lat.packed()), T(tplk.pack_env_pp(tenv.params)),
                  T(lon.packed()), T(start), T(old), n_keep, T([1.0, 1.0]))
    new_j, merged_j, path_j, il_j, isd_j, cost_j = (np.asarray(a)
                                                    for a in out_j)
    new_t, merged_t, path_t, il_t, isd_t, cost_t = out_t
    assert (int(il_t), int(isd_t)) == (int(il_j), int(isd_j))
    assert float(cost_t) == pytest.approx(float(cost_j), rel=COST_RTOL)
    np.testing.assert_allclose(new_t.numpy(), new_j, rtol=0, atol=PTS_ATOL)
    fin = np.isfinite(merged_j)
    np.testing.assert_array_equal(np.isfinite(merged_t.numpy()), fin)
    np.testing.assert_allclose(merged_t.numpy()[fin], merged_j[fin], rtol=0,
                               atol=PTS_ATOL)
    np.testing.assert_allclose(path_t.numpy(), path_j, rtol=0, atol=PTS_ATOL)

    pe = jenv.params
    env_s = np.array([pe.s_min, pe.s_step_size, pe.l_min, pe.l_step_size],
                     np.float32)
    x0 = np.zeros(7, np.float32)
    x0[jlk.LC_V] = 8.0
    prev_pt = path_j[3, :2] + np.float32(0.3)
    traj_j, arc_j = j_lon(jenv.grid.occ_map, jnp.asarray(path_j),
                          jnp.asarray(env_s), lon.packed(), jnp.asarray(x0),
                          jnp.asarray(prev_pt))
    traj_t, arc_t = t_lon(tenv.grid.occ_map, torch.from_numpy(path_j.copy()),
                          T(env_s), T(lon.packed()), T(x0), T(prev_pt))
    assert float(arc_t) == pytest.approx(float(arc_j), abs=GEOM_ATOL)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), rtol=0,
                               atol=TRAJ_ATOL)
    assert np.all(traj_t.numpy()[1:-1, tlk.LC_CONSTR] < 0.1)


def test_chain_runner_replan_matches_jax():
    """The runner's one upload and one download around the two stages, on
    the demo set's lateral block."""
    jenv, tenv = _straight_env(jdpe), _straight_env(tdpe)
    lat, lon = _demo_lat(), jlk.LonParams()
    lon.a_steps = 20
    start = np.array([0.0, 0.0, 0.0, 0.0, 8.0], np.float32)
    old = np.zeros((jpck.KEEP_CAP, 12), np.float32)
    x0 = np.zeros(7)
    x0[jlk.LC_V] = 8.0
    prev = np.array([0.5, 0.1], np.float32)
    want = jpck.ChainRunner().replan(jenv, lat, lon, start, old, 0, x0, prev)
    got = tpck.ChainRunner().replan(tenv, lat, lon, start, old, 0, x0, prev)
    new_j, path_j, il_j, isd_j, cost_j, traj_j, arc_j = want
    new_t, path_t, il_t, isd_t, cost_t, traj_t, arc_t = got
    assert (il_t, isd_t) == (int(il_j), int(isd_j))
    np.testing.assert_allclose(new_t, np.asarray(new_j), atol=PTS_ATOL)
    np.testing.assert_allclose(path_t, np.asarray(path_j), atol=PTS_ATOL)
    np.testing.assert_allclose(traj_t, np.asarray(traj_j), atol=TRAJ_ATOL)
    assert float(arc_t) == pytest.approx(float(arc_j), abs=GEOM_ATOL)
    assert np.all(traj_t[1:-1, tlk.LC_CONSTR] < 0.1)


# ---------------------------------------------------------------------
# the two caps kept for parity

class _Stop(Exception):
    pass


def _splice_of(planner_cls, points, s0):
    """(old_pts, n_keep) that ``planner_cls.update_planner`` hands its
    chain, for a previous lateral trajectory ``points`` and station s0."""
    pl = planner_cls.__new__(planner_cls)
    pl.traj_lat = types.SimpleNamespace(points=points)
    pl.poly_lat_start = dict(l=0.0, dl=0.0, ddl=0.0, s=s0, v=5.0)
    pl.trajectory_np = np.zeros((5, 8))
    pl.trajectory_np[:, 0] = np.arange(5) * 0.1
    pl.dp_lon_start = np.zeros(7)
    env = types.SimpleNamespace(update=lambda: None, x_offset=3.0,
                                y_offset=-2.0)
    pl.dp_env = types.SimpleNamespace(cpp_env=env)
    seen = {}

    def replan(cppe, cpp_lat, cpp_lon, start_vec, old_pts, n_keep, *rest):
        seen.update(old_pts=np.array(old_pts), n_keep=n_keep)
        raise _Stop

    pl.chain = types.SimpleNamespace(replan=replan)
    params = types.SimpleNamespace(cpp_lat=None, cpp_lon=None, dead_time=0.0)
    with pytest.raises(_Stop):
        pl.update_planner(types.SimpleNamespace(t=0.0), params)
    return seen["old_pts"], seen["n_keep"]


def test_keep_cap_cuts_the_splice_prefix_at_the_same_row(monkeypatch):
    n = tpck.KEEP_CAP + 40
    pts = np.zeros((n + 10, 12))
    pts[:, jplk.TC_S] = np.arange(n + 10) * 0.3
    pts[:, jplk.TC_X] = pts[:, jplk.TC_S] + 3.0
    pts[:, jplk.TC_Y] = np.arange(n + 10) * 0.01
    s0 = float(pts[n, jplk.TC_S])
    assert tpck.KEEP_CAP == jpck.KEEP_CAP
    old_j, n_j = _splice_of(JPolyLatDpLonPlanner, pts, s0)
    monkeypatch.setattr(tpck, "_warned_keep_cap", False)
    with pytest.warns(RuntimeWarning, match="KEEP_CAP"):
        old_t, n_t = _splice_of(TPolyLatDpLonPlanner, pts, s0)
    assert n_t == n_j == tpck.KEEP_CAP
    np.testing.assert_array_equal(old_t, old_j)
    # the last KEEP_CAP rows below s0 are kept: the cut is at row n - cap
    np.testing.assert_allclose(old_t[0, jplk.TC_S],
                               pts[n - tpck.KEEP_CAP, jplk.TC_S], rtol=1e-6)
    # once per process
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _splice_of(TPolyLatDpLonPlanner, pts, s0)
    # below the cap nothing is cut and nothing warns
    short = pts[:20]
    s_short = float(short[-1, jplk.TC_S]) + 0.1
    assert _splice_of(TPolyLatDpLonPlanner, short, s_short)[1] == 20


def test_max_quads_cuts_the_prediction_quads_at_the_same_row(monkeypatch):
    monkeypatch.setattr(tdpe.DpEnvironment, "_warned_cap", False)
    with pytest.warns(RuntimeWarning, match="MAX_QUADS"):
        jenv, tenv = _both(seed=4, n_stat=50, n_move=200)
    Q = tdpe.DpEnvironment.MAX_QUADS
    assert Q == jdpe.DpEnvironment.MAX_QUADS
    assert len(tenv._quads) == len(jenv._quads) > Q
    for a, b in zip(jenv.device_inputs(), tenv.device_inputs()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    valid = tenv.device_inputs()[5].numpy()
    assert valid.sum() == Q and valid.all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tenv.device_inputs()
