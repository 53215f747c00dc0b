"""The port's lat/lon DP solve and its action-min against the JAX package.

Inputs are made from a numpy seed and handed to both packages; the JAX
solve runs with its XLA backward and, in interpret mode, with its Pallas
action-min kernel.  The port runs on the CPU, where ``action_min`` takes
its plain PyTorch version.

Tolerances: node cost rtol=1e-6, atol=1e-3 (costs are of order 1e3-1e4
and the XLA and Pallas JAX backwards differ by up to ~5e-4 on the CPU);
node constraint atol=1e-4; the chosen (dds, dl) action exactly, except on
tie cells, where the two best actions' (constr, cost) lie within those
tolerances; such cells that do pick another action are at most 0.1 % of
cells.  Trajectory atol=1e-3.  The action
sample values themselves may differ by an ulp: XLA on the CPU contracts
multiply-add into FMA, so the samples are compared as action indices.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpl_tpu.planning.dyn_prog import lat_lon_kernel as jllk
from tpl_tpu.planning.dyn_prog.dp_environment import (
    DpEnvironment as JDpEnvironment, DpEnvParams as JDpEnvParams)

import tpl_tpu_torch
from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as tllk
from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam

COST_RTOL, COST_ATOL = 1e-6, 1e-3
CONSTR_ATOL = 1e-4
TRAJ_ATOL = 1e-3
MAX_TIE_SHARE = 1e-3

SPEC = dict(t_steps=6, s_steps=61, ds_steps=9, l_steps=11)


@pytest.fixture(autouse=True)
def _cpu_device():
    tpl_tpu_torch.use_device("cpu")


def _params():
    p = jllk.LatLonParams()
    p.s_max, p.s_steps = 60.0, SPEC["s_steps"]
    p.ds_max, p.ds_steps = 16.0, SPEC["ds_steps"]
    p.l_steps, p.t_steps = SPEC["l_steps"], SPEC["t_steps"]
    p.dds_max = 1.5
    p.w_l = 10.0
    p.time_gap, p.gap_min, p.length_veh = 1.5, 1.0, 4.895
    return p


def _box(s0, s1, l0, l1):
    return np.array([[s0, l0], [s1, l0], [s1, l1], [s0, l1]], float)


def _world(layout, seed):
    """JAX-side DP environment on a straight road for one obstacle
    layout; returns (dist_map_lon, ref_line, ref_step) as numpy."""
    rng = np.random.default_rng(seed)
    ep = JDpEnvParams()
    ep.t_steps, ep.s_steps, ep.l_steps = (SPEC["t_steps"], SPEC["s_steps"],
                                          SPEC["l_steps"])
    ep.s_max, ep.dilation = 60.0, 1.3
    env = JDpEnvironment()
    env.reinit_buffers(ep)
    n_ref = 160
    rl = np.zeros((n_ref, 9))
    rl[:, 0] = np.arange(n_ref) * 0.5
    rl[:, 3] = rl[:, 0]
    rl[:, 5] = rng.uniform(9.0, 14.0)
    half = 1.6 if layout == "narrow" else 4.0
    rl[:, 6] = half
    rl[:, 7] = half
    env.set_ref_line(rl, 0.5)
    if layout == "stationary":
        s0 = rng.uniform(25.0, 40.0)
        l0 = rng.uniform(-1.5, 0.5)
        env.insert_geometry([(_box(s0, s0 + 4.0, l0, l0 + 2.0), t)
                             for t in np.arange(6.0)], stationary=True)
    elif layout == "moving":
        s0, v = rng.uniform(12.0, 20.0), rng.uniform(3.0, 7.0)
        l0 = rng.uniform(-1.0, 0.0)
        env.insert_geometry([(_box(s0 + v * t, s0 + v * t + 4.5, l0,
                                   l0 + 1.8), t) for t in np.arange(6.0)],
                            stationary=False)
    else:  # narrow road with a parked car at the edge
        s0 = rng.uniform(30.0, 45.0)
        env.insert_geometry([(_box(s0, s0 + 4.0, 0.6, 2.5), t)
                             for t in np.arange(6.0)], stationary=True)
    env.update()
    return (np.asarray(env.grid.dist_map_lon), np.asarray(env.ref_line),
            0.5, rng)


def _x0(rng):
    x0 = np.zeros(12, np.float32)
    x0[jllk.C_DS] = rng.uniform(4.0, 10.0)
    x0[jllk.C_L] = rng.uniform(-0.8, 0.8)
    return x0


def _jax_solve(backward, dist, rl, step, p, x0):
    solve, reeval = jllk.make_latlon_solver(SPEC, backward=backward)
    nodes, traj = solve(jnp.asarray(dist), jnp.asarray(rl),
                        jnp.float32(step), p.packed(), jnp.asarray(x0))
    return np.asarray(nodes), np.asarray(traj), reeval


def _action_ids(nodes, dds_vals, dl_vals):
    """Node channels 2, 3 -> (dds, dl) sample indices; the samples are
    >= 0.5 apart, so nearest-sample is exact up to rounding noise."""
    dds = np.abs(nodes[..., 2:3] - np.asarray(dds_vals)).argmin(-1)
    dl = np.abs(nodes[..., 3:4] - np.asarray(dl_vals)).argmin(-1)
    for ch, ids, vals in ((2, dds, dds_vals), (3, dl, dl_vals)):
        np.testing.assert_allclose(nodes[..., ch], np.asarray(vals)[ids],
                                   atol=1e-6, rtol=0)
    return np.stack([dds, dl], -1)


def _tie_mask(constr_o, cost_o):
    """Cells whose best and second-best actions are within tolerance."""
    c = constr_o.numpy().astype(np.float64)
    v = cost_o.numpy().astype(np.float64)
    cmin = c.min(axis=-1, keepdims=True)
    vm = np.where(c == cmin, v, np.inf)
    best = vm.argmin(axis=-1)[..., None]
    cb = np.take_along_axis(c, best, -1)
    vb = np.take_along_axis(v, best, -1)
    others = np.ones_like(c, bool)
    np.put_along_axis(others, best, False, -1)
    near_c = np.abs(c - cb) <= CONSTR_ATOL
    near_v = np.abs(v - vb) <= COST_ATOL + COST_RTOL * np.abs(vb)
    tie = others & near_c & ((c != cb) | near_v)
    return tie.any(axis=-1)


def _samples(p):
    pp = tllk.unpack_pp(torch.from_numpy(p.packed()))
    return lam.dds_samples(pp).numpy(), lam.dl_samples(pp).numpy()


def _compare_slices(nodes_ref, dist, rl, step, p):
    """Run the port's action-min on the reference's next-slice nodes
    and hold every backward slice against the reference."""
    solve, _ = tllk.make_latlon_solver(SPEC, "cpu")
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, step, p.packed())
    tables = solve.action_tables(pp)
    n_cells = n_flips = 0
    for i in range(SPEC["t_steps"] - 2, 0, -1):
        nxt = torch.from_numpy(nodes_ref[i + 1].astype(np.float32))
        ins = solve.slice_inputs(i, dist_x, rl_t, step_t, pp)
        got, constr_o, cost_o = lam.action_min_reference(
            nxt, *ins, tables, return_actions=True)
        np.testing.assert_array_equal(
            got.numpy(), lam.action_min(nxt, *ins, tables).numpy())
        got = got.numpy()
        want = nodes_ref[i]
        np.testing.assert_allclose(got[..., 0], want[..., 0],
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_allclose(got[..., 1], want[..., 1],
                                   atol=CONSTR_ATOL, rtol=0)
        tie = _tie_mask(constr_o, cost_o)
        differ = np.any(_action_ids(got, tables["dds_vals"],
                                    tables["dl_vals"])
                        != _action_ids(want, tables["dds_vals"],
                                       tables["dl_vals"]), axis=-1)
        assert not np.any(differ & ~tie), (
            f"slice {i}: {int(np.sum(differ & ~tie))} non-tie cells pick "
            "another action")
        n_cells += tie.size
        n_flips += int(np.sum(differ))
    assert n_flips <= MAX_TIE_SHARE * n_cells, (n_flips, n_cells)


CASES = [("stationary", 0), ("stationary", 1), ("moving", 2),
         ("moving", 3), ("narrow", 4)]


@pytest.mark.parametrize("layout,seed", CASES)
def test_action_min_matches_xla_backward(layout, seed):
    dist, rl, step, rng = _world(layout, seed)
    p = _params()
    nodes, _, _ = _jax_solve("xla", dist, rl, step, p, _x0(rng))
    _compare_slices(nodes, dist, rl, step, p)


@pytest.mark.parametrize("layout,seed", CASES)
def test_solve_matches_xla_backward(layout, seed):
    dist, rl, step, rng = _world(layout, seed)
    p = _params()
    x0 = _x0(rng)
    nodes_j, traj_j, reeval_j = _jax_solve("xla", dist, rl, step, p, x0)
    solve, reeval = tllk.make_latlon_solver(SPEC, "cpu")
    nodes_t, traj_t = solve(dist, rl, step, p.packed(), x0)
    nodes_t, traj_t = nodes_t.numpy(), traj_t.numpy()

    assert nodes_t.shape == nodes_j.shape and traj_t.shape == traj_j.shape
    np.testing.assert_allclose(nodes_t[..., 0], nodes_j[..., 0],
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(nodes_t[..., 1], nodes_j[..., 1],
                               atol=CONSTR_ATOL, rtol=0)
    dds_vals, dl_vals = _samples(p)
    # slices 0 and T-1 carry no action
    np.testing.assert_array_equal(nodes_t[[0, -1], ..., 2:], 0.0)
    np.testing.assert_array_equal(
        _action_ids(nodes_t[1:-1], dds_vals, dl_vals),
        _action_ids(nodes_j[1:-1], dds_vals, dl_vals))
    np.testing.assert_allclose(traj_t, traj_j, atol=TRAJ_ATOL,
                               rtol=COST_RTOL)

    # re-evaluation of a stored (and a perturbed) trajectory
    bad = traj_j.astype(np.float64).copy()
    bad[:, jllk.C_S] = np.linspace(10.0, 50.0, len(bad))
    bad[:, jllk.C_L] = np.linspace(-1.0, 1.5, len(bad))
    bad[:, jllk.C_DL] = 0.5
    for cand in (traj_j.astype(np.float64), bad):
        want = np.asarray(reeval_j(jnp.asarray(dist), jnp.asarray(rl),
                                   jnp.float32(step), p.packed(),
                                   jnp.asarray(cand)))
        got = reeval(dist, rl, step, p.packed(), cand).numpy()
        np.testing.assert_allclose(got, want, atol=TRAJ_ATOL,
                                   rtol=COST_RTOL)


@pytest.mark.parametrize("layout,seed", [("stationary", 7), ("moving", 8),
                                         ("narrow", 9)])
def test_backward_slice_matches_xla_backward(layout, seed):
    """``backward_slice`` (on the CPU its plain version,
    ``backward_slice_reference``: the slice's producers and the action-min
    in one call) on the JAX solve's next-slice nodes against the JAX
    ``backward_slice`` (``backward="xla"``), slice by slice; tolerances as
    for the solve."""
    dist, rl, step, rng = _world(layout, seed)
    p = _params()
    nodes_j, _, _ = _jax_solve("xla", dist, rl, step, p, _x0(rng))
    solve, _ = tllk.make_latlon_solver(SPEC, "cpu")
    dist_x, rl_t, step_t, pp = solve.prepare(dist, rl, step, p.packed())
    tables = solve.action_tables(pp)
    dds_vals, dl_vals = _samples(p)
    n_cells = n_flips = 0
    for i in range(SPEC["t_steps"] - 2, 0, -1):
        nxt = torch.from_numpy(nodes_j[i + 1].astype(np.float32))
        got = solve.backward_slice(nxt, i, dist_x, rl_t, step_t, pp, tables)
        ref = solve.backward_slice_reference(nxt, i, dist_x, rl_t, step_t,
                                             pp, tables)
        assert torch.equal(got, ref)
        ins = solve.slice_inputs(i, dist_x, rl_t, step_t, pp)
        assert torch.equal(got, lam.action_min(nxt, *ins, tables))
        got, want = got.numpy(), nodes_j[i]
        np.testing.assert_allclose(got[..., 0], want[..., 0],
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_allclose(got[..., 1], want[..., 1],
                                   atol=CONSTR_ATOL, rtol=0)
        n_cells += got[..., 0].size
        n_flips += int(np.sum(np.any(
            _action_ids(got, dds_vals, dl_vals)
            != _action_ids(want, dds_vals, dl_vals), axis=-1)))
    assert n_flips <= MAX_TIE_SHARE * n_cells, (n_flips, n_cells)


def test_fused_slice_launch_needs_the_card_and_made_tables():
    """The fused kernel's launch wrapper has no plain version of its own:
    a CPU tensor raises (``backward_slice`` dispatches before it), and so do
    tables that carry no slice constants."""
    S, DS, L = 5, 3, 4
    pp = tllk.unpack_pp(torch.from_numpy(tllk.LatLonParams().packed()))
    tb = lam.make_tables(pp, torch.arange(DS, dtype=torch.float32),
                         torch.tensor(1.0), torch.tensor(1.0),
                         torch.tensor(1.0), DS)
    assert tb.slice_consts.shape == (len(lam.SLICE_CONSTS),)
    assert tb.slice_consts[lam.SLICE_CONSTS.index("w_l")] == pp["w_l"]
    assert lam.Tables(dict(tb)).slice_consts is None
    with pytest.raises(ValueError, match="CUDA"):
        lam.backward_slice_launch(torch.zeros((S, DS, L, 4)),
                                  torch.zeros((S, L)), torch.zeros((9, 8)),
                                  torch.tensor(0.5), 1, tb)


@pytest.mark.parametrize("layout,seed", [("stationary", 5), ("moving", 6)])
def test_matches_pallas_backward(layout, seed):
    """The JAX package's TPU kernel (interpret mode on the CPU) is held
    against the port slice by slice and over the whole solve."""
    dist, rl, step, rng = _world(layout, seed)
    p = _params()
    x0 = _x0(rng)
    nodes_p, traj_p, _ = _jax_solve("pallas", dist, rl, step, p, x0)
    _compare_slices(nodes_p, dist, rl, step, p)

    solve, _ = tllk.make_latlon_solver(SPEC, "cpu")
    nodes_t, traj_t = solve(dist, rl, step, p.packed(), x0)
    np.testing.assert_allclose(nodes_t.numpy()[..., 0], nodes_p[..., 0],
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(traj_t.numpy(), traj_p, atol=TRAJ_ATOL,
                               rtol=COST_RTOL)


def test_action_tables_round_half_even():
    """Shift tables round half to even before the int cast, as
    jnp.round does: with s_step = 1 and dt = 1, ds = 0.5 and dds = 0
    gives an s change of exactly 0.5 cells -> shift 0, and 2.5 -> 2."""
    p = tllk.LatLonParams()
    p.s_max, p.s_steps = 60.0, 61
    p.ds_max, p.ds_steps = 4.0, 9              # ds grid step 0.5
    p.dds_min, p.dds_max = -3.0, 3.0           # dds sample 3 is 0.0
    pp = tllk.unpack_pp(torch.from_numpy(p.packed()))
    dss = pp["ds_min"] + torch.arange(9, dtype=torch.float32) * 0.5
    tb = lam.make_tables(pp, dss, torch.tensor(1.0), torch.tensor(0.5),
                         torch.tensor(1.0), 9)
    assert tb["ks"][1, 3].item() == 0          # 0.5 -> 0
    assert tb["ks"][3, 3].item() == 2          # 1.5 -> 2
    assert tb["ks"][5, 3].item() == 2          # 2.5 -> 2
    # +inf slopes (zero s change, nonzero l change) saturate to FLT_MAX
    assert tb["ca"][0, 3, 1].item() == np.finfo(np.float32).max
    assert tb["ca"][0, 3, 0].item() == 0.0


def test_kernel_wrapper_rejects_bad_inputs():
    S, DS, L = 5, 3, 4
    nodes = torch.zeros((S, DS, L, 4))
    sc = torch.zeros((S, DS, L))
    dfwd = torch.zeros((S, L, lam.NB))
    p = tllk.LatLonParams()
    pp = tllk.unpack_pp(torch.from_numpy(p.packed()))
    tb = lam.make_tables(pp, torch.arange(DS, dtype=torch.float32),
                         torch.tensor(1.0), torch.tensor(1.0),
                         torch.tensor(1.0), DS)
    with pytest.raises(ValueError):
        lam.action_min(nodes, sc, sc, torch.zeros((S, L, 5)), tb)
    with pytest.raises(TypeError):
        lam.action_min(nodes.double(), sc, sc, dfwd, tb)
    with pytest.raises(ValueError):
        lam.action_min(nodes, sc.transpose(0, 1).contiguous()
                       .transpose(0, 1), sc, dfwd, tb)


def test_action_tables_are_checked_once_when_made():
    """``make_tables`` returns checked :class:`Tables` that carry their
    device pointers; a wrong table raises where the tables are made, and a
    launch checks them only against the grid it is given."""
    S, DS, L = 5, 3, 4
    pp = tllk.unpack_pp(torch.from_numpy(tllk.LatLonParams().packed()))
    tb = lam.make_tables(pp, torch.arange(DS, dtype=torch.float32),
                         torch.tensor(1.0), torch.tensor(1.0),
                         torch.tensor(1.0), DS)
    assert isinstance(tb, lam.Tables) and tb.DS == DS
    assert tb.ptrs == tuple(tb[k].data_ptr() for k in lam.TABLE_KEYS)
    bad = dict(tb)
    bad["ks"] = tb["ks"].float()
    with pytest.raises(TypeError):
        lam.Tables(bad)
    bad = dict(tb)
    bad["ca"] = tb["ca"][:, :, :5]
    with pytest.raises(ValueError):
        lam.Tables(bad)
    # a plain dict is checked (and wrapped) on the call
    nodes = torch.zeros((S, DS, L, 4))
    sc = torch.zeros((S, DS, L))
    dfwd = torch.zeros((S, L, lam.NB))
    assert torch.equal(lam.action_min(nodes, sc, sc, dfwd, dict(tb)),
                       lam.action_min(nodes, sc, sc, dfwd, tb))
    # tables of another ds grid
    with pytest.raises(ValueError):
        lam.action_min(torch.zeros((S, DS + 1, L, 4)),
                       torch.zeros((S, DS + 1, L)),
                       torch.zeros((S, DS + 1, L)), dfwd, tb)
