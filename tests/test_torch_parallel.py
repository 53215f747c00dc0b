"""The port's scale-out layer (``tpl_tpu_torch.parallel``) against the JAX
package's, on the CPU: the counterparts of tests/test_parallel.py.  Each
sharded function runs on a mesh of 8 CPU entries and is held against the
JAX function on the 8 virtual devices tests/conftest.py sets up, on the
same inputs made from a seed with numpy.

Tolerances: the IDM sweep's rollouts and costs rtol = atol = 1e-5 (the JAX
test's, and the port's IDM parity tolerance: the two packages' sin / cos /
atan may part by an ulp); the DP batch's trajectories rtol = atol = 1e-5
(the JAX test's), bit for bit against the port's per-scenario solves; the
env build's occupancy bit for bit and its distances rtol = 1e-6 (the JAX
test's) against JAX, both bit for bit against the port's own per-scenario
calls; the best-candidate reduction exact.  Also:
the port's rebuilt flagship MPC inputs equal to ``__graft_entry__``'s
``_mpc_setup``; ``dryrun_multichip`` on a two-entry CPU mesh; two gloo
processes joined by ``init_distributed`` (``file://`` init, no sockets)
reducing their minimum with ``ReduceOp.MIN``.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
import jax
import jax.numpy as jnp

from tpl_tpu import parallel as jpar

import tpl_tpu_torch
from tpl_tpu_torch import parallel
from tpl_tpu_torch.parallel import (scenario_mesh, shard_scenarios,
                                    sharded_best_candidate)

RTOL = ATOL = 1e-5
ENV_RTOL = 1e-6
N = 8


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


def test_mesh_and_sharding():
    mesh = scenario_mesh(N)
    assert mesh == (torch.device("cpu"),) * N
    assert len(jpar.scenario_mesh(N).devices) == N

    batch = torch.arange(16.0).reshape(16, 1)
    shards = shard_scenarios(batch, mesh)
    assert len(shards) == N and all(s.shape == (2, 1) for s in shards)
    assert torch.equal(shards.gather(), batch)
    np.testing.assert_array_equal(
        shards.gather().numpy(),
        np.asarray(jpar.shard_scenarios(jnp.asarray(batch.numpy()),
                                        jpar.scenario_mesh(N))))
    # trees: dicts and tuples of arrays split leaf by leaf
    tree = shard_scenarios(dict(a=np.arange(8.0), b=(torch.ones(8, 2),)),
                           scenario_mesh(4))
    assert [t["a"].tolist() for t in tree] == [[0., 1.], [2., 3.], [4., 5.],
                                               [6., 7.]]
    assert tree[3]["b"][0].shape == (2, 2)
    with pytest.raises(ValueError):
        scenario_mesh(0)


def test_mesh_on_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="cards"):
        scenario_mesh(1, device="cuda")


def test_sharded_best_candidate_reduction():
    def batched_solve(x0):
        # toy per-scenario "solve": cost = squared distance to 3
        return x0 * 2.0, (x0[:, 0] - 3.0) ** 2

    x0 = np.arange(16.0).reshape(16, 1)
    out, costs, best = sharded_best_candidate(batched_solve,
                                              scenario_mesh(N))(
        torch.from_numpy(x0))
    j_out, j_costs, j_best = jpar.sharded_best_candidate(
        lambda a: (a * 2.0, (a[:, 0] - 3.0) ** 2),
        jpar.scenario_mesh(N))(jnp.asarray(x0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(costs.numpy(), np.asarray(j_costs))
    # global best = scenario x0 == 3 -> cost 0, reduced across devices
    assert float(best) == float(j_best) == 0.0
    with pytest.raises(ValueError, match="divide"):
        sharded_best_candidate(batched_solve, scenario_mesh(N))(
            torch.zeros(12, 1))


def test_mpc_setup_matches_graft_entry():
    """The port's rebuilt flagship MPC inputs are ``_mpc_setup``'s."""
    import __graft_entry__ as ge

    _, state, x0, params, cfg = ge._mpc_setup(dtype=jnp.float64)
    prob, t_params, t_cfg, t_x0 = parallel.mpc_setup(torch.float64)
    assert prob.name == "trajectory_tracking_mpc"
    assert set(t_params) == set(params) and set(t_cfg) == set(cfg)
    for k in params:
        np.testing.assert_array_equal(t_params[k].numpy(),
                                      np.asarray(params[k]), err_msg=k)
    for k in cfg:
        np.testing.assert_array_equal(np.asarray(t_cfg[k]),
                                      np.asarray(cfg[k]), err_msg=k)
    np.testing.assert_array_equal(t_x0.numpy(), np.asarray(x0))
    assert np.asarray(state.x).shape == (61, prob.nx)


def test_dryrun_multichip_on_a_cpu_mesh(monkeypatch):
    """The four parts on two CPU mesh entries, the DP grid's ds axis cut
    to 5 (the env build's grid, and so the DP's T x S x L, stays
    10 x 201 x 21)."""
    from tpl_tpu_torch.parallel import dryrun

    monkeypatch.setattr(dryrun, "LATLON_SPEC", dict(
        dryrun.LATLON_SPEC, ds_steps=5))
    res = parallel.dryrun_multichip(2, device="cpu")
    assert res["devices"] == 2 and np.isfinite(res["best"])
    assert np.isfinite(res["idm_best"]) and res["s_end"] > 10.0
    assert res["n_occ"] > 0
    assert set(res["seconds"]) == {"mpc", "idm", "latlon", "env_build"}


def _idm_inputs():
    from tests.test_idm_kernel import _scene

    rl, objs, pp, init_ref, init_con = _scene()
    C = 64
    l_trgs = np.linspace(-3, 3, C).astype(np.float32)
    d_stops = np.full(C, 1e6, np.float32)
    return rl, objs, pp, init_ref, init_con, l_trgs, d_stops


def test_sharded_idm_sweep_matches_jax():
    """Candidate axis sharded over 8 mesh entries == the JAX sweep over 8
    virtual devices, and == the port's unsharded kernel (on the CPU an ulp
    apart at some elements: torch's vectorised CPU math rounds a batch of
    8 candidates and one of 64 differently)."""
    from tpl_tpu.planning.idm_sampling import idm_kernel as jidk
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk

    rl, objs, pp, init_ref, init_con, l_trgs, d_stops = _idm_inputs()
    spec = dict(steps_t=20, n_ref=rl.shape[0], n_obj=4, n_pred=8, n_hull=8)
    j_sweep = jpar.sharded_idm_sweep(jidk.make_idm_kernel(spec),
                                     jpar.scenario_mesh(N))
    j_refs, j_cons, j_costs = j_sweep(
        jnp.asarray(init_ref), jnp.asarray(init_con), jnp.asarray(l_trgs),
        jnp.asarray(d_stops), jnp.float32(0.1), jnp.asarray(rl),
        jnp.float32(0.5), {k: jnp.asarray(v) for k, v in objs.items()},
        pp.dynamic_dict(), jnp.float32(0.0))

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    ppv = torch.from_numpy(np.array([getattr(pp, k) for k in idk.PP_KEYS],
                                    np.float32))
    args = (t(init_ref), t(init_con), t(l_trgs), t(d_stops), t([0.1]), t(rl),
            t([0.5]), idk.objs_to_torch(objs, "cpu"), ppv, t([0.0]))
    kernel = idk.make_idm_kernel(spec)
    refs, cons, costs = parallel.sharded_idm_sweep(kernel,
                                                   scenario_mesh(N))(*args)
    u_refs, u_cons, u_costs = kernel(*args)
    assert costs.shape == (len(idk.COST_KEYS), 64)
    for got, want in ((refs, u_refs), (cons, u_cons), (costs, u_costs)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)

    np.testing.assert_allclose(refs.numpy(), np.asarray(j_refs), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(cons.numpy(), np.asarray(j_cons), rtol=RTOL,
                               atol=ATOL)
    for k, got in idk.costs_dict(costs).items():
        np.testing.assert_allclose(np.asarray(got), np.asarray(j_costs[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_sharded_latlon_batch_matches_jax():
    """Scenario-batched DP value iteration over 8 mesh entries, a
    per-scenario ``l_trg``, start speed and obstacle, == the JAX batch over
    8 virtual devices and == the port's per-scenario solves bit for
    bit."""
    from tpl_tpu.planning.dyn_prog import lat_lon_kernel as jllk
    from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as llk
    from tests.test_dp_planner import _straight_env

    spec = dict(t_steps=10, s_steps=201, ds_steps=9, l_steps=21)
    j_solver, _ = jllk.make_latlon_solver(spec)
    env_free = _straight_env(obstacle=False)
    env_blk = _straight_env(obstacle=True)
    dms, rls, pps, x0s = [], [], [], []
    for i in range(N):
        env = env_blk if i % 2 else env_free
        dms.append(np.asarray(env.grid.dist_map_lon))
        rls.append(np.asarray(env.grid.ref_line))
        pp = jllk.LatLonParams()
        pp.l_trg = (i - 4) * 0.25
        pps.append(pp.dynamic_dict())
        x0 = np.zeros(12, np.float32)
        x0[jllk.C_DS] = 4.0 + i * 0.5
        x0s.append(x0)
    dms, rls, x0s = np.stack(dms), np.stack(rls), np.stack(x0s)
    pps_np = {k: np.stack([np.asarray(p[k]) for p in pps]) for k in pps[0]}

    _, j_trajs = jpar.sharded_latlon_batch(j_solver, jpar.scenario_mesh(N))(
        jnp.asarray(dms), jnp.asarray(rls), jnp.float32(0.5),
        jax.tree.map(jnp.asarray, pps_np), jnp.asarray(x0s))

    solver, _ = llk.make_latlon_solver(spec, "cpu")
    nodes, trajs = parallel.sharded_latlon_batch(solver, scenario_mesh(N))(
        dms, rls, 0.5, pps_np, x0s)
    assert nodes.shape == (N, 10, 201, 9, 21, 4) and trajs.shape == (N, 10,
                                                                      12)
    np.testing.assert_allclose(trajs.numpy(), np.asarray(j_trajs), rtol=RTOL,
                               atol=ATOL)
    for i in (0, 5):
        n_i, traj_i = solver(dms[i], rls[i], 0.5,
                             {k: v[i] for k, v in pps_np.items()}, x0s[i])
        assert torch.equal(trajs[i], traj_i) and torch.equal(nodes[i], n_i)
    # the scenarios differ: the obstacle and l_trg move the plans
    assert not torch.equal(trajs[0], trajs[1])
    # reference lines of another row count in one batch
    with pytest.raises(ValueError, match="row count"):
        solver.batch(dms[:2], [rls[0], rls[1][:-1]], 0.5,
                     {k: v[:2] for k, v in pps_np.items()}, x0s[:2])


def test_sharded_env_build_matches_jax():
    """Scenario-batched DP env grid build over 8 mesh entries == the JAX
    build over 8 virtual devices (occupancy bit for bit), and each scenario
    bit for bit the port's per-scenario ``_build_grids``."""
    from tpl_tpu_torch.planning.dyn_prog.dp_environment import _build_grids

    T, S, L, NR, Q, B = 6, 101, 11, 221, 8, 8
    rng = np.random.default_rng(3)

    ref_lines = np.zeros((B, NR, 8), np.float32)
    ref_lines[:, :, 0] = np.arange(NR) * 0.5          # x
    ref_lines[:, :, 2] = 0.05 * rng.normal(size=(B, 1))  # heading
    ref_lines[:, :, 4] = 4.0                          # d_left
    ref_lines[:, :, 5] = 4.0                          # d_right

    quads = np.zeros((B, Q, 4, 2), np.float32)
    base = np.array([[0., -1.], [3., -1.], [3., 1.], [0., 1.]], np.float32)
    for b in range(B):
        for q in range(Q):
            off = np.array([10.0 + 9 * q + 2 * b, (q % 3 - 1) * 2.0],
                           np.float32)
            quads[b, q] = base + off
    tbits = rng.integers(0, T, size=(B, Q)).astype(np.int32)
    stats = rng.random((B, Q)) < 0.3
    valids = rng.random((B, Q)) < 0.8
    scal = (np.float32(0.5), np.float32(1.0), np.float32(0.0),
            np.float32(1.0), np.float32(-5.0), np.float32(1.0))
    ref_step, rest = scal[0], scal[1:]

    j_occ, j_dist = jpar.sharded_env_build(jpar.scenario_mesh(N), T, S, L)(
        ref_lines, ref_step, quads, tbits, stats, valids, *rest)
    occ, dist = parallel.sharded_env_build(scenario_mesh(N), T, S, L)(
        ref_lines, ref_step, quads, tbits, stats, valids, *rest)
    assert occ.shape == (B, T, S, L) and dist.shape == (B, T, S, L, 2)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist),
                               rtol=ENV_RTOL)
    f = lambda a: torch.as_tensor(a)
    for b in range(B):
        occ_u, dist_u = _build_grids(
            f(ref_lines[b]), f(ref_step), f(quads[b]), f(tbits[b]),
            f(stats[b]), f(valids[b]), *map(f, rest), T, S, L)
        assert torch.equal(occ[b], occ_u) and torch.equal(dist[b], dist_u)
    assert (occ == 3.0).any() and (occ == 1.0).any()


def test_init_distributed_reduces_over_two_gloo_processes(tmp_path):
    """Two processes join a gloo group by ``file://`` init; each solves a
    batch whose costs differ per rank over a two-entry mesh, and
    ``sharded_best_candidate`` returns the minimum over both ranks."""
    from tests import torch_dist_worker

    assert parallel.init_distributed(None) is False
    ctx = tmp.spawn(torch_dist_worker.best_candidate_rank,
                    args=(str(tmp_path / "init"), str(tmp_path), 2),
                    nprocs=2, join=False)
    deadline = time.monotonic() + 60.0
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two ranks did not finish within 60 s")
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    # rank 0's batch is 10 .. 17 (least cost 49), rank 1's 0 .. 7 (0)
    assert [r["local"] for r in res] == [49.0, 0.0]
    assert [r["best"] for r in res] == [0.0, 0.0]
    assert all(r["backend"] == "gloo" and r["doubled"] for r in res)
