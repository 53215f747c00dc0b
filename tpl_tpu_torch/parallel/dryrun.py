"""
The sharded planning / control step suite over a mesh: the port's
``dryrun_multichip`` (the counterpart of ``__graft_entry__.py``'s, which
imports JAX) and the flagship tracking-MPC inputs it shares with the
scale-out example.

    python -c "from tpl_tpu_torch.parallel import dryrun_multichip; \\
        dryrun_multichip(1)"

runs on the card (every visible card up to ``n_devices``); with
``device="cpu"`` on ``n_devices`` CPU mesh entries.
"""

import time

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch.parallel.kernels import (sharded_env_build,
                                            sharded_idm_sweep,
                                            sharded_latlon_batch)
from tpl_tpu_torch.parallel.mesh import scenario_mesh, sharded_best_candidate

# the vendored DP planner's grid (data/params/planning/demo/state.json)
LATLON_SPEC = dict(t_steps=10, s_steps=201, ds_steps=37, l_steps=21)
# scenarios a mesh device takes in each part
MPC_PER_DEVICE = 4
LATLON_PER_DEVICE = 8
ENV_PER_DEVICE = 4
IDM_PER_DEVICE = 16


def mpc_setup(dtype=torch.float32, horizon=60, max_iterations=8,
              device=None):
    """The flagship tracking MPC (``__graft_entry__.py``'s ``_mpc_setup``:
    its course, weights, limits and start, rebuilt here): ``(prob, params,
    cfg, x0)`` with ``params`` a dict of tensors, ``cfg`` the ``cfg`` of
    ``ilqr.make_update_fn`` / ``batched.make_batched_update_fn`` (HEUN is
    the integrator it is solved with) and ``x0`` (7,), on ``device``
    (``tpl_tpu_torch.device()`` unless given)."""
    from tpl_tpu_torch.optim import problems

    dev = tpl_tpu_torch.device() if device is None else torch.device(device)
    prob, _ = problems.trajectory_tracking_mpc(ref_capacity=128)

    ss = np.arange(128) * 0.5
    ref_y = 2.0 * np.sin(ss * 0.1)
    dy = np.gradient(ref_y, ss)
    phi = np.arctan(dy)
    params = {
        "pd": 10.0, "pv": 5.0, "pdelta": 0.0, "min_pdelta_dot": 0.1,
        "pdelta_dot": 0.0, "min_p_phi_dot": 0.0, "p_phi_dot": 0.0,
        "p_phi": 0.01, "p_phi_ref_dot_diff": 0.01, "pa": 2.0, "pj": 0.5,
        "l": 3.165, "v_ch": 32.0,
        "ref_x": ss, "ref_y": ref_y, "ref_phi": phi,
        "ref_k": np.gradient(phi, ss), "ref_v": np.full(128, 8.0),
        "ref_step": 0.5, "max_delta": 0.7, "max_acc": 3.0,
        "min_acc": -3.0, "a_offset": 0.0,
    }

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64)).to(dev, dtype)

    params = {k: t(v) for k, v in params.items()}
    cfg = {
        "u_min": t(np.tile([[-3.0, -1.0]], (horizon, 1))),
        "u_max": t(np.tile([[1.5, 1.0]], (horizon, 1))),
        "barrier_weight": t(np.full(4, 1e4)),
        "lg_mult_limit": t(np.full(4, 1e30)),
        "dt": t(0.05),
        "T": horizon,
        "max_iterations": max_iterations,
        "max_lg_iterations": 1,
        "min_rel_cost_change": t(1e-6),
    }
    x0 = t([0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0])
    return prob, params, cfg, x0


def mpc_batched_solve(prob, params, cfg, horizon, dtype):
    """``batched_solve(bx0 (B, 7)) -> (u0 (B, 2), traj_costs (B,))``
    of :func:`~tpl_tpu_torch.parallel.mesh.sharded_best_candidate`: the
    batched tracking MPC from a zero warm start on ``bx0``'s device (on the
    card the batched kernel), ``params`` / ``cfg`` copied there once."""
    from tpl_tpu_torch.optim import batched, ilqr
    from tpl_tpu_torch.parallel.mesh import _to

    on = {}

    def solve(bx0):
        dev, B = bx0.device, bx0.shape[0]
        if dev not in on:
            on[dev] = (_to(params, dev), _to(cfg, dev))
        p, c = on[dev]
        update = batched.make_batched_update_fn(prob, horizon, B, ilqr.HEUN,
                                                dtype)
        x, u, lam, mu = batched.init_batch(prob, horizon, B, dtype, dev)
        xs, u, lam, mu, costs = update(x, u, lam, mu, bx0.T.contiguous(), p,
                                       c)
        return u[0].T, costs

    return solve


def _sync(mesh):
    for d in set(mesh):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _timed(mesh, fn):
    """(fn(), host seconds ending in a synchronize of the mesh's cards)."""
    _sync(mesh)
    t0 = time.perf_counter()
    res = fn()
    _sync(mesh)
    return res, time.perf_counter() - t0


def _dryrun_mpc(mesh, horizon=60, max_iterations=8):
    """The flagship tracking MPC (horizon 60, 8 AL-iLQR iterations, HEUN,
    float32) batched over the mesh, ``MPC_PER_DEVICE`` scenarios a device
    with starts ``x0 + 0.01 b``, and the cross-device best cost."""
    dtype = torch.float32
    prob, params, cfg, x0 = mpc_setup(dtype, horizon, max_iterations,
                                      mesh[0])
    B = MPC_PER_DEVICE * len(mesh)
    bx0 = (x0[None, :] + 0.01 * torch.arange(B, dtype=dtype,
                                             device=mesh[0])[:, None])
    solve = sharded_best_candidate(
        mpc_batched_solve(prob, params, cfg, horizon, dtype), mesh)
    (_, costs, best), secs = _timed(mesh, lambda: solve(bx0))
    return float(best), secs


def _dryrun_idm_sweep(mesh, steps=100):
    """The IDM rollout planner's candidate fan (``IDM_PER_DEVICE`` a
    device) over the mesh, 100-step rollouts on ``__graft_entry__.py``'s
    IDM dryrun scene (``scenes.idm_scene``, the same numbers); the best
    summed cost."""
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk

    rl, objs, pp, init_ref, init_con = scenes.idm_scene()
    O, PRED, K = objs["hull_preds"].shape[:3]
    kernel = idk.make_idm_kernel(dict(steps_t=steps, n_ref=rl.shape[0],
                                      n_obj=O, n_pred=PRED, n_hull=K))
    sweep = sharded_idm_sweep(kernel, mesh)

    dev = mesh[0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    C = IDM_PER_DEVICE * len(mesh)
    args = (f32(init_ref), f32(init_con),
            f32(np.linspace(-3, 3, C)), f32(np.full(C, 1e6)), f32([0.1]),
            f32(rl), f32([0.5]), idk.objs_to_torch(objs, dev),
            f32(pp.packed()), f32([0.0]))
    (refs, cons, costs), secs = _timed(mesh, lambda: sweep(*args))
    return float(torch.min(costs.sum(0))), secs


def latlon_scene(device, n_ref=401):
    """``__graft_entry__.py``'s DP lat/lon dryrun scene on the port's
    ``DpEnvironment``, its grids built on ``device``: a straight 200 m road,
    10 m/s, 4 m to each side, a stationary 4 x 2 m block at s 68-72 m in
    every slice.  Returns (dist_map_lon (T, S, L, 2), ref_line (n, 8))."""
    from tpl_tpu_torch.planning.dyn_prog.dp_environment import (
        DpEnvironment, DpEnvParams, _build_grids)

    p = DpEnvParams()
    env = DpEnvironment()
    env.reinit_buffers(p)
    rl = np.zeros((n_ref, 9))
    rl[:, 0] = np.arange(n_ref) * 0.5
    rl[:, 3] = rl[:, 0]
    rl[:, 5] = 10.0
    rl[:, 6:8] = 4.0
    env.set_ref_line(rl, 0.5)
    env.insert_geometry(
        [(np.array([[68., -1.], [72., -1.], [72., 1.], [68., 1.]]), t)
         for t in np.arange(10.0)], stationary=True)
    inputs = env.device_inputs(device)
    _, dist = _build_grids(*inputs, p.t_steps, p.s_steps, p.l_steps)
    return dist, inputs[0]


def _dryrun_latlon(mesh):
    """The DP lat/lon value iteration at the vendored planner's grid
    (``LATLON_SPEC``, 10 x 201 x 37 x 21), ``LATLON_PER_DEVICE`` scenarios a
    device with starts ``ds = 6 + 0.25 b``; every plan free of constraint
    violations; the furthest end station."""
    from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as llk
    from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam

    solver, _ = llk.make_latlon_solver(LATLON_SPEC, mesh[0])
    batch = sharded_latlon_batch(solver, mesh)
    dist, rl = latlon_scene(mesh[0])
    B = LATLON_PER_DEVICE * len(mesh)
    dms = dist[None].expand((B,) + dist.shape)
    rls = rl[None].expand((B,) + rl.shape)
    pps = torch.as_tensor(np.tile(llk.LatLonParams().packed(), (B, 1)))
    x0 = np.zeros((B, 12), np.float32)
    x0[:, llk.C_DS] = 6.0 + 0.25 * np.arange(B)
    before = lam.batch_launches
    (_, trajs), secs = _timed(mesh, lambda: batch(dms, rls, 0.5, pps,
                                                  torch.from_numpy(x0)))
    launches = lam.batch_launches - before
    trajs = trajs.cpu().numpy()
    if not np.all(trajs[:, :, llk.C_CONSTR] == 0.0):
        raise AssertionError("latlon dryrun produced constraint-violating "
                             "plans")
    return float(np.max(trajs[:, -1, llk.C_S])), secs, launches


def _dryrun_env_build(mesh):
    """The DP environment grid build at the 10 x 201 x 21 grid,
    ``ENV_PER_DEVICE`` scenarios a device of 16 seeded quads each; the
    occupied cells."""
    T, S, L, NR, Q = 10, 201, 21, 401, 16
    B = ENV_PER_DEVICE * len(mesh)
    rng = np.random.default_rng(1)

    ref_lines = np.zeros((B, NR, 8), np.float32)
    ref_lines[:, :, 0] = np.arange(NR) * 0.5
    ref_lines[:, :, 4:6] = 4.0
    base = np.array([[0., -1.], [4., -1.], [4., 1.], [0., 1.]], np.float32)
    quads = (base[None, None]
             + rng.uniform(10, 180, size=(B, Q, 1, 1)).astype(np.float32)
             * np.array([1.0, 0.0], np.float32))
    tbits = rng.integers(0, T, size=(B, Q)).astype(np.int32)
    stats = np.zeros((B, Q), bool)
    valids = np.ones((B, Q), bool)

    build = sharded_env_build(mesh, T, S, L)
    (occ, _), secs = _timed(mesh, lambda: build(
        ref_lines, 0.5, quads, tbits, stats, valids, 1.0, 0.0, 1.0, -5.0,
        0.5))
    n_occ = int((occ.cpu() > 0).sum())
    if n_occ <= 0:
        raise AssertionError("env-build dryrun rasterized nothing")
    return n_occ, secs


def dryrun_multichip(n_devices, device=None):
    """Run the full sharded planning / control step suite over a mesh of
    ``n_devices`` (cards unless ``device="cpu"``) at flagship
    configurations:

    1. tracking MPC, horizon 60 x 8 AL-iLQR iterations, scenario batch
       sharded with a cross-device best-cost reduction;
    2. IDM sampling planner, 100-step rollouts, candidate fan sharded;
    3. DP lat/lon value iteration at the vendored planner's 10 x 201 x 37 x
       21 grid, scenario batch sharded, the fused slice launched once per
       slice for a device's whole share;
    4. DP environment grid build (rasterization + distance scans),
       scenario batch sharded.

    Prints a line per part with its host wall time (ending in a
    synchronize) and returns them: a dict of the parts' results and
    ``seconds``.
    """
    mesh = scenario_mesh(n_devices, device=device)

    best, t_mpc = _dryrun_mpc(mesh)
    if not np.isfinite(best):
        raise AssertionError("multichip dryrun produced non-finite cost")
    print(f"MULTICHIP MPC OK best_cost={best:.4f} "
          f"scenarios={MPC_PER_DEVICE * len(mesh)} wall_s={t_mpc:.3f}")

    idm_best, t_idm = _dryrun_idm_sweep(mesh)
    if not np.isfinite(idm_best):
        raise AssertionError("IDM sweep produced non-finite cost")
    print(f"MULTICHIP IDM OK best_cost={idm_best:.4f} "
          f"candidates={IDM_PER_DEVICE * len(mesh)} wall_s={t_idm:.3f}")

    s_end, t_latlon, slices = _dryrun_latlon(mesh)
    if not s_end > 10.0:
        raise AssertionError("latlon dryrun made no progress")
    print(f"MULTICHIP LATLON OK s_end={s_end:.2f} "
          f"scenarios={LATLON_PER_DEVICE * len(mesh)} batched_slice_launches="
          f"{slices} wall_s={t_latlon:.3f}")

    n_occ, t_env = _dryrun_env_build(mesh)
    print(f"MULTICHIP ENVBUILD OK occ_cells={n_occ} "
          f"scenarios={ENV_PER_DEVICE * len(mesh)} wall_s={t_env:.3f}")

    print(f"MULTICHIP OK best={best:.4f} devices={len(mesh)}")
    return dict(best=best, idm_best=idm_best, s_end=s_end, n_occ=n_occ,
                latlon_slice_launches=slices, devices=len(mesh),
                seconds=dict(mpc=t_mpc, idm=t_idm, latlon=t_latlon,
                             env_build=t_env))
