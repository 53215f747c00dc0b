"""
Mesh-sharded entry points for the planning workhorse kernels.

The port of ``tpl_tpu/parallel/kernels.py``, with the JAX signatures.  Three
fan-out patterns cover the throughput-critical work:

* ``sharded_idm_sweep`` — ONE scene, MANY candidates: the IDM rollout
  planner's candidate axis splits over the mesh, the scene (ref line,
  predicted objects, params) is copied to every device, and each device
  rolls out and evaluates only its candidate share (the port's
  ``make_idm_kernel``: on the card the two hand-written IDM kernels).
* ``sharded_latlon_batch`` — MANY scenes, one solve each: the DP lat/lon
  value iteration of a scenario batch (each with its own distance grid,
  ref line, params, start state), the batch split over the mesh.  Each
  device solves its share with the solver's scenario-batched solve
  (``solve.batch``), whose backward pass launches the fused slice kernel
  once per slice for the whole share — the counterpart of the JAX
  package's vmap of the solve.
* ``sharded_env_build`` — the DP environment grid build of a scenario
  batch: ``dp_environment._build_grids`` batched with ``torch.func.vmap``,
  every scenario's grids bit-equal to its own call.

Scenarios and candidates are independent, so no collective runs inside
these; results come back whole on the mesh's first device.
"""

import torch

from tpl_tpu_torch.parallel.mesh import _concat, _to, shard_scenarios


def _replicas(tree, mesh):
    """``tree`` on every mesh device (one copy per distinct device)."""
    copies = {}
    return [copies.setdefault(d, _to(tree, d)) for d in mesh]


def sharded_idm_sweep(kernel, mesh, axis="dp"):
    """Shard an IDM sampling kernel's candidate axis over ``mesh``.

    ``kernel`` is the ``run`` of ``idm_kernel.make_idm_kernel(spec)``;
    returns a drop-in with the same signature, ``(init_ref, init_con,
    l_trgs, d_stops, dt_replan, ref_line, ref_step, objs, pp,
    l_trg_global) -> (ref_states (C, T, 10), states (C, T, 9), costs (5,
    C))`` on the first device.  ``l_trgs`` / ``d_stops`` must have a length
    divisible by the mesh size.
    """

    def sweep(init_ref, init_con, l_trgs, d_stops, dt_replan, ref_line,
              ref_step, objs, pp, l_trg_global):
        scenes = _replicas((init_ref, init_con, dt_replan, ref_line,
                            ref_step, objs, pp, l_trg_global), mesh)
        cands = shard_scenarios((l_trgs, d_stops), mesh)
        refs, cons, costs = [], [], []
        for (l_trg, d_stop), (ir, ic, dt, rl, rs, ob, p, lg) in zip(cands,
                                                                   scenes):
            r, c, k = kernel(ir, ic, l_trg, d_stop, dt, rl, rs, ob, p, lg)
            refs.append(r)
            cons.append(c)
            costs.append(k)
        return (_concat(refs, 0, mesh[0]), _concat(cons, 0, mesh[0]),
                _concat(costs, -1, mesh[0]))

    return sweep


def sharded_latlon_batch(solve, mesh, axis="dp"):
    """Scenario-batched DP lat/lon solve, batch split over ``mesh``.

    ``solve`` is the solve of ``make_latlon_solver(spec, device)``; each
    mesh device solves its share with a solver of the same grid on that
    device.  Returns ``batch(dist_maps (B, T, S, L, 2), ref_lines (B, n,
    8), ref_step, pps (dict of (B,) values, or (B, n_pp) packed), x0s (B,
    12)) -> (nodes (B, T, S, DS, L, 4), trajs (B, T, 12))`` on the first
    device, with B divisible by the mesh size.
    """
    from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as llk

    solvers = {}
    for d in mesh:
        if d not in solvers:
            solvers[d] = (solve if d == solve.device
                          else llk.make_latlon_solver(solve.spec, d)[0])

    def batch(dist_maps, ref_lines, ref_step, pps, x0s):
        parts = shard_scenarios((dist_maps, ref_lines, pps, x0s), mesh)
        nodes, trajs = [], []
        for (dm, rl, pp, x0), d in zip(parts, mesh):
            n, t = solvers[d].batch(dm, rl, ref_step, pp, x0)
            nodes.append(n)
            trajs.append(t)
        return _concat(nodes, 0, mesh[0]), _concat(trajs, 0, mesh[0])

    return batch


def sharded_env_build(mesh, t_steps, s_steps, l_steps, axis="dp"):
    """Scenario-batched DP environment grid build, batch split over
    ``mesh``: every device rasterizes the swept prediction quads and runs
    the forward/backward distance scans for its own scenario share
    (multi-hypothesis world models, fleet evaluation).

    Returns ``build(ref_lines (B, N, 8), ref_step, quads (B, Q, 4, 2),
    tbits (B, Q), stats (B, Q), valids (B, Q), dilation, s_min, s_step,
    l_min, l_step) -> (occ (B, T, S, L), dist_lon (B, T, S, L, 2))`` on the
    first device, with B divisible by the mesh size; scalar args are shared
    across scenarios.
    """
    from tpl_tpu_torch.planning.dyn_prog.dp_environment import _build_grids

    def one(ref_line, ref_step, quads, tbit, stat, valid, dilation, s_min,
            s_step, l_min, l_step):
        return _build_grids(ref_line, ref_step, quads, tbit, stat, valid,
                            dilation, s_min, s_step, l_min, l_step, t_steps,
                            s_steps, l_steps)

    vbuild = torch.func.vmap(one, in_dims=(0, None, 0, 0, 0, 0,
                                           None, None, None, None, None))

    def scalar(v, dev):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    def build(ref_lines, ref_step, quads, tbits, stats, valids, dilation,
              s_min, s_step, l_min, l_step):
        parts = shard_scenarios((ref_lines, quads, tbits, stats, valids),
                                mesh)
        occ, dist_lon = [], []
        for (rl, q, tb, st, va), d in zip(parts, mesh):
            o, dl = vbuild(
                rl.to(torch.float32), scalar(ref_step, d), q.to(torch.float32),
                tb.to(torch.int32), st.to(torch.bool), va.to(torch.bool),
                *(scalar(v, d) for v in (dilation, s_min, s_step, l_min,
                                         l_step)))
            occ.append(o)
            dist_lon.append(dl)
        return _concat(occ, 0, mesh[0]), _concat(dist_lon, 0, mesh[0])

    return build
