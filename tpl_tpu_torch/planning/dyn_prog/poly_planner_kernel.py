"""
Graph/polynomial DP planner kernel: a precomputed DAG of (t, ds, l)
maneuver nodes whose edges are evaluated by fitting quartic-longitudinal +
quintic-lateral polynomial connections and integrating jerk / velocity /
lateral / occupancy costs, followed by backward cost propagation and a
backtrack.
(reference: library/src/dyn_prog/poly_planner.cu; the JAX package's form is
tpl_tpu/planning/dyn_prog/poly_planner_kernel.py)

The graph is built on the host (numpy, rate-feasibility pruning, cached
per (ds, l) start index) and uploaded once per start index; a replan is
one upload of the 8-float start state, ``eval_steps`` edge evaluations
(two launches each), one propagation launch and one download of the
(eval_steps + 1, 8) trajectory.  Every level's end points stay on
the device.  On a CUDA tensor the two entries are the hand-written kernels
of ``csrc/poly_planner.cu``: :func:`eval_edges` (``poly_eval_edges``: the
field's slice straight ahead gathered, then a thread per edge that takes
only the steps it needs) and :func:`propagate_and_backtrack`
(``poly_propagate``, one launch: the blocks share the last level, a warp a
node, and the last block to finish takes the lower levels and the
backtrack); on a CPU tensor their plain PyTorch versions
:func:`eval_edges_reference` and :func:`propagate_reference`.

The device layout: the nodes of all levels are rows of one (N, 8) float32
table ``pts`` (row 0 the start state, then level 1's nodes, one per edge of
level 0, and so on; ``node_off[k]`` is level k's first row), each level's
edges are a slice of ``edge_starts`` (int32, the start node's index within
its level, non-decreasing, so a node's edges are one contiguous range) and
of ``end_specs`` ((E, 3) float32 [t, ds, l]); ``seg`` holds each level's
per-node edge offsets (n_k + 1 entries at ``seg_off[k]``).  The
propagation writes the float64 propagated cost of every node of levels
0..K-1 (``node_cost``) and its best edge (``best``, int32, the edge's index
within its level: the index of the next level's node).

Arithmetic follows the JAX program: float32 edge evaluation (the
coefficient products summed in index order, the R integration steps summed
in step order, each operation rounded on its own), float64 propagation (a
node's cost plus the least cost among its edges, the first edge among
equal costs, a NaN cost wins as in ``np.argmin``, +inf and edge 0 for a
node without edges).  XLA's own order and FMA contraction of the
coefficient products and sums part from these by rounding
(tests/test_torch_dp_poly.py states the tolerance).
"""

import ctypes
import warnings

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.ops.splines import _HERMITE_INV, _M4_INV
from tpl_tpu_torch.planning.dyn_prog.lon_kernel import _check

eval_launches = 0       # kernel launches since import (reset freely)
propagate_launches = 0
# kernels a level's evaluation launches: the field's slice straight ahead,
# then the evaluation
EVAL_KERNELS = 2

# point fields: t, s, ds, dds, l, dl, ddl, cost
PP_T, PP_S, PP_DS, PP_DDS, PP_L, PP_DL, PP_DDL, PP_COST = range(8)

DT_INT = 0.25           # the integration step along an edge (s)
MAX_LEVELS = 8          # eval_steps the propagation kernel takes
# edges the plain evaluation takes at once (its (edges, steps) temporaries
# stay small; values do not depend on it)
PLAIN_CHUNK = 1 << 14

# the edge evaluation's scalars, one float32 vector (csrc/poly_planner.cu
# EvalParams, in this order)
EVAL_KEYS = ("w_j", "w_l", "w_v_diff", "length_veh", "t_horizon",
             "ref_step", "dt_start", "dt", "s_min", "s_max", "l_min",
             "l_max", "dir_min", "dir_max")

_warned_cap = False


class DpPolyParams:
    """(reference: poly_planner.cuh:8-52)"""

    def __init__(self):
        self.eval_steps = 2

        self.t_steps = 10
        self.s_steps = 201
        self.ds_steps = 15
        self.l_steps = 21

        self.s_min = 0.0
        self.s_max = 200.0
        self.ds_min = 0.0
        self.ds_max = 36.0
        self.dds_min = -3.0
        self.dds_max = 3.0
        self.l_min = -5.0
        self.l_max = 5.0
        self.dl_min = -2.0
        self.dl_max = 2.0
        self.dt = 1.0
        self.dt_start = 1.0
        self.dt_cart = 0.1

        self.a_total_max = 3.0
        self.a_lat_abs_max = 3.0

        self.w_v_diff = 1.0
        self.w_l = 1.0
        self.w_j = 1.0

        self.width_veh = 0.0
        self.length_veh = 0.0

    @property
    def ds_step_size(self):
        return (self.ds_max - self.ds_min) / (self.ds_steps - 1)

    @property
    def l_step_size(self):
        return (self.l_max - self.l_min) / (self.l_steps - 1)

    def n_int_steps(self):
        """The integration steps of an edge: the horizon at DT_INT, both
        ends included."""
        return int(np.ceil((self.t_steps - 1) * self.dt / DT_INT)) + 1


def eval_params(params, env_params, ref_step):
    """The float32 vector of :data:`EVAL_KEYS` from the planner's and the
    environment's params."""
    p, ep = params, env_params
    vals = dict(w_j=p.w_j, w_l=p.w_l, w_v_diff=p.w_v_diff,
                length_veh=p.length_veh,
                t_horizon=np.float32((p.t_steps - 1) * p.dt),
                ref_step=ref_step, dt_start=ep.dt_start, dt=ep.dt,
                s_min=ep.s_min, s_max=ep.s_max, l_min=ep.l_min,
                l_max=ep.l_max, dir_min=ep.dir_min, dir_max=ep.dir_max)
    return np.array([vals[k] for k in EVAL_KEYS], np.float32)


def build_eval_graph(params, idx_ds_start, idx_l_start, max_edges=400_000):
    """Vectorized DAG construction with rate-feasibility pruning.

    (reference: poly_planner.cu:237-302 buildEvalGraph). Returns per step:
    node_specs (N, 3) [t, ds, l], edge_start_idx (E,) int32. Step k+1's
    nodes are step k's edges (one end node per edge, as in the reference).
    A level of more than ``max_edges`` edges keeps its first ``max_edges``
    (start-major order), as the JAX package does; the first cut in a
    process warns.
    """
    global _warned_cap
    p = params
    ds_vals = p.ds_min + np.arange(p.ds_steps) * p.ds_step_size
    l_vals = p.l_min + np.arange(p.l_steps) * p.l_step_size
    t_vals = np.arange(p.t_steps) * p.dt

    start = np.array([[0.0,
                       p.ds_min + idx_ds_start * p.ds_step_size,
                       p.l_min + idx_l_start * p.l_step_size]])

    node_steps = [start]
    edge_steps = []

    for _ in range(p.eval_steps):
        nodes = node_steps[-1]                    # (N, 3) [t, ds, l]
        # candidate ends: all (t_end > t_start, ds_end, l_end)
        te = t_vals[None, :, None, None]          # (1, T, 1, 1)
        de = ds_vals[None, None, :, None]
        le = l_vals[None, None, None, :]

        t0 = nodes[:, 0][:, None, None, None]
        d0 = nodes[:, 1][:, None, None, None]
        l0 = nodes[:, 2][:, None, None, None]

        tc = te - t0
        dsc = de - d0
        lc = le - l0
        feasible = ((tc > 1e-6)
                    & (dsc >= p.dds_min * tc) & (dsc <= p.dds_max * tc)
                    & (lc >= p.dl_min * tc) & (lc <= p.dl_max * tc))

        idx = np.argwhere(feasible)               # (E, 4)
        if len(idx) > max_edges:
            if not _warned_cap:
                _warned_cap = True
                warnings.warn(f"build_eval_graph: {len(idx)} edges in one "
                              f"level, only the first max_edges={max_edges} "
                              "are kept (as in the JAX package)",
                              RuntimeWarning, stacklevel=2)
            idx = idx[:max_edges]

        starts = idx[:, 0].astype(np.int32)
        # argwhere is start-major: each node's edges are one contiguous
        # range, which the propagation reads by offsets
        assert np.all(np.diff(starts) >= 0), "edge starts must not decrease"
        ends = np.column_stack([
            t_vals[idx[:, 1]], ds_vals[idx[:, 2]], l_vals[idx[:, 3]]])

        edge_steps.append(starts)
        node_steps.append(ends)

    return node_steps, edge_steps


def segment_offsets(starts, n_nodes):
    """Each node's first edge and the level's end: (n_nodes + 1,) int32
    (``starts`` non-decreasing)."""
    return np.append(np.searchsorted(starts, np.arange(n_nodes)),
                     len(starts)).astype(np.int32)


_INV32 = (np.asarray(_M4_INV, np.float32), np.asarray(_HERMITE_INV[5],
                                                      np.float32))


def inverses_f32():
    """The quartic's (5 x 5) and the quintic's (6 x 6) inverse matrices as
    float32, the constants both the kernel and the plain version use."""
    return _INV32


# ---------------------------------------------------------------------
# plain versions (any device)


def _coeffs(b, inv):
    """c[m] = sum_k b[k] * inv[m, k] in float32, k in index order."""
    out = []
    for m in range(inv.shape[0]):
        acc = b[0] * float(inv[m, 0])
        for k in range(1, inv.shape[1]):
            acc = acc + b[k] * float(inv[m, k])
        out.append(acc)
    return out


def _poly_eval(c, u, deriv, order):
    """The deriv-th u-derivative of sum_k c[k] u^k (Horner from 0.0, each
    operation rounded on its own)."""
    acc = 0.0
    for k in range(order, deriv - 1, -1):
        fac = float(np.prod(np.arange(k - deriv + 1, k + 1)))
        acc = acc * u + c[k] * fac
    return acc


def eval_edges_reference(start_pts, edge_starts, end_specs, is_last, ev,
                         dir_dist, ref_line, n_int):
    """End points (E, 8) float32 of one level's edges (the plain version;
    reference: poly_planner.cu:11-108 evalEdge, the JAX package's
    ``make_edge_eval.eval_edges``): per edge the quartic lon fit (start s,
    ds, dds to the end ds) and the quintic lat fit (start l, dl, ddl to the
    end l, at rest), integrated at DT_INT over ``n_int`` steps: the squared
    jerks up to the end time, then the speed, speed-limit and directional
    occupancy costs up to the end time (the horizon on the last level),
    plus the lateral offset; t, s, ds, l and the cost set, dds, dl and ddl
    0.  ``start_pts`` (Ns, 8), ``end_specs`` (E, 3) float32,
    ``edge_starts`` (E,) int32, ``ev`` the host vector of
    :data:`EVAL_KEYS`, ``dir_dist`` (T, S, L, D), ``ref_line`` (N, 8)
    (column 4 the speed limit) float32 on one device."""
    E = edge_starts.shape[0]
    out = torch.zeros((E, 8), dtype=torch.float32, device=start_pts.device)
    for lo in range(0, E, PLAIN_CHUNK):
        hi = min(E, lo + PLAIN_CHUNK)
        out[lo:hi] = _eval_chunk(start_pts, edge_starts[lo:hi],
                                 end_specs[lo:hi], is_last, ev, dir_dist,
                                 ref_line, n_int)
    return out


def _eval_chunk(start_pts, edge_starts, end_specs, is_last, ev, dir_dist,
                ref_line, n_int):
    f32 = torch.float32
    dev = start_pts.device
    pp = {k: torch.tensor(ev[i], dtype=f32, device=dev)
          for i, k in enumerate(EVAL_KEYS)}
    T, S, L, D = dir_dist.shape
    n_ref = ref_line.shape[0]
    m4, h5 = inverses_f32()
    sp = start_pts[edge_starts.long()]                       # (E, 8)
    t0 = sp[:, PP_T]
    te, dse, le = end_specs[:, 0], end_specs[:, 1], end_specs[:, 2]
    d = te - t0
    zero = torch.zeros_like(t0)
    c_lon = _coeffs([sp[:, PP_S], sp[:, PP_DS] * d, sp[:, PP_DDS] * d * d,
                     dse * d, zero], m4)
    c_lat = _coeffs([sp[:, PP_L], sp[:, PP_DL] * d, sp[:, PP_DDL] * d * d,
                     le, zero, zero], h5)
    d3 = d * (d * d)
    one = torch.ones_like(t0)
    s_end = _poly_eval(c_lon, one, 0, 4)
    ds_end = _poly_eval(c_lon, one, 1, 4) / d
    l_end = _poly_eval(c_lat, one, 0, 5)
    t_end_eval = pp["t_horizon"] if is_last else te
    # the lookups' constant parts (dir_dist_lookup at dir = 0)
    s_span, l_span = pp["s_max"] - pp["s_min"], pp["l_max"] - pp["l_min"]
    di = int(torch.clamp(torch.round((0.0 - pp["dir_min"])
                                     / (pp["dir_max"] - pp["dir_min"])
                                     * (D - 1)), 0, D - 1))
    field = dir_dist[..., di]                                # (T, S, L)
    v_col = ref_line[:, 4]

    # all integration steps at once: (E, R), the coefficients as columns
    ts = t0[:, None] + torch.arange(n_int, dtype=f32, device=dev) * DT_INT
    u = torch.clamp((ts - t0[:, None]) / d[:, None], 0.0, 1.0)
    in_poly = ts <= te[:, None]
    cl, ct = [c[:, None] for c in c_lon], [c[:, None] for c in c_lat]
    zero_r = torch.zeros_like(ts)
    jl = _poly_eval(cl, u, 3, 4) / d3[:, None]
    jt = _poly_eval(ct, u, 3, 5) / d3[:, None]
    jl = torch.where(in_poly, jl * jl, zero_r)
    jt = torch.where(in_poly, jt * jt, zero_r)

    ds_t = torch.where(in_poly, _poly_eval(cl, u, 1, 4) / d[:, None],
                       ds_end[:, None])
    s_t = torch.where(in_poly, _poly_eval(cl, u, 0, 4),
                      s_end[:, None] + (ts - te[:, None]) * ds_end[:, None])
    l_t = torch.where(in_poly, _poly_eval(ct, u, 0, 5), l_end[:, None])

    # the speed limit at s (a lerp of the ref line's column 4)
    q = s_t / pp["ref_step"]
    i0 = torch.clamp(torch.floor(q), 0, n_ref - 1)
    i1 = torch.clamp(torch.ceil(q), 0, n_ref - 1).long()
    a = torch.clamp(q - i0, 0.0, 1.0)
    v_max = v_col[i0.long()] * (1.0 - a) + v_col[i1] * a
    cost = pp["w_v_diff"] * torch.abs(100.0 - ds_t)
    cost = cost + 100.0 * torch.maximum(zero_r, ds_t - v_max)

    # the directional field straight ahead at (t, s, l)
    t_idx = torch.where(ts < pp["dt_start"], zero_r,
                        torch.round((ts - pp["dt_start"]) / pp["dt"]) + 1.0)
    ti = torch.clamp(t_idx, 0, T - 1).long()
    si = torch.clamp(torch.round((s_t - pp["s_min"]) / s_span * (S - 1)),
                     0, S - 1).long()
    li = torch.clamp(torch.round((l_t - pp["l_min"]) / l_span * (L - 1)),
                     0, L - 1).long()
    d_front = field[ti, si, li]
    d_safety = d_front - pp["length_veh"] * 0.5 - 1.0 - ds_t * 1.0
    x = ds_t * DT_INT
    cost = cost + torch.where(x > d_safety, 100.0 * (x - d_safety), zero_r)
    t_end = t_end_eval if is_last else t_end_eval[:, None]
    cost = torch.where(ts <= t_end, cost, zero_r)

    # the three sums in step order
    j_lon, j_lat, steps = zero, zero, zero
    for r in range(n_int):
        j_lon = j_lon + jl[:, r]
        j_lat = j_lat + jt[:, r]
        steps = steps + cost[:, r]

    cost = pp["w_j"] * j_lon
    cost = cost + pp["w_j"] * j_lat
    cost = cost + pp["w_l"] * torch.abs(0.0 - le)
    cost = cost + steps
    out = torch.zeros((t0.shape[0], 8), dtype=f32, device=dev)
    out[:, PP_T] = te
    out[:, PP_S] = s_end
    out[:, PP_DS] = dse
    out[:, PP_L] = le
    out[:, PP_COST] = cost
    return out


def segmented_argmin(costs, seg):
    """Per segment i (edges seg[i]:seg[i + 1] of ``costs``, float64): the
    least cost and the index of its edge, as ``np.argmin`` picks it (the
    first NaN if any, else the first of equal least costs); +inf and 0 for
    an empty segment."""
    dev = costs.device
    n, E = seg.shape[0] - 1, costs.shape[0]
    seg = seg.long()
    idx = torch.arange(E, device=dev)
    seg_id = torch.repeat_interleave(torch.arange(n, device=dev),
                                     seg[1:] - seg[:-1])
    isnan = torch.isnan(costs)
    big = torch.full((n,), E, dtype=torch.long, device=dev)
    first_nan = big.scatter_reduce(0, seg_id, torch.where(isnan, idx, E),
                                   "amin")
    vals = torch.where(isnan, float("inf"), costs)
    least = torch.full((n,), float("inf"), dtype=costs.dtype, device=dev
                       ).scatter_reduce(0, seg_id, vals, "amin")
    first = big.scatter_reduce(
        0, seg_id, torch.where(~isnan & (vals == least[seg_id]), idx, E),
        "amin")
    pick = torch.where(first_nan < E, first_nan, first)
    empty = pick == E
    pick = torch.where(empty, 0, pick)
    bmin = torch.where(empty, float("inf"), costs[pick] if E else
                       torch.full((n,), float("inf"), dtype=costs.dtype,
                                  device=dev))
    return bmin, pick


def propagate_reference(pts, node_cost, best, seg, node_off, seg_off, traj):
    """The plain version of :func:`propagate_and_backtrack` (reference:
    poly_planner.cu:110-155 propagateCost + copyTrajectory, the JAX
    package's ``propagate_and_backtrack``): from the last level down, each
    node's float64 cost becomes its own plus the least (float64) cost among
    its edges' end nodes (:func:`segmented_argmin`), written to
    ``node_cost`` with the edge to ``best``; then the backtrack from the
    root writes the (K + 1, 8) float64 trajectory into ``traj``: each row
    the node's point, its cost the propagated one (the last level's its
    own).  Buffers as the module docstring lays them out."""
    K = len(node_off) - 2
    for k in range(K - 1, -1, -1):
        a, b, c = node_off[k], node_off[k + 1], node_off[k + 2]
        costs = (pts[b:c, PP_COST].double() if k == K - 1
                 else node_cost[b:c])
        bmin, pick = segmented_argmin(
            costs, seg[seg_off[k]:seg_off[k] + (b - a) + 1])
        node_cost[a:b] = pts[a:b, PP_COST].double() + bmin
        best[a:b] = pick.to(best.dtype)
    idx = 0
    traj[0] = pts[0].double()
    traj[0, PP_COST] = node_cost[0]
    for k in range(K):
        idx = int(best[node_off[k] + idx])
        r = node_off[k + 1] + idx
        traj[k + 1] = pts[r].double()
        if k + 1 < K:
            traj[k + 1, PP_COST] = node_cost[r]
    return traj


# ---------------------------------------------------------------------
# the wrappers


def _eval_inputs(start_pts, edge_starts, end_specs, ev, dir_dist, ref_line):
    """Checks one level's evaluation inputs; returns ``ev`` as a float32
    numpy vector."""
    dev = start_pts.device
    f32 = torch.float32
    if start_pts.dim() != 2 or start_pts.shape[1] != 8:
        raise ValueError(f"start_pts must be (Ns, 8), got "
                         f"{tuple(start_pts.shape)}")
    _check("start_pts", start_pts, start_pts.shape, f32, dev)
    E = edge_starts.shape[0]
    _check("edge_starts", edge_starts, (E,), torch.int32, dev)
    _check("end_specs", end_specs, (E, 3), f32, dev)
    if dir_dist.dim() != 4:
        raise ValueError(f"dir_dist must be (T, S, L, D), got "
                         f"{tuple(dir_dist.shape)}")
    _check("dir_dist", dir_dist, dir_dist.shape, f32, dev)
    if ref_line.dim() != 2 or ref_line.shape[1] != 8:
        raise ValueError(f"ref_line must be (N, 8), got "
                         f"{tuple(ref_line.shape)}")
    _check("ref_line", ref_line, ref_line.shape, f32, dev)
    ev = np.ascontiguousarray(ev, np.float32)
    if ev.shape != (len(EVAL_KEYS),):
        raise ValueError(f"ev must hold {len(EVAL_KEYS)} values")
    return ev


def _launch_eval(fn, start_pts, edge_starts, end_specs, is_last, ev,
                 dir_dist, ref_line, n_int, out, prof=()):
    """``poly_eval_edges`` (or its profiling entry ``fn`` with the counter
    buffer ``prof``) on CUDA tensors, into ``out``; scratch for the field's
    slice straight ahead is allocated here."""
    dev = start_pts.device
    m4, h5 = inverses_f32()
    consts = np.concatenate([ev, m4.ravel(), h5.ravel()]).astype(np.float32)
    T, S, L, D = dir_dist.shape
    field_slice = torch.empty(T * S * L, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(start_pts.data_ptr(), edge_starts.data_ptr(),
                 end_specs.data_ptr(), dir_dist.data_ptr(),
                 ref_line.data_ptr(), field_slice.data_ptr(),
                 out.data_ptr(), *[b.data_ptr() for b in prof],
                 consts.ctypes.data, edge_starts.shape[0],
                 int(bool(is_last)), n_int, T, S, L, D, ref_line.shape[0],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"poly_eval_edges launch failed: CUDA error {err}")


def eval_edges(start_pts, edge_starts, end_specs, is_last, ev, dir_dist,
               ref_line, n_int, out=None):
    """End points (E, 8) float32 of one level's edges: the kernel
    ``poly_eval_edges`` on a CUDA tensor (written into ``out`` when given;
    two launches, the field's slice straight ahead and the evaluation, none
    for E = 0), :func:`eval_edges_reference` on a CPU tensor.  Arguments as
    :func:`eval_edges_reference`'s, contiguous on one device; ``ev`` stays
    on the host (the launch takes it by value)."""
    global eval_launches
    dev = start_pts.device
    ev = _eval_inputs(start_pts, edge_starts, end_specs, ev, dir_dist,
                      ref_line)
    E = edge_starts.shape[0]
    if dev.type == "cpu":
        res = eval_edges_reference(start_pts, edge_starts, end_specs,
                                   is_last, ev, dir_dist, ref_line, n_int)
        if out is None:
            return res
        out.copy_(res)
        return out
    if dev.type != "cuda":
        raise ValueError(f"poly_planner_kernel: unsupported device {dev}")
    lib = _kernel()
    if out is None:
        out = torch.empty((E, 8), dtype=torch.float32, device=dev)
    else:
        _check("out", out, (E, 8), torch.float32, dev)
    _launch_eval(lib.poly_eval_edges, start_pts, edge_starts, end_specs,
                 is_last, ev, dir_dist, ref_line, n_int, out)
    if E:
        eval_launches += EVAL_KERNELS
    return out


# the profiling instantiation's phases (csrc/poly_planner.cu EvalPhase),
# then the counts it adds
EVAL_PHASES = ("fit", "poly", "tail", "lookup", "sums")
EVAL_COUNTS = ("poly_steps", "tail_steps")


def eval_edges_profile(start_pts, edge_starts, end_specs, is_last, ev,
                       dir_dist, ref_line, n_int):
    """The evaluation's profiling instantiation on CUDA tensors (not
    counted as a launch of the main path): (end points bit-equal to
    :func:`eval_edges`'s, {phase: clock64() cycles summed over the edges'
    threads, then the polynomial and tail steps taken})."""
    dev = start_pts.device
    ev = _eval_inputs(start_pts, edge_starts, end_specs, ev, dir_dist,
                      ref_line)
    if dev.type != "cuda":
        raise ValueError("eval_edges_profile needs CUDA tensors")
    lib = _kernel()
    out = torch.empty((edge_starts.shape[0], 8), dtype=torch.float32,
                      device=dev)
    prof = torch.zeros(len(EVAL_PHASES) + len(EVAL_COUNTS),
                       dtype=torch.int64, device=dev)
    _launch_eval(lib.poly_eval_edges_profile, start_pts, edge_starts,
                 end_specs, is_last, ev, dir_dist, ref_line, n_int, out,
                 (prof,))
    return out, dict(zip(EVAL_PHASES + EVAL_COUNTS, prof.cpu().tolist()))


def _propagate_inputs(pts, node_cost, best, seg, node_off, seg_off, traj):
    """Checks the propagation's buffers; returns K."""
    dev = pts.device
    N = node_off[-1]
    K = len(node_off) - 2
    if not 1 <= K <= MAX_LEVELS:
        raise ValueError(f"{K} levels: the propagation takes 1 to "
                         f"{MAX_LEVELS}")
    _check("pts", pts, (N, 8), torch.float32, dev)
    _check("node_cost", node_cost, (N,), torch.float64, dev)
    _check("best", best, (N,), torch.int32, dev)
    _check("seg", seg, (seg_off[-1],), torch.int32, dev)
    _check("traj", traj, (K + 1, 8), torch.float64, dev)
    return K


def _launch_propagate(fn, pts, node_cost, best, seg, node_off, seg_off, traj,
                      K, prof=()):
    """``poly_propagate`` (or its profiling entry ``fn`` with the counter
    buffer ``prof``) on CUDA tensors; the arrival counter is the
    stream's."""
    from tpl_tpu_torch import _build

    dev = pts.device
    offs = np.zeros(2 * MAX_LEVELS + 3, np.int32)
    offs[:K + 2] = node_off
    offs[MAX_LEVELS + 2:MAX_LEVELS + 2 + K + 1] = seg_off
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pts.data_ptr(), node_cost.data_ptr(), best.data_ptr(),
                 seg.data_ptr(), traj.data_ptr(), offs.ctypes.data,
                 _build.arrival_counter(dev, stream).data_ptr(),
                 *(b.data_ptr() for b in prof), K, stream)
    if err != 0:
        raise RuntimeError(f"poly_propagate launch failed: CUDA error {err}")


def propagate_and_backtrack(pts, node_cost, best, seg, node_off, seg_off,
                            traj):
    """The cost relaxation and the backtrack into ``traj`` ((K + 1, 8)
    float64): one ``poly_propagate`` launch on a CUDA tensor (every level
    and the backtrack), :func:`propagate_reference` on a CPU tensor.
    ``pts`` (N, 8) float32, ``node_cost`` (N,) float64, ``best`` (N,)
    int32, ``seg`` int32, contiguous on one device; ``node_off`` /
    ``seg_off`` host lists (module docstring)."""
    global propagate_launches
    dev = pts.device
    K = _propagate_inputs(pts, node_cost, best, seg, node_off, seg_off, traj)
    if dev.type == "cpu":
        return propagate_reference(pts, node_cost, best, seg, node_off,
                                   seg_off, traj)
    if dev.type != "cuda":
        raise ValueError(f"poly_planner_kernel: unsupported device {dev}")
    _launch_propagate(_kernel().poly_propagate, pts, node_cost, best, seg,
                      node_off, seg_off, traj, K)
    propagate_launches += 1
    return traj


# the propagation's profiling instantiation's phases (csrc/poly_planner.cu
# PropPhase): thread 0's cycles from barrier to barrier, summed over the
# blocks; the last two the last block's alone
PROP_PHASES = ("last_level", "arrival", "lower_levels", "backtrack")


def propagate_profile(pts, node_cost, best, seg, node_off, seg_off, traj):
    """The propagation's profiling instantiation on CUDA tensors (not
    counted as a launch of the main path): fills the buffers as
    :func:`propagate_and_backtrack` does, bit for bit, and returns {phase:
    clock64() cycles}."""
    K = _propagate_inputs(pts, node_cost, best, seg, node_off, seg_off, traj)
    if pts.device.type != "cuda":
        raise ValueError("propagate_profile needs CUDA tensors")
    prof = torch.zeros(len(PROP_PHASES), dtype=torch.int64,
                       device=pts.device)
    _launch_propagate(_kernel().poly_propagate_profile, pts, node_cost, best,
                      seg, node_off, seg_off, traj, K, (prof,))
    return dict(zip(PROP_PHASES, prof.cpu().tolist()))


def graph_layout(node_counts, edge_steps):
    """The device layout of a graph whose levels hold ``node_counts`` nodes
    (K + 1 of them) and whose edges start at ``edge_steps`` (K arrays):
    (node_off (K + 2 ints), seg (int32 numpy), seg_off (K + 1 ints))."""
    node_off = [0]
    for n in node_counts:
        node_off.append(node_off[-1] + int(n))
    segs = [segment_offsets(e, n) for e, n in zip(edge_steps, node_counts)]
    seg_off = [0]
    for s in segs:
        seg_off.append(seg_off[-1] + len(s))
    return node_off, np.concatenate(segs), seg_off


class _Graph:
    """One start index's graph on the device: the edges of every level
    (``edge_starts``, ``end_specs``), the per-node edge offsets (``seg``),
    the row offsets (``node_off``, ``seg_off``) and the host arrays it was
    made from."""

    def __init__(self, node_steps, edge_steps, dev):
        self.node_steps, self.edge_steps = node_steps, edge_steps
        self.node_off, seg, self.seg_off = graph_layout(
            [len(n) for n in node_steps], edge_steps)
        self.edge_starts = torch.from_numpy(
            np.concatenate(edge_steps).astype(np.int32)).to(dev)
        self.end_specs = torch.from_numpy(
            np.concatenate(node_steps[1:]).astype(np.float32)).to(dev)
        self.seg = torch.from_numpy(seg).to(dev)

    def level(self, k):
        """Level k's edges: (edge_starts, end_specs) slices."""
        a, b = self.node_off[k + 1] - 1, self.node_off[k + 2] - 1
        return self.edge_starts[a:b], self.end_specs[a:b]


class DpPolyPlannerKernel:
    """Stateful wrapper caching eval graphs per (ds, l) start index, on the
    environment's device; one set of work buffers (the node table, the
    propagated costs and edges, the trajectory) grows to the largest graph
    seen."""

    def __init__(self):
        self.params = DpPolyParams()
        self._graphs = {}
        self._work = None
        self._last = None

    def reinit_buffers(self, params):
        if (params.eval_steps != self.params.eval_steps
                or params.t_steps != self.params.t_steps
                or params.ds_steps != self.params.ds_steps
                or params.l_steps != self.params.l_steps):
            self._graphs = {}
        self.params = params

    def start_key(self, init_state):
        """The graph's (ds, l) start index of a start state."""
        p = self.params
        idx_ds = int(round((init_state[PP_DS] - p.ds_min) / p.ds_step_size))
        idx_ds = max(0, min(p.ds_steps - 1, idx_ds))
        idx_l = int(round((init_state[PP_L] - p.l_min) / p.l_step_size))
        idx_l = max(0, min(p.l_steps - 1, idx_l))
        return idx_ds, idx_l

    def _buffers(self, g, dev):
        N, K = g.node_off[-1], len(g.node_off) - 2
        w = self._work
        if (w is None or w["pts"].device != dev or w["pts"].shape[0] < N
                or w["traj"].shape[0] != K + 1):
            w = self._work = dict(
                pts=torch.zeros((N, 8), dtype=torch.float32, device=dev),
                node_cost=torch.zeros(N, dtype=torch.float64, device=dev),
                best=torch.zeros(N, dtype=torch.int32, device=dev),
                traj=torch.zeros((K + 1, 8), dtype=torch.float64,
                                 device=dev))
        return w["pts"][:N], w["node_cost"][:N], w["best"][:N], w["traj"]

    def update(self, init_state, env):
        """init_state: (8,) point; env: DpEnvironment with dir_dist_map.
        Returns (eval_steps + 1, 8) float64 trajectory."""
        p = self.params
        ep = env.params
        if getattr(env.grid, "dir_dist_map", None) is None:
            env.update_dir_dist_map()
        dd = env.grid.dir_dist_map
        dev = dd.device

        key = self.start_key(init_state)
        g = self._graphs.get(key)
        if g is None or g.seg.device != dev:
            g = self._graphs[key] = _Graph(*build_eval_graph(p, *key), dev)
        pts, node_cost, best, traj = self._buffers(g, dev)
        ev = eval_params(p, ep, np.float32(env.ref_step))
        n_int = p.n_int_steps()
        K = len(g.edge_steps)

        # the one upload: the start state, rounded to float32
        pts[0].copy_(torch.from_numpy(np.asarray(init_state, np.float32)
                                      .reshape(8)))
        for k in range(K):
            starts, specs = g.level(k)
            eval_edges(pts[g.node_off[k]:g.node_off[k + 1]], starts, specs,
                       k == K - 1, ev, dd, env.grid.ref_line, n_int,
                       out=pts[g.node_off[k + 1]:g.node_off[k + 2]])
        propagate_and_backtrack(pts, node_cost, best, g.seg, g.node_off,
                                g.seg_off, traj)
        self._last = (g, node_cost)
        # the one download
        return traj.cpu().numpy()

    def root_edge_costs(self):
        """The last update's propagated costs of the root's edges (level
        1's nodes), float64 numpy (a debug getter: it downloads)."""
        g, node_cost = self._last
        return node_cost[g.node_off[1]:g.node_off[2]].cpu().numpy()


# ---------------------------------------------------------------------
# bounds

# Operations of one integration step as the plain version defines it: the
# time, the normalised time and its clip, the two jerks (Horner, 2 and 3
# terms of 3 operations, the cube's division), their squares and sums, the
# speed, station and offset (4, 5 and 6 terms), the selections, the speed
# limit's lerp, the speed costs, the field's index and lookup, the safety
# cost, the step sum; per edge the two coefficient solves (5 x 5 and 6 x 6
# products and sums), the end values and the cost.
OPS_STEP = 150
# a step past the end time: no normalised time, jerks or polynomials (63
# of the 150), the tail's station (3)
OPS_TAIL_STEP = OPS_STEP - 63 + 3
OPS_EDGE = 2 * (25 + 36) + 40
# the critical path of one edge's thread: the coefficients, one step's
# chain (Horner, the station's lookups in L2), then the step sums one after
# the other
CHAIN_EDGE = dict(f32_mul=14, f32_add=18, f32_div=3, smem_load=3)
CHAIN_PER_STEP = dict(f32_add=1)
# the propagation: a node's warp reads its edges 32 at a time (a lower
# level's node of the last block, when the level has fewer nodes than the
# block's 8 warps: 256 at a time), one float64 compare each, then 5 shuffle
# rounds (and a second 5 across the warps); the backtrack K reads
CHAIN_PER_EDGE_ROUND = dict(f64_add=1, smem_load=1)
CHAIN_REDUCE = dict(f64_add=5, smem_load=5)


def eval_bytes(n_start, E, dir_shape, n_ref):
    """Bytes one evaluation launch must move: the start points, the edges'
    start indices and end specs, the field and the ref line read once, the
    end points written once."""
    return (32 * n_start + 16 * E + 4 * int(np.prod(dir_shape)) + 32 * n_ref
            + 32 * E)


def eval_operations(E, n_int):
    return E * (n_int * OPS_STEP + OPS_EDGE)


def eval_bound_ms(n_starts, edges, dir_shape, n_ref, n_int):
    """The roofline bound of one evaluation launch per level: ``n_starts``
    and ``edges`` hold each launch's start points and edges."""
    return _latency.roofline_ms(
        sum(eval_bytes(n, E, dir_shape, n_ref)
            for n, E in zip(n_starts, edges)),
        sum(eval_operations(E, n_int) for E in edges), "float32")


def eval_steps_needed(start_pts, edge_starts, end_specs, is_last, ev,
                      n_int):
    """(polynomial steps, tail steps) one level's edges need: the steps
    whose time ts (float32, as the kernel forms it) is at most the edge's
    end time, then those past it up to the end of the evaluation (the
    horizon on the last level); no other step adds anything."""
    dev = start_pts.device
    t0 = start_pts[edge_starts.long(), PP_T]
    te = end_specs[:, 0]
    ts = t0[:, None] + torch.arange(n_int, dtype=torch.float32,
                                    device=dev) * DT_INT
    poly = ts <= te[:, None]
    t_end = (float(np.float32(ev[EVAL_KEYS.index("t_horizon")])) if is_last
             else te[:, None])
    tail = ~poly & (ts <= t_end)
    return int(poly.sum()), int(tail.sum())


def eval_needed_bound_ms(n_starts, edges, dir_shape, n_ref, poly_steps,
                         tail_steps):
    """The needed-work bound of one evaluation launch per level: the bytes
    of :func:`eval_bound_ms`, the operations of the steps the edges need
    (``poly_steps`` and ``tail_steps`` summed over the levels, from
    :func:`eval_steps_needed`)."""
    return _latency.roofline_ms(
        sum(eval_bytes(n, E, dir_shape, n_ref)
            for n, E in zip(n_starts, edges)),
        poly_steps * OPS_STEP + tail_steps * OPS_TAIL_STEP
        + sum(edges) * OPS_EDGE, "float32")


def eval_chain_ms(n_int, cycles, sm_mhz):
    return _latency.chain_ms(_latency.add_ops(dict(CHAIN_EDGE),
                                              CHAIN_PER_STEP, n_int),
                             cycles, sm_mhz)


def propagate_bytes(node_off, seg_off):
    """Bytes the propagation must move: each edge's cost (the last level's
    float32, the others' float64), each level's offsets, each node's
    propagated cost and edge written, the trajectory."""
    K = len(node_off) - 2
    n = [node_off[k + 1] - node_off[k] for k in range(K + 1)]
    edge_cost = 4 * n[K] + 8 * sum(n[1:K])
    return (edge_cost + 4 * seg_off[-1] + 4 * sum(n[:K])
            + 12 * sum(n[:K]) + 8 * 8 * (K + 1))


def propagate_bound_ms(node_off, seg_off):
    K = len(node_off) - 2
    ops = 2 * (node_off[K + 1] - node_off[1]) + node_off[K]
    return _latency.roofline_ms(propagate_bytes(node_off, seg_off), ops,
                                "float64")


def propagate_chain_ms(node_off, seg_host, seg_off, cycles, sm_mhz,
                       one_launch=True):
    """The levels one after the other, each its longest warp: the edges 32
    at a time, then the reduction.  ``one_launch``: the kernel's design,
    the last level a warp a node, each lower level on the last block's 8
    warps (a level of fewer than 8 nodes a node at a time, 256 edges at a
    time, then two reductions); else the pricing of the earlier design, a
    launch a level, a warp a node.  ``seg_host`` the offsets as numpy."""
    K = len(node_off) - 2
    ops = {}
    for k in range(K):
        n = node_off[k + 1] - node_off[k]
        if n == 0:
            continue
        d = np.diff(seg_host[seg_off[k]:seg_off[k] + n + 1])
        if not one_launch or k == K - 1:
            rounds, reduces = int(np.ceil(int(np.max(d)) / 32)), 1
        elif n < 8:
            rounds, reduces = int(np.sum(np.ceil(d / 256))), 2 * n
        else:
            rounds = max(int(np.sum(np.ceil(d[w::8] / 32))) for w in range(8))
            reduces = -(-n // 8)
        _latency.add_ops(ops, CHAIN_PER_EDGE_ROUND, rounds)
        _latency.add_ops(ops, CHAIN_REDUCE, reduces)
    _latency.add_ops(ops, dict(smem_load=2), K)
    return _latency.chain_ms(ops, cycles, sm_mhz)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library, and load its code
    onto the current device with the evaluation's shared-memory limit set,
    so that the first launches pay for neither."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("poly_planner")
        ints = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.poly_eval_edges.restype = ctypes.c_int
        lib.poly_eval_edges.argtypes = [ctypes.c_void_p] * 8 + ints
        lib.poly_eval_edges_profile.restype = ctypes.c_int
        lib.poly_eval_edges_profile.argtypes = [ctypes.c_void_p] * 9 + ints
        for fn, n_ptr in ((lib.poly_propagate, 7),
                          (lib.poly_propagate_profile, 8)):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int]
                           + [ctypes.c_void_p])
        for fn in (lib.poly_planner_n_eval_params,
                   lib.poly_planner_max_levels, lib.poly_planner_n_eval_prof,
                   lib.poly_planner_n_prop_phases, lib.poly_planner_prepare):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if (lib.poly_planner_n_eval_params() != len(EVAL_KEYS)
                or lib.poly_planner_max_levels() != MAX_LEVELS
                or lib.poly_planner_n_eval_prof()
                != len(EVAL_PHASES) + len(EVAL_COUNTS)
                or lib.poly_planner_n_prop_phases() != len(PROP_PHASES)):
            raise RuntimeError("poly_planner.cu and poly_planner_kernel "
                               "disagree on EVAL_KEYS / MAX_LEVELS / "
                               "EVAL_PHASES / PROP_PHASES")
        _build.prepare(lib, "poly_planner")
        _LIB = lib
    return _LIB
