"""
Longitudinal DP planner kernel: value iteration over the (s, v, a) grid
along a fixed path with jerk actions.  (reference: library/src/dyn_prog/
lon_planner.cu; the JAX package's form is tpl_tpu/planning/dyn_prog/
lon_kernel.py, XLA programs built on two ``lax.scan``)

The planner follows a path produced by the lateral planner using the path
distance map.  Path layout (PathState, common.cuh:100-113): columns
[x, y, s, l, k, v_max, distance].  Lon state layout: [t, s, v, a, j, cost,
constr] (lon_planner.cuh:55-67).

A solve is T - 1 backward slices (the final one, then T - 2 more, each over
every (s, v, a) node and NB = 9 jerks, lexicographic (constraint, cost)
minimum, first jerk winning) and a greedy forward pass of T steps over
NF = 21 jerks.  On CUDA tensors each slice is one launch of the hand-written
kernel ``csrc/lon_dp.cu`` (``lon_dp_backward``) and the forward pass one
launch (``lon_dp_forward``, two warps that stage the path's columns and
the distance map, the kernel's ``lon_dp_forward_smem_bytes``, and also run
:func:`reeval`'s pass); on CPU
tensors the plain PyTorch versions :func:`backward_slice_reference` and
:func:`forward_reference` run instead.  ``launches`` counts the kernel
launches of either entry, ``backward_launches`` / ``forward_launches`` each.
A backward block takes one v and a tile of s rows and stages the box of the
next slice that its lookups read; :func:`backward_plan` sizes the tile and
the box on the host from the packed parameters, which the wrapper reads
from the card once a solve, and raises where one s row's box does not fit.

The arithmetic follows the JAX program operation by operation.  XLA on the
CPU turns a division by a constant into a product with its float32
reciprocal (matched, :func:`div_const`) and contracts multiply-adds: matched
where a grid point or a jerk sample is made (:func:`axis_points`, since a
point an ulp off can flip a rounded index), elsewhere not (the kernel is
built with ``--fmad=false``).  The JAX backward pass sums the (v, a)
corners of its value lookup as a one-hot matrix product, where the port sums
them in column order.  Both move values by ulps; a node whose jerks are tied
that closely may pick another jerk (tests/test_torch_poly_chain.py bounds
the share).  The a-axis is not padded (the JAX package pads it to a multiple
of 8 for the TPU).
"""

import ctypes
import weakref

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.planning.dyn_prog.latlon_action_min import div_const

# lon state columns
LC_T, LC_S, LC_V, LC_A, LC_J, LC_COST, LC_CONSTR = range(7)

# path columns
PC_X, PC_Y, PC_S, PC_L, PC_K, PC_VMAX, PC_DIST = range(7)

NB = 9              # backward jerk samples
NF = 21             # forward jerk samples

launches = 0            # kernel launches since import (reset freely)
backward_launches = 0
forward_launches = 0


class LonParams:
    """(reference: lon_planner.cuh:7-53)"""

    def __init__(self):
        self.s_min = 0.0
        self.s_max = 200.0
        self.v_min = 0.0
        self.v_max = 36.0
        self.a_min = -2.0
        self.a_max = 2.0
        self.j_min = -2.0
        self.j_max = 2.0

        self.t_steps = 10
        self.s_steps = 201
        self.v_steps = 37
        self.a_steps = 7

        self.dt_start = 1.0
        self.dt = 1.0

        self.time_gap = 1.5
        self.gap_min = 1.0

        self.w_progress = 1.0
        self.w_a = 0.5
        self.w_j = 0.5
        self.w_snap = 0.5
        self.w_safety_dist = 10.0

        self.path_step_size = 0.5
        self.path_steps = 200

        self.width_veh = 2.0
        self.length_veh = 6.0

    @property
    def s_step(self):
        return (self.s_max - self.s_min) / (self.s_steps - 1)

    @property
    def v_step(self):
        return (self.v_max - self.v_min) / (self.v_steps - 1)

    @property
    def a_step(self):
        return (self.a_max - self.a_min) / (self.a_steps - 1)

    def packed(self):
        """All dynamic params as ONE f32 vector: a single host->device
        transfer per call instead of one per scalar."""
        return np.array([getattr(self, k) for k in LON_PP_KEYS],
                        dtype=np.float32)


LON_PP_KEYS = ("s_min", "s_max", "v_min", "v_max", "a_min", "a_max",
               "j_min", "j_max", "dt_start", "dt", "time_gap", "gap_min",
               "w_progress", "w_a", "w_j", "w_snap", "w_safety_dist",
               "path_step_size", "width_veh", "length_veh")


def unpack_lon_pp(vec):
    """Expand a packed param vector back into the kernels' dict form (0-d
    tensors or numpy scalars)."""
    return {k: vec[i] for i, k in enumerate(LON_PP_KEYS)}


def lon_dynamics_np(state, j, dt):
    """(lon_planner.cu:240-251)"""
    res = np.array(state, dtype=np.float64).copy()
    res[LC_T] = state[LC_T] + dt
    res[LC_S] = max(state[LC_S],
                    state[LC_S] + state[LC_V] * dt
                    + 0.5 * state[LC_A] * dt * dt
                    + 1.0 / 6.0 * j * dt ** 3)
    res[LC_V] = max(0.0, state[LC_V] + state[LC_A] * dt + 0.5 * j * dt * dt)
    res[LC_A] = state[LC_A] + j * dt
    res[LC_J] = j
    return res


def lon_traj_state(traj, t):
    """(lon_planner.cu:253-261 LonTraj::state)"""
    return lon_traj_states(traj, np.asarray([t], dtype=np.float64))[0]


def lon_traj_states(traj, ts):
    """Vectorized :func:`lon_traj_state` over a time grid ts -> (N, 7)."""
    node_ts = traj[:, LC_T]
    idx = np.clip(np.searchsorted(node_ts, ts, side="right") - 1,
                  0, len(traj) - 1)
    base = traj[idx].astype(np.float64)
    t_rel = ts - base[:, LC_T]
    j = base[:, LC_J]
    out = base.copy()
    out[:, LC_T] = base[:, LC_T] + t_rel
    out[:, LC_S] = np.maximum(
        base[:, LC_S],
        base[:, LC_S] + base[:, LC_V] * t_rel
        + 0.5 * base[:, LC_A] * t_rel ** 2 + j * t_rel ** 3 / 6.0)
    out[:, LC_V] = np.maximum(
        0.0, base[:, LC_V] + base[:, LC_A] * t_rel + 0.5 * j * t_rel ** 2)
    out[:, LC_A] = base[:, LC_A] + j * t_rel
    out[:, LC_J] = j
    return out


def fma32(a, b, c):
    """a * b + c on float32 values, rounded once: XLA on the CPU contracts a
    multiply-add into one FMA, and a grid point that lands on a rounding
    boundary then moves by an ulp (the exact product of two float32 values
    fits a float64, so the sum rounds once there and once to float32)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)
    return (f64(a) * f64(b) + f64(c)).float()


def axis_points(lo, hi, idx, n):
    """lo + (hi - lo) * idx / n as XLA on the CPU computes it in float32
    (the division by the constant n a product with its reciprocal,
    contracted with the addition): the grid points of the JAX programs."""
    return fma32((hi - lo) * idx, np.float32(1.0) / np.float32(n), lo)


def _cube(x):
    """x ** 3 as ``jnp`` integer powers round it: x * (x * x)."""
    return x * (x * x)


# ---------------------------------------------------------------------
# plain versions (any device)


def _interp_col(path, col, dist, pss):
    """interp_path(path, dist, pp)[..., col] (common.cuh:115-139): floor /
    ceil rows clamped to the path, the unclamped fraction."""
    P = path.shape[0]
    a = dist / pss
    i0f = torch.clamp(torch.floor(a), 0, P - 1)
    i1 = torch.clamp(torch.ceil(a), 0, P - 1).long()
    al = a - i0f
    i0 = i0f.long()
    return path[i0, col] * (1.0 - al) + path[i1, col] * al


def _s_dist(dist_path, t_idx, s_path, pp, S):
    """The path distance map at the rounded s index of ``s_path``, less
    0.6 vehicle lengths (env.cu:253-263)."""
    si = torch.clamp(torch.round((s_path - pp["s_min"])
                                 / (pp["s_max"] - pp["s_min"]) * (S - 1)),
                     0, S - 1).long()
    return dist_path[t_idx, si] - pp["length_veh"] * 0.6


def _state_terms(s, v, a, s_dist, v_max, pp):
    """(state_cost, state_constr) of evalNode (lon_planner.cu:71-177)."""
    state_cost = (pp["w_a"] * (a * a)
                  + pp["w_progress"] * torch.abs(1000.0 - s)
                  + pp["w_safety_dist"] * torch.clamp(
                      v * pp["time_gap"] + pp["gap_min"] - s_dist, min=0.0))
    state_constr = torch.clamp(v - v_max, min=0.0)
    return state_cost, state_constr


def _jerks(pp, n):
    dev = pp["j_min"].device
    return axis_points(pp["j_min"], pp["j_max"],
                       torch.arange(n, dtype=torch.float32, device=dev), n - 1)


def _lex_min(constr, cost, js):
    """Lexicographic (constraint, cost) minimum over the last axis, first
    minimum winning; returns (cost, constr, jerk) of the winner.  As
    ``jnp.min`` / ``jnp.argmin`` in the JAX program: a NaN constraint makes
    the least constraint NaN, which no action passes (cost inf, the first
    jerk); among the actions of the least constraint the first NaN cost
    wins, and where all of them cost inf the first jerk does."""
    cmin = torch.amin(constr, dim=-1, keepdim=True)
    cost_m = torch.where(constr <= cmin, cost, float("inf"))
    jidx = torch.argmin(cost_m, dim=-1, keepdim=True)
    cost_best = torch.gather(cost_m, -1, jidx)[..., 0]
    return cost_best, cmin[..., 0], js[jidx[..., 0]]


def grid_values(pp, S, V, A):
    """The (s, v, a) grid values, as the JAX program spaces them."""
    dev = pp["s_min"].device
    f32 = torch.float32

    def axis(lo, hi, n):
        return axis_points(lo, hi, torch.arange(n, dtype=f32, device=dev),
                           n - 1)

    return (axis(pp["s_min"], pp["s_max"], S),
            axis(pp["v_min"], pp["v_max"], V),
            axis(pp["a_min"], pp["a_max"], A))


def backward_slice_reference(nodes_next, pp_vec, path, dist_path, t_idx,
                             is_last):
    """The plain version of one backward slice (``eval_grid``,
    lon_kernel.py:197-342 of the JAX package): nodes (S, V, A, 4)
    [cost, constr, jerk, 0] from the next slice's nodes; the final slice
    (``is_last``) is [state_cost, 0, 0, 0] and ignores ``nodes_next``."""
    S, V, A, _ = nodes_next.shape
    pp = unpack_lon_pp(pp_vec)
    dt = pp["dt"]
    ss, vs, aas = grid_values(pp, S, V, A)
    pss = pp["path_step_size"]

    v_max_s = _interp_col(path, PC_VMAX, ss, pss)                 # (S,)
    s_dist = _s_dist(dist_path, t_idx, _interp_col(path, PC_S, ss, pss),
                     pp, S)                                        # (S,)
    s_g, v_g, a_g = ss[:, None, None], vs[None, :, None], aas[None, None, :]
    state_cost, state_constr = _state_terms(s_g, v_g, a_g,
                                            s_dist[:, None, None],
                                            v_max_s[:, None, None], pp)
    state_cost = state_cost.expand(S, V, A)
    state_constr = state_constr.expand(S, V, A)
    if is_last:
        zero = torch.zeros_like(state_cost)
        return torch.stack([state_cost, zero, zero, zero], dim=-1)

    js = _jerks(pp, NB)
    j = js[None, None, None, :]
    v4, a4 = v_g[..., None], a_g[..., None]
    # next states (lonDynamics); s_change depends on (v, a, j) only
    ds_change = (v4 * dt + 0.5 * a4 * dt * dt) + div_const(j * _cube(dt), 6)
    s_change = torch.clamp(ds_change, min=0.0)                    # (1,V,A,NB)
    vn = torch.clamp(v4 + a4 * dt + 0.5 * j * dt * dt, min=0.0)
    an = a4 + j * dt
    sn = s_g[..., None] + s_change                                # (S,V,A,NB)

    # value lookup: a fractional row shift along s (two edge-clamped rows
    # blended by one weight) and a bilinear (v, a) lookup
    s_step_x = div_const(pp["s_max"] - pp["s_min"], S - 1)
    f_c = s_change / s_step_x
    k_c = torch.floor(f_c)
    ax_c = f_c - k_c
    y = torch.clamp((vn - pp["v_min"]) / (pp["v_max"] - pp["v_min"])
                    * (V - 1), 0.0, V - 1.0)
    z = torch.clamp((an - pp["a_min"]) / (pp["a_max"] - pp["a_min"])
                    * (A - 1), 0.0, A - 1.0)
    y0f, z0f = torch.floor(y), torch.floor(z)
    wy0 = 1.0 - (y - y0f)
    wz0 = 1.0 - (z - z0f)
    y0, z0 = y0f.long(), z0f.long()
    y1, z1 = torch.clamp(y0 + 1, max=V - 1), torch.clamp(z0 + 1, max=A - 1)
    w00, w01 = wy0 * wz0, wy0 * (1 - wz0)
    w10, w11 = (1 - wy0) * wz0, (1 - wy0) * (1 - wz0)

    s_iota = torch.arange(S, device=nodes_next.device)[:, None, None, None]
    rows0 = torch.clamp(s_iota + k_c.long(), 0, S - 1)            # (S,V,A,NB)
    rows1 = torch.clamp(s_iota + k_c.long() + 1, 0, S - 1)
    ax_row = torch.where(s_iota.to(torch.float32) + f_c >= S - 1,
                         torch.zeros_like(ax_c), ax_c)
    flat = nodes_next.reshape(S * V * A, 4)[:, :3]

    def bilerp(rows):
        base = rows * V
        t00 = flat[(base + y0) * A + z0]
        t01 = flat[(base + y0) * A + z1]
        t10 = flat[(base + y1) * A + z0]
        t11 = flat[(base + y1) * A + z1]
        return (((t00 * w00[..., None] + t01 * w01[..., None])
                 + t10 * w10[..., None]) + t11 * w11[..., None])

    a_row = ax_row[..., None]
    nn = bilerp(rows0) * (1 - a_row) + bilerp(rows1) * a_row      # (...,3)

    cost = state_cost[..., None] + nn[..., 0]
    constr = state_constr[..., None] + nn[..., 1]
    cost = cost + pp["w_snap"] * (nn[..., 2] - j) ** 2
    cost = cost + pp["w_j"] * (j * dt) ** 2
    v_max_n = _interp_col(path, PC_VMAX, sn, pss)
    constr = constr + torch.clamp(vn - v_max_n, min=0.0)
    constr = constr + torch.clamp(s_change - s_dist[:, None, None, None],
                                  min=0.0)
    constr = constr + torch.clamp(pp["a_min"] - an, min=0.0)
    constr = constr + torch.clamp(an - pp["a_max"], min=0.0)

    cost_best, cmin, j_best = _lex_min(constr, cost, js)
    return torch.stack([cost_best, cmin, j_best,
                        torch.zeros_like(cost_best)], dim=-1)


def _trilerp(nodes, s, v, a, pp):
    """The 8-corner value lookup of the forward pass (JAX ``trilerp``):
    clipped coordinates, floor corners, channels [cost, constr, jerk]."""
    S, V, A, _ = nodes.shape

    def coord(q, lo, hi, n):
        c = torch.clamp((q - lo) / (hi - lo) * (n - 1), 0.0, n - 1.0)
        c0 = torch.floor(c)
        return c0.long(), torch.clamp(c0.long() + 1, max=n - 1), \
            (c - c0)[..., None]

    x0, x1, ax = coord(s, pp["s_min"], pp["s_max"], S)
    y0, y1, ay = coord(v, pp["v_min"], pp["v_max"], V)
    z0, z1, az = coord(a, pp["a_min"], pp["a_max"], A)
    n = nodes[..., :3]
    c00 = n[x0, y0, z0] * (1 - ax) + n[x1, y0, z0] * ax
    c10 = n[x0, y1, z0] * (1 - ax) + n[x1, y1, z0] * ax
    c01 = n[x0, y0, z1] * (1 - ax) + n[x1, y0, z1] * ax
    c11 = n[x0, y1, z1] * (1 - ax) + n[x1, y1, z1] * ax
    c0 = c00 * (1 - ay) + c10 * ay
    c1 = c01 * (1 - ay) + c11 * ay
    return c0 * (1 - az) + c1 * az


def _eval_single(tp, nodes_next, t_idx, dist_path, path, pp, dt, js):
    """evalNode (lon_planner.cu:71-177) of one state over the jerks
    ``js``; returns the state with its jerk, cost and constraint set."""
    S = nodes_next.shape[0]
    s, v, a = tp[LC_S], tp[LC_V], tp[LC_A]
    pss = pp["path_step_size"]
    v_max = _interp_col(path, PC_VMAX, s, pss)
    s_dist = _s_dist(dist_path, t_idx, _interp_col(path, PC_S, s, pss), pp,
                     S)
    state_cost, state_constr = _state_terms(s, v, a, s_dist, v_max, pp)

    ds_change = (v * dt + 0.5 * a * dt * dt) + div_const(js * _cube(dt), 6)
    s_change = torch.clamp(ds_change, min=0.0)
    sn = s + s_change
    vn = torch.clamp(v + a * dt + 0.5 * js * dt * dt, min=0.0)
    an = a + js * dt

    nn = _trilerp(nodes_next, sn, vn, an, pp)
    cost = state_cost + nn[..., 0]
    constr = state_constr + nn[..., 1]
    cost = cost + pp["w_snap"] * (nn[..., 2] - js) ** 2
    cost = cost + pp["w_j"] * (js * dt) ** 2
    v_max_n = _interp_col(path, PC_VMAX, sn, pss)
    constr = constr + torch.clamp(vn - v_max_n, min=0.0)
    constr = constr + torch.clamp(s_change - s_dist, min=0.0)
    constr = constr + torch.clamp(pp["a_min"] - an, min=0.0)
    constr = constr + torch.clamp(an - pp["a_max"], min=0.0)
    cost_best, cmin, j_best = _lex_min(constr, cost, js)
    return state_cost, cost_best, cmin, j_best


def _t_index(tp_t, pp, T):
    t_idx = torch.where(tp_t < pp["dt_start"], torch.zeros_like(tp_t),
                        torch.round((tp_t - pp["dt_start"]) / pp["dt"]) + 1)
    return int(torch.clamp(t_idx.to(torch.int32), 0, T - 1))


def _eval_row(tp, i, nodes, dist_path, path, pp, choose_action):
    """One step of the forward pass or of the reeval (the state ``tp`` at
    index ``i``): returns (tp_out, dt_i)."""
    T = nodes.shape[0]
    dt_i = pp["dt_start"] if i == 0 else pp["dt"]
    t_idx = _t_index(tp[LC_T], pp, T)
    nodes_next = nodes[min(i + 1, T - 1)]
    js = _jerks(pp, NF) if choose_action else tp[LC_J][None]
    state_cost, cost_best, cmin, j_best = _eval_single(
        tp, nodes_next, t_idx, dist_path, path, pp, dt_i, js)
    is_last = torch.round(tp[LC_T] / pp["dt"]) == T - 1
    out = tp.clone()
    out[LC_J] = torch.where(is_last, tp[LC_J], j_best)
    out[LC_COST] = torch.where(is_last, state_cost, cost_best)
    out[LC_CONSTR] = torch.where(is_last, tp[LC_CONSTR], cmin)
    return out, dt_i


def forward_reference(nodes, pp_vec, path, dist_path, x0):
    """The plain version of the forward pass (``eval_single`` + ``fwd``,
    lon_kernel.py:344-393, :425-451): T greedy steps over NF jerks from
    ``x0``; returns the (T, 7) trajectory of evaluated states."""
    T = nodes.shape[0]
    pp = unpack_lon_pp(pp_vec)
    tp = x0.to(torch.float32).clone()
    rows = []
    for i in range(T):
        out, dt_i = _eval_row(tp, i, nodes, dist_path, path, pp, True)
        rows.append(out)
        s, v, a, j = out[LC_S], out[LC_V], out[LC_A], out[LC_J]
        tn = torch.zeros_like(out)
        tn[LC_T] = out[LC_T] + dt_i
        tn[LC_S] = torch.maximum(
            s, s + v * dt_i + 0.5 * a * (dt_i * dt_i)
            + div_const(j * _cube(dt_i), 6))
        tn[LC_V] = torch.clamp(v + a * dt_i + 0.5 * j * (dt_i * dt_i),
                               min=0.0)
        tn[LC_A] = a + j * dt_i
        tn[LC_J] = j
        tp = tn
    return torch.stack(rows)


def reeval_reference(nodes, pp_vec, path, dist_path, traj):
    """The plain version of :func:`reeval`'s pass (lon_kernel.py:455-474):
    every row of ``traj`` re-evaluated with its own jerk."""
    pp = unpack_lon_pp(pp_vec)
    traj = traj.to(torch.float32)
    return torch.stack([_eval_row(traj[i], i, nodes, dist_path, path, pp,
                                  False)[0] for i in range(traj.shape[0])])


# ---------------------------------------------------------------------
# the kernel entries


def _check(name, t, shape, dtype, dev):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(pp_vec, path, dist_path, dev, S):
    f32 = torch.float32
    _check("pp", pp_vec, (len(LON_PP_KEYS),), f32, dev)
    if path.dim() != 2 or path.shape[1] != 7 or path.shape[0] < 1:
        raise ValueError(f"path must be (P, 7), got {tuple(path.shape)}")
    _check("path", path, path.shape, f32, dev)
    if dist_path.dim() != 2 or dist_path.shape[1] != S:
        raise ValueError(f"dist_path must be (T, {S}), got "
                         f"{tuple(dist_path.shape)}")
    _check("dist_path", dist_path, dist_path.shape, f32, dev)


# ---------------------------------------------------------------------
# the backward kernel's blocks (csrc/lon_dp.cu lon_backward_kernel): a block
# takes one v and a tile of s rows, every a, and stages the box of the next
# slice that its (a, jerk) table reads

COORD_BYTES = 64            # one (a, jerk) entry of the table (struct Coord)
SM_SMEM = 228 * 1024        # shared memory of an SM (H100)
BLOCK_SMEM = 227 * 1024     # the most a block may use
SMEM_RESERVED = 1024        # what the card keeps of an SM's for each block
BLOCKS_PER_SM = 2           # the kernel's __launch_bounds__
MAX_THREADS = 384


def backward_smem_bytes(A, tile, P, box_cap):
    """Dynamic shared memory of a block of ``tile`` s rows over a path of
    ``P`` rows whose box holds ``box_cap`` floats (the kernel's
    backward_smem_bytes): the tile's results, the box (to 16 bytes), the
    (a, jerk) table, the path's v_max column, three floats an s row and
    four bounds a warp."""
    return (16 * tile * A + 16 * -(-box_cap // 4) + COORD_BYTES * A * NB
            + 4 * (P + 3 * tile) + 16 * (MAX_THREADS // 32))


def backward_threads(A, tile):
    """Threads of such a block: its (s, a) nodes at once, whole warps, 64 ..
    MAX_THREADS (the kernel's backward_threads)."""
    t = -(-(tile * A) // 32) * 32
    return min(max(t, 64), MAX_THREADS)


def backward_coords(pp_vec, S, V, A):
    """What bounds each block's box, from the (a, jerk) table every v's
    block forms, in float32 with the kernel's operations: (the row shift k,
    the lower and upper v rows y0, y1 of the lookup's corners), each an int
    array (V, A, NB)."""
    f32 = np.float32
    p = {k: f32(x) for k, x in zip(LON_PP_KEYS, np.asarray(pp_vec, f32))}

    def axis(lo, hi, n):
        i = np.arange(n, dtype=f32)
        return ((hi - lo) * i).astype(np.float64) \
            * np.float64(f32(1.0) / f32(n - 1)) + np.float64(lo)

    v = axis(p["v_min"], p["v_max"], V).astype(f32)[:, None, None]
    a = axis(p["a_min"], p["a_max"], A).astype(f32)[None, :, None]
    j = axis(p["j_min"], p["j_max"], NB).astype(f32)[None, None, :]
    dt = p["dt"]
    ds = (v * dt + f32(0.5) * a * dt * dt) \
        + j * (dt * (dt * dt)) * (f32(1.0) / f32(6.0))
    s_change = np.maximum(ds, f32(0.0))
    vn = np.maximum(v + a * dt + f32(0.5) * j * dt * dt, f32(0.0))
    s_step_x = (p["s_max"] - p["s_min"]) * (f32(1.0) / f32(S - 1))
    k = np.floor(s_change / s_step_x).astype(np.int64)
    y = np.minimum(np.maximum((vn - p["v_min"]) / (p["v_max"] - p["v_min"])
                              * f32(V - 1), f32(0.0)), f32(V - 1))
    y0 = np.floor(y).astype(np.int64)
    return k, y0, np.minimum(y0 + 1, V - 1)


def box_floats(pp_vec, S, V, A, tile):
    """Floats in the largest box of the next slice that any block of
    ``tile`` s rows stages: three planes (cost, constraint, jerk) of the
    rows its lookups read (the row shifts of its v's table over the tile,
    clamped) by a row of the v rows its corners span x every a, laid out
    with an odd stride."""
    k, y0, y1 = backward_coords(pp_vec, S, V, A)
    s0 = np.arange(0, S, tile)
    n_s = np.minimum(tile, S - s0)
    lo = np.clip(s0[None, :] + k.min(axis=(1, 2))[:, None], 0, S - 1)
    hi = np.clip((s0 + n_s)[None, :] + k.max(axis=(1, 2))[:, None], 0, S - 1)
    stride = ((y1.max(axis=(1, 2)) - y0.min(axis=(1, 2)) + 1) * A) | 1
    return 3 * int(((hi - lo + 1) * stride[:, None]).max())


def box_bytes(pp_vec, S, V, A, tile):
    """Bytes of the largest box a block of ``tile`` s rows stages."""
    return 4 * box_floats(pp_vec, S, V, A, tile)


def backward_plan(pp_vec, S, V, A, P, sms=132):
    """(tile, box_cap) of the backward kernel for the parameters ``pp_vec``
    (host values) over a path of ``P`` rows on a card of ``sms`` SMs: as
    many s tiles as let the grid of V x tiles blocks run in one wave at
    BLOCKS_PER_SM blocks an SM, then smaller tiles until the largest box
    lets BLOCKS_PER_SM blocks share an SM, else until it fits one block.
    Raises ValueError where even one s row's box does not fit a block."""
    n = max(1, BLOCKS_PER_SM * sms // V)
    start = -(-S // n)
    budgets = (SM_SMEM // BLOCKS_PER_SM - SMEM_RESERVED, BLOCK_SMEM)
    for budget in budgets:
        for tile in range(start, 0, -1):
            cap = box_floats(pp_vec, S, V, A, tile)
            if backward_smem_bytes(A, tile, P, cap) <= budget:
                return tile, cap
    need = backward_smem_bytes(A, 1, P, box_floats(pp_vec, S, V, A, 1))
    raise ValueError(
        f"lon_dp_backward: a block of one s row needs {need} B of shared "
        f"memory for its box of the next slice ({S} x {V} x {A} nodes), "
        f"above the {BLOCK_SMEM} B a block may use")


_PLANS = {}


def _plan(pp_vec, S, V, A, P):
    """:func:`backward_plan` for the parameters in the CUDA tensor
    ``pp_vec``: read to the host once per tensor and version (a solve's
    slices share one), kept for the last few."""
    key = (id(pp_vec), pp_vec._version, S, V, A, P)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is pp_vec:
        return hit[1]
    sms = torch.cuda.get_device_properties(
        pp_vec.device).multi_processor_count
    plan = backward_plan(pp_vec.cpu().numpy(), S, V, A, P, sms)
    if len(_PLANS) >= 8:
        _PLANS.clear()
    _PLANS[key] = (weakref.ref(pp_vec), plan)
    return plan


def backward_slice(nodes_next, pp_vec, path, dist_path, t_idx, is_last,
                   out=None):
    """One backward slice (S, V, A, 4) from ``nodes_next`` (S, V, A, 4):
    the kernel ``lon_dp_backward`` on a CUDA tensor (written into ``out``
    when given), :func:`backward_slice_reference` on a CPU tensor.  ``pp``
    is the packed float32 parameter vector (:data:`LON_PP_KEYS`), ``path``
    (P, 7), ``dist_path`` (T, S), ``t_idx`` the slice's row of
    ``dist_path``; all float32 and contiguous on one device."""
    global launches, backward_launches
    if nodes_next.dim() != 4 or nodes_next.shape[-1] != 4:
        raise ValueError(f"nodes_next must be (S, V, A, 4), got "
                         f"{tuple(nodes_next.shape)}")
    S, V, A, _ = nodes_next.shape
    dev = nodes_next.device
    _check("nodes_next", nodes_next, (S, V, A, 4), torch.float32, dev)
    _check_common(pp_vec, path, dist_path, dev, S)
    if not 0 <= t_idx < dist_path.shape[0]:
        raise ValueError(f"t_idx {t_idx} outside 0..{dist_path.shape[0] - 1}")
    if dev.type == "cpu":
        res = backward_slice_reference(nodes_next, pp_vec, path, dist_path,
                                       t_idx, is_last)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if dev.type != "cuda":
        raise ValueError(f"lon_dp: unsupported device {dev}")
    if out is None:
        out = torch.empty_like(nodes_next)
    else:
        _check("out", out, (S, V, A, 4), torch.float32, dev)
    tile, box_cap = _plan(pp_vec, S, V, A, path.shape[0])
    lib = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lon_dp_backward(
            nodes_next.data_ptr(), pp_vec.data_ptr(), path.data_ptr(),
            dist_path.data_ptr(), out.data_ptr(), S, V, A, path.shape[0],
            int(t_idx), int(bool(is_last)), tile, box_cap, stream)
    if err != 0:
        raise RuntimeError(f"lon_dp_backward launch failed: CUDA error {err}")
    launches += 1
    backward_launches += 1
    return out


# the profiling instantiation's phases (csrc/lon_dp.cu FwdPhase): lane 0's
# clock64() cycles over the forward pass's steps
FORWARD_PHASES = ("stage", "lookup", "terms", "pick", "next")


def _forward_entry(nodes, pp_vec, path, dist_path, states, mode, prof=None):
    global launches, forward_launches
    if nodes.dim() != 5 or nodes.shape[-1] != 4:
        raise ValueError(f"nodes must be (T, S, V, A, 4), got "
                         f"{tuple(nodes.shape)}")
    T, S, V, A, _ = nodes.shape
    dev = nodes.device
    _check("nodes", nodes, nodes.shape, torch.float32, dev)
    _check_common(pp_vec, path, dist_path, dev, S)
    if dist_path.shape[0] != T:
        raise ValueError(f"dist_path has {dist_path.shape[0]} rows, nodes "
                         f"{T} slices")
    n_rows = T if mode == 0 else states.shape[0]
    _check("states", states, (7,) if mode == 0 else (n_rows, 7),
           torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"lon_dp: unsupported device {dev}")
    P = path.shape[0]
    lib = _kernel()
    # the block's shared memory, by the kernel's own formula: the path's s
    # and v_max columns and the (T, S) distance map staged once, and the
    # helper warp's candidates
    need = lib.lon_dp_forward_smem_bytes(T, S, P)
    if need > BLOCK_SMEM:
        raise ValueError(
            f"lon_dp_forward: staging the path ({P} rows) and the distance "
            f"map ({T} x {S}) needs {need} B of shared memory, above the "
            f"{BLOCK_SMEM} B a block may use")
    out = torch.empty((n_rows, 7), dtype=torch.float32, device=dev)
    head = (nodes.data_ptr(), pp_vec.data_ptr(), path.data_ptr(),
            dist_path.data_ptr(), states.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if prof is None:
            err = lib.lon_dp_forward(*head, T, S, V, A, P, n_rows, int(mode),
                                     stream)
        else:
            err = lib.lon_dp_forward_profile(*head, prof.data_ptr(), T, S, V,
                                             A, P, stream)
    if err != 0:
        raise RuntimeError(f"lon_dp_forward launch failed: CUDA error {err}")
    launches += 1
    forward_launches += 1
    return out


def forward(nodes, pp_vec, path, dist_path, x0):
    """The forward pass (T, 7) from the start state ``x0`` (7,): one launch
    of ``lon_dp_forward`` on a CUDA tensor, :func:`forward_reference` on a
    CPU tensor."""
    if nodes.device.type == "cpu":
        return forward_reference(nodes, pp_vec, path, dist_path, x0)
    return _forward_entry(nodes, pp_vec, path, dist_path,
                          x0.to(torch.float32).contiguous(), 0)


def forward_profile(nodes, pp_vec, path, dist_path, x0):
    """The forward pass through the kernel's profiling instantiation (CUDA
    tensors only): (the trajectory, which the plain instantiation's equals
    bit for bit, and lane 0's cycles by phase, :data:`FORWARD_PHASES`)."""
    if nodes.device.type != "cuda":
        raise ValueError("forward_profile needs CUDA tensors")
    prof = torch.zeros(len(FORWARD_PHASES), dtype=torch.int64,
                       device=nodes.device)
    out = _forward_entry(nodes, pp_vec, path, dist_path,
                         x0.to(torch.float32).contiguous(), 0, prof)
    return out, dict(zip(FORWARD_PHASES, prof.cpu().tolist()))


def reeval_pass(nodes, pp_vec, path, dist_path, traj):
    """Re-evaluates every row of ``traj`` (N, 7) with its own jerk: one
    launch of ``lon_dp_forward`` (reeval mode) on a CUDA tensor,
    :func:`reeval_reference` on a CPU tensor."""
    if nodes.device.type == "cpu":
        return reeval_reference(nodes, pp_vec, path, dist_path, traj)
    return _forward_entry(nodes, pp_vec, path, dist_path,
                          traj.to(torch.float32).contiguous(), 1)


def make_lon_solver(spec):
    """spec: t_steps, s_steps, v_steps, a_steps, path_steps.  Returns
    (solve, reeval) on the device of their tensor arguments."""
    T = spec["t_steps"]
    S = spec["s_steps"]
    V = spec["v_steps"]
    A = spec["a_steps"]

    def solve(dist_path, path, pp_vec, x0):
        """dist_path: (T, S); path: (P, 7); x0: (7,) lon state; pp_vec the
        packed float32 parameter vector.  Returns the nodes (T, S, V, A, 4)
        (``nodes[0]`` zeros) and the forward trajectory (T, 7)."""
        nodes = torch.zeros((T, S, V, A, 4), dtype=torch.float32,
                            device=dist_path.device)
        backward_slice(nodes[T - 1], pp_vec, path, dist_path, T - 1, True,
                       out=nodes[T - 1])
        for i in range(T - 2, 0, -1):
            backward_slice(nodes[i + 1], pp_vec, path, dist_path, i, False,
                           out=nodes[i])
        traj = forward(nodes, pp_vec, path, dist_path, x0)
        return nodes, traj

    def reeval(dist_path, path, pp_vec, traj, nodes):
        """Re-evaluate a stored trajectory (lonReevalNode)."""
        return reeval_pass(nodes, pp_vec, path, dist_path, traj)

    return solve, reeval


# ---------------------------------------------------------------------
# bounds

# Operations of one node-jerk of a backward slice as the plain version
# defines them (next state 14, the lookup's coordinates and weights 22, the
# 8 corners of 3 channels and the blend 45, cost and constraint 22, the
# path lookup 8, the comparison 2), and of one node beside its jerks (its
# grid values, path and distance lookups, state terms: 35).
OPS = dict(node_jerk=113, node=35, fwd_action=125, fwd_step=40)
# A node's critical path: the next state's chain, the lookup's coordinate
# division, two dependent loads, the blend and the cost chain, then the 9
# jerks' comparison (one after another in the kernel's loop).
CHAIN_NODE = dict(f32_div=3, f32_mul=8, f32_add=20, smem_load=2)
# A forward step's critical path: the state terms, one action's lookup and
# cost (lanes side by side), a five-level warp reduction, the next state.
CHAIN_FWD_STEP = dict(f32_div=4, f32_mul=12, f32_add=40, smem_load=8)


def traffic_bytes(S, V, A, P, T):
    """Bytes one backward slice must move: the next nodes, the path, the
    distance map and the parameters read once, the nodes written once."""
    nodes = S * V * A * 4
    return 4 * (nodes + P * 7 + T * S + len(LON_PP_KEYS) + nodes)


def operations(S, V, A):
    """Operations of one backward slice."""
    return S * V * A * (NB * OPS["node_jerk"] + OPS["node"])


def bound_ms(S, V, A, P, T):
    """(ms, "bytes" or "operations"): the roofline bound of one slice."""
    return _latency.roofline_ms(traffic_bytes(S, V, A, P, T),
                                operations(S, V, A), "float32")


def chain_ms(cycles, sm_mhz):
    """One node's critical path (the nodes are independent)."""
    ops = _latency.add_ops({}, CHAIN_NODE, NB)
    return _latency.chain_ms(ops, cycles, sm_mhz)


def forward_traffic_bytes(S, V, A, P, T, rows):
    """Bytes the forward pass must move: the 8 corners of 3 channels per
    action and step it reads, the path rows and distances it looks up, the
    start and the parameters, the trajectory written once."""
    return 4 * (rows * NF * (8 * 3 + 2 * 2 + 1) + 7
                + len(LON_PP_KEYS) + rows * 7)


def forward_operations(rows, actions=NF):
    return rows * (actions * OPS["fwd_action"] + OPS["fwd_step"])


def forward_bound_ms(S, V, A, P, T, rows=None, actions=NF):
    rows = T if rows is None else rows
    return _latency.roofline_ms(forward_traffic_bytes(S, V, A, P, T, rows),
                                forward_operations(rows, actions), "float32")


def forward_chain_ms(T, cycles, sm_mhz):
    """T dependent steps."""
    return _latency.chain_ms(_latency.add_ops({}, CHAIN_FWD_STEP, T),
                             cycles, sm_mhz)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library, and load its code
    onto the current device with the shared-memory limit set, so that the
    first launch does not pay for either."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("lon_dp")
        lib.lon_dp_backward.restype = ctypes.c_int
        lib.lon_dp_backward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.lon_dp_prepare.restype = ctypes.c_int
        lib.lon_dp_prepare.argtypes = []
        lib.lon_dp_forward.restype = ctypes.c_int
        lib.lon_dp_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.lon_dp_forward_profile.restype = ctypes.c_int
        lib.lon_dp_forward_profile.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.lon_dp_forward_smem_bytes.restype = ctypes.c_size_t
        lib.lon_dp_forward_smem_bytes.argtypes = [ctypes.c_int] * 3
        for fn in (lib.lon_dp_n_params, lib.lon_dp_n_forward_phases):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if lib.lon_dp_n_params() != len(LON_PP_KEYS) \
                or lib.lon_dp_n_forward_phases() != len(FORWARD_PHASES):
            raise RuntimeError("lon_dp.cu and LON_PP_KEYS / FORWARD_PHASES "
                               "disagree")
        _build.prepare(lib, "lon_dp")
        _LIB = lib
    return _LIB
