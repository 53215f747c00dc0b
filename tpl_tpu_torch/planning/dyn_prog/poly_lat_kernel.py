"""
Polynomial lateral path planner: samples a (l_dst, s_dst) grid of quintic
lateral polynomials, evaluates per-arclength costs / times / collisions
against the DP environment, and selects the best path.  (reference:
library/src/dyn_prog/poly_lat_planner.cu; the JAX package's form is
tpl_tpu/planning/dyn_prog/poly_lat_kernel.py)

Candidate/selection layout mirrors PolyLatTrajPoint / path_nodes
(poly_lat_planner.cuh:64-108).

One device entry lives here, a hand-written kernel of ``csrc/poly_lat.cu``
on a CUDA tensor and a plain PyTorch version on a CPU tensor: the candidate
sweep and the order-dependent selection in one launch
(:func:`sweep_select`; kernel ``poly_lat_sweep_select``, one block per
candidate, a thread a sample, the last block to finish taking the
selection; its profiling instantiation, :func:`sweep_profile`; plain
:func:`evaluate_reference` and :func:`select_reference`, the device twin of
the host :func:`select_path`).  :func:`sweep` (and
:func:`make_poly_lat_kernel`'s ``evaluate``) return its maps alone.

Dtypes are the JAX program's (the JAX package turns x64 on): the float64
Hermite inverse promotes the quintics, the geometry and the cost to
float64; the occupancy lookups' s index and the collision distance stay
float32.  ``evaluate`` returns (collision_dist float32, traj_cost
float64); the selection compares both as float32.  ``launches`` counts the
kernel's launches.
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.ops.splines import PolyQuintic, _HERMITE_INV
from tpl_tpu_torch.ops.interp import short_angle_dist, lerp_xs
from tpl_tpu_torch.planning.dyn_prog.lon_kernel import axis_points, fma32
from tpl_tpu_torch.planning.dyn_prog.latlon_action_min import div_const

THREADS = 256           # a block of the kernel (csrc/poly_lat.cu THREADS)

launches = 0            # kernel launches since import (reset freely)

# PolyLatTraj point columns
TC_T, TC_L, TC_DL, TC_DDL, TC_DDDL, TC_S, TC_V, TC_X, TC_Y, TC_H, \
    TC_DIST, TC_K = range(12)

# the occupancy lookups of one sample: time offsets x lateral offsets
T_SWEEP = (-1.0, 0.0, 1.0)
DL_OFF = (0.0, 0.25, -0.25)


class PolyLatParams:
    """(reference: poly_lat_planner.cuh:11-61)"""

    def __init__(self):
        self.l_min = -5.0
        self.l_max = 5.0
        self.s_min = 0.0
        self.s_max = 200.0
        self.s_steps = 201

        self.l_dst_min = -5.0
        self.l_dst_max = 5.0
        self.s_dst_min = 10.0
        self.s_dst_max = 70.0
        self.l_dst_steps = 21
        self.s_dst_steps = 13

        self.l_trg = 0.0

        self.w_l = 1.0
        self.w_k = 0.1
        self.w_dl = 0.0
        self.w_ddl = 0.0
        self.w_dddl = 1.0
        self.w_right = 0.0
        self.w_len = 0.0001

        self.k_abs_max = 1.0
        self.a_lat_abs_max = 2.5

        self.width_veh = 2.0
        self.length_veh = 2.0

    def packed(self):
        """All dynamic params as ONE f32 vector: a single host->device
        transfer per call instead of one per scalar."""
        return np.array([getattr(self, k) for k in PL_PP_KEYS],
                        dtype=np.float32)


PL_PP_KEYS = ("l_min", "l_max", "s_min", "s_max", "l_dst_min", "l_dst_max",
              "s_dst_min", "s_dst_max", "l_trg", "w_l", "w_k", "w_dl",
              "w_ddl", "w_dddl", "w_right", "w_len", "k_abs_max",
              "a_lat_abs_max", "width_veh", "length_veh")

ENV_PP_KEYS = ("dt_start", "dt", "s_min", "s_max", "l_min", "l_max")


def pack_env_pp(env_params):
    """DpEnvironment params -> packed f32 vector for occupancy lookups."""
    return np.array([getattr(env_params, k) for k in ENV_PP_KEYS],
                    dtype=np.float32)


def candidate_targets(pp, LD, SD):
    """The (l_dst (LD,), s_dst (SD,)) candidate grid, float32."""
    dev = pp["l_dst_min"].device
    f32 = torch.float32
    l_dst = axis_points(pp["l_dst_min"], pp["l_dst_max"],
                        torch.arange(LD, dtype=f32, device=dev), max(LD - 1, 1))
    s_dst = axis_points(pp["s_dst_min"], pp["s_dst_max"],
                        torch.arange(SD, dtype=f32, device=dev), max(SD - 1, 1))
    return l_dst, s_dst


def sample_stations(pp, s0, S):
    """The (S,) stations s0 + s_min + i * s_step of the lateral samples."""
    s_step = div_const(pp["s_max"] - pp["s_min"], S - 1)
    return fma32(torch.arange(S, dtype=torch.float32, device=s0.device),
                 s_step, s0 + pp["s_min"])


def ref_lerp(ref_line, ref_step, s):
    """Linear-interp ref line channels at s (RefLine::lerp)."""
    n = ref_line.shape[0]
    q = s / ref_step
    i0f = torch.clamp(torch.floor(q), 0, n - 1)
    i1 = torch.clamp(torch.ceil(q), 0, n - 1).long()
    a = torch.clamp(q - i0f, 0.0, 1.0)[..., None]
    return ref_line[i0f.long()] * (1.0 - a) + ref_line[i1] * a


def evaluate_reference(occ_map, ref_line, ref_step, pp_vec, env_vec, start,
                       LD, SD, S):
    """The plain version of the candidate sweep (the JAX package's
    ``evaluate``, poly_lat_kernel.py:121-223): per candidate (LD, SD), the
    collision distance (float32) and the trajectory cost (float64)."""
    f64 = torch.float64
    pp = {k: pp_vec[i] for i, k in enumerate(PL_PP_KEYS)}
    ep = {k: env_vec[i] for i, k in enumerate(ENV_PP_KEYS)}
    TE, SE, LE = occ_map.shape
    dev = occ_map.device
    l0, dl0, ddl0, s0, v0 = (start[i] for i in range(5))

    l_dst, s_dst = candidate_targets(pp, LD, SD)
    ss = sample_stations(pp, s0, S)                                 # (S,)

    shape = (LD, SD)
    poly = PolyQuintic(s0.expand(shape), l0.expand(shape), dl0.expand(shape),
                       ddl0.expand(shape), (s0 + s_dst[None, :]).expand(shape),
                       l_dst[:, None].expand(shape),
                       torch.zeros(shape, dtype=torch.float32, device=dev),
                       torch.zeros(shape, dtype=torch.float32, device=dev))
    xq = ss[:, None, None].expand(S, LD, SD)

    def ev(fn):
        return fn(xq).permute(1, 2, 0)                             # (LD,SD,S)

    sb = ss[None, None, :].expand(LD, SD, S)
    past_end = sb >= (s0 + s_dst[None, :, None])
    zero = torch.zeros((), dtype=f64, device=dev)
    l = torch.where(past_end, l_dst[:, None, None].to(f64), ev(poly.f))
    dl = torch.where(past_end, zero, ev(poly.df))
    ddl = torch.where(past_end, zero, ev(poly.ddf))
    dddl = torch.where(past_end, zero, ev(poly.dddf))

    rp = ref_lerp(ref_line, ref_step, ss)                           # (S, 8)
    rp_x, rp_y, rp_h, rp_k = rp[:, 0], rp[:, 1], rp[:, 2], rp[:, 3]
    rp_v, rp_dl, rp_dr = rp[:, 4], rp[:, 5], rp[:, 6]

    heading_frenet = torch.atan(dl)
    x = rp_x - torch.sin(rp_h) * l
    y = rp_y + torch.cos(rp_h) * l
    k = ((ddl / (dl * dl + 1.0) + rp_k) * torch.cos(heading_frenet)
         / (1.0 - l * rp_k))

    k_abs_path = torch.maximum(torch.abs(k), torch.abs(rp_k).to(f64))
    a_lat = pp["a_lat_abs_max"]
    v = torch.where(k_abs_path > 1e-6,
                    torch.minimum(rp_v.to(f64), torch.sqrt(
                        a_lat / torch.clamp(k_abs_path, min=1e-9))),
                    rp_v.to(f64))

    # local constraints (poly_lat_planner.cu:64-76)
    constr = torch.clamp(torch.minimum(rp_v, v0) ** 2 * torch.abs(k)
                         - a_lat, min=0.0)
    in_poly = sb <= (s0 + s_dst[None, :, None])
    margin = (pp["width_veh"] * 0.5).to(f64) * np.sqrt(2.0)
    constr = constr + torch.where(in_poly, torch.clamp(
        torch.abs(k) - pp["k_abs_max"], min=0.0), zero)
    constr = constr + torch.where(in_poly, torch.clamp(
        l - (rp_dl.to(f64) - margin), min=0.0), zero)
    constr = constr + torch.where(in_poly, torch.clamp(
        (-rp_dr.to(f64) + margin) - l, min=0.0), zero)

    # local cost (poly_lat_planner.cu:78-92)
    cost = (pp["w_dl"] * dl ** 2 + pp["w_ddl"] * ddl ** 2
            + pp["w_dddl"] * dddl ** 2)
    cost = cost + torch.where(torch.abs(k) > torch.abs(rp_k),
                              pp["w_k"] * k ** 2, zero)
    cost = cost + 10e6 * constr

    # path times (poly_lat_planner.cu:102-148)
    dx = torch.diff(x, dim=-1)
    dy = torch.diff(y, dim=-1)
    d = torch.sqrt(dx * dx + dy * dy)
    dt_seg = d / torch.clamp(v[..., 1:], min=1.0)
    t = torch.cat([torch.zeros((LD, SD, 1), dtype=f64, device=dev),
                   torch.cumsum(dt_seg, dim=-1)], dim=-1)

    # collision checks (poly_lat_planner.cu:150-185): interpDistField
    # (env.cu:229-239) with the dt_start time mapping
    def occ_lookup(tq, s, lq):
        t_idx = torch.where(tq < ep["dt_start"], zero,
                            torch.round((tq - ep["dt_start"]) / ep["dt"])
                            + 1.0)
        ti = torch.clamp(t_idx, 0, TE - 1).long()
        si = torch.clamp(torch.round((s - ep["s_min"])
                                     / (ep["s_max"] - ep["s_min"])
                                     * (SE - 1)), 0, SE - 1).long()
        li = torch.clamp(torch.round((lq - ep["l_min"])
                                     / (ep["l_max"] - ep["l_min"])
                                     * (LE - 1)), 0, LE - 1).long()
        return occ_map[ti, si, li]

    dist_sem = torch.zeros((LD, SD, S), dtype=torch.float32, device=dev)
    for t_sweep in T_SWEEP:
        for dl_off in DL_OFF:
            dist_sem = torch.maximum(dist_sem, occ_lookup(
                t + t_sweep, sb, l + dl_off))
    collision = dist_sem > 0.0
    coll_z = torch.where(collision & (t < 8.0) & (sb > pp["length_veh"]),
                         sb, torch.full_like(sb, 10000.0))

    # aggregate (poly_lat_planner.cu:187-225)
    traj_cost = torch.sum(cost, dim=-1)
    collision_dist = torch.clamp(torch.amin(coll_z, dim=-1), max=1000.0)
    f32_zero = torch.zeros((), dtype=torch.float32, device=dev)
    traj_cost = traj_cost + torch.where(l_dst[:, None] < -0.1,
                                        pp["w_right"], f32_zero)
    traj_cost = traj_cost + pp["w_l"] * (l_dst[:, None] - pp["l_trg"]) ** 2
    traj_cost = traj_cost + pp["w_len"] * torch.abs(s_dst[None, :])
    return collision_dist, traj_cost


def _check(name, t, shape, dtype, dev):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_INV = {}


def _hermite_inv(dev):
    """The quintic's float64 Hermite inverse on ``dev`` (made once)."""
    inv = _INV.get(dev)
    if inv is None:
        inv = _INV[dev] = torch.as_tensor(_HERMITE_INV[5], dtype=torch.float64,
                                          device=dev).contiguous()
    return inv


def sweep_select(occ_map, ref_line, ref_step, pp_vec, env_vec, start, LD,
                 SD, S, prof=None):
    """The candidate sweep and the selection: (collision_dist (LD, SD)
    float32, traj_cost (LD, SD) float64, the winner's flat index (int64,
    0-d), its cost (float32, 0-d)).  One launch of ``poly_lat_sweep_select``
    on a CUDA tensor (no host sync), :func:`evaluate_reference` and
    :func:`select_reference` on a CPU tensor.  ``occ_map`` (TE, SE, LE),
    ``ref_line`` (n, 8), ``ref_step`` one element, ``pp_vec``
    (:data:`PL_PP_KEYS`; the selection takes its ``length_veh``),
    ``env_vec`` (:data:`ENV_PP_KEYS`), ``start`` [l, dl, ddl, s, v];
    float32, contiguous, on one device."""
    global launches
    dev = occ_map.device
    f32 = torch.float32
    if occ_map.dim() != 3:
        raise ValueError(f"occ_map must be (T, S, L), got "
                         f"{tuple(occ_map.shape)}")
    _check("occ_map", occ_map, occ_map.shape, f32, dev)
    if ref_line.dim() != 2 or ref_line.shape[1] != 8 or ref_line.shape[0] < 1:
        raise ValueError(f"ref_line must be (n, 8), got "
                         f"{tuple(ref_line.shape)}")
    _check("ref_line", ref_line, ref_line.shape, f32, dev)
    _check("ref_step", ref_step.reshape(1), (1,), f32, dev)
    _check("pp", pp_vec, (len(PL_PP_KEYS),), f32, dev)
    _check("env_pp", env_vec, (len(ENV_PP_KEYS),), f32, dev)
    _check("start", start, (5,), f32, dev)
    if LD < 1 or SD < 1 or S < 2:
        raise ValueError(f"{LD} x {SD} candidates of {S} samples: outside "
                         "what the sweep takes")
    if dev.type == "cpu":
        cd, tc = evaluate_reference(occ_map, ref_line, ref_step, pp_vec,
                                    env_vec, start, LD, SD, S)
        lv = pp_vec[PL_PP_KEYS.index("length_veh")]
        return (cd, tc) + select_reference(cd, tc, lv, LD, SD)
    if dev.type != "cuda":
        raise ValueError(f"poly_lat: unsupported device {dev}")
    lib = _kernel()
    if S > lib.poly_lat_max_samples():
        raise ValueError(f"{S} samples: the sweep takes at most "
                         f"{lib.poly_lat_max_samples()}")
    if LD * SD > lib.poly_lat_max_candidates():
        raise ValueError(f"{LD} x {SD} candidates: the launch takes at most "
                         f"{lib.poly_lat_max_candidates()} (its last block "
                         "stages every candidate's cd and cost, 8 bytes "
                         "each, in the shared memory a block has without "
                         "opting in)")
    from tpl_tpu_torch import _build

    cd = torch.empty((LD, SD), dtype=f32, device=dev)
    tc = torch.empty((LD, SD), dtype=torch.float64, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    TE, SE, LE = occ_map.shape
    inv = _hermite_inv(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter = _build.arrival_counter(dev, stream)
        head = (occ_map.data_ptr(), ref_line.data_ptr(), ref_step.data_ptr(),
                pp_vec.data_ptr(), env_vec.data_ptr(), start.data_ptr(),
                inv.data_ptr(), cd.data_ptr(), tc.data_ptr(), best.data_ptr(),
                cost.data_ptr(), counter.data_ptr())
        tail = (LD, SD, S, TE, SE, LE, ref_line.shape[0])
        if prof is None:
            err = lib.poly_lat_sweep_select(*head, *tail, stream)
        else:
            err = lib.poly_lat_sweep_select_profile(*head, prof.data_ptr(),
                                                    *tail, stream)
    if err != 0:
        raise RuntimeError(f"poly_lat_sweep_select launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return cd, tc, best, cost


def sweep(occ_map, ref_line, ref_step, pp_vec, env_vec, start, LD, SD, S):
    """The candidate maps of :func:`sweep_select`: (collision_dist (LD, SD)
    float32, traj_cost (LD, SD) float64)."""
    return sweep_select(occ_map, ref_line, ref_step, pp_vec, env_vec, start,
                        LD, SD, S)[:2]


# the profiling instantiation's phases (csrc/poly_lat.cu Phase): thread 0's
# clock64() cycles of each block, summed over the blocks (the selection's
# the last block's alone)
SWEEP_PHASES = ("coefficients", "samples", "segments", "times", "collision",
                "reduce", "arrive", "select")


def sweep_profile(occ_map, ref_line, ref_step, pp_vec, env_vec, start, LD,
                  SD, S):
    """The sweep and selection through the kernel's profiling
    instantiation (CUDA tensors only, checked as :func:`sweep_select`):
    (collision_dist, traj_cost, best, cost), which the plain
    instantiation's equal bit for bit, and thread 0's cycles by phase
    summed over the blocks (:data:`SWEEP_PHASES`)."""
    if occ_map.device.type != "cuda":
        raise ValueError("sweep_profile needs CUDA tensors")
    prof = torch.zeros(len(SWEEP_PHASES), dtype=torch.int64,
                       device=occ_map.device)
    out = sweep_select(occ_map, ref_line, ref_step, pp_vec, env_vec, start,
                       LD, SD, S, prof)
    return out + (dict(zip(SWEEP_PHASES, prof.cpu().tolist())),)


def make_poly_lat_kernel(spec):
    """spec: s_steps, l_dst_steps, s_dst_steps, t_steps (env), + env grid
    sizes s_steps_env, l_steps_env for occupancy lookups.  Returns
    ``evaluate(occ_map, ref_line, ref_step, pp, env_pp, start)`` ->
    (collision_dist, traj_cost), on the device of ``occ_map``; ``pp`` /
    ``env_pp`` / ``start`` may be host arrays (then uploaded)."""
    S = spec["s_steps"]
    LD = spec["l_dst_steps"]
    SD = spec["s_dst_steps"]

    def evaluate(occ_map, ref_line, ref_step, pp, env_pp, start):
        dev = occ_map.device

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32)
                                   if not isinstance(x, torch.Tensor) else x,
                                   dtype=torch.float32, device=dev)

        return sweep(occ_map, ref_line, f32(ref_step), f32(pp), f32(env_pp),
                     f32(start), LD, SD, S)

    return evaluate


def select_path(collision_dist, traj_cost, length_veh, l_dst_steps,
                s_dst_steps):
    """Sequential best-path selection (poly_lat_planner.cu:227-268).
    Host-side: an order-dependent scan."""
    cd = np.asarray(collision_dist)
    tc = np.asarray(traj_cost)
    min_idx_l = min(l_dst_steps // 2 + 1, l_dst_steps - 1)
    min_idx_s = s_dst_steps - 1
    max_cd = cd[min_idx_l, min_idx_s]
    min_cost = np.inf

    for il in range(l_dst_steps):
        for isd in range(s_dst_steps):
            if tc[il, isd] >= 1e6:
                continue
            if cd[il, isd] > max_cd + length_veh:
                max_cd = cd[il, isd]

    for il in range(l_dst_steps):
        for isd in range(s_dst_steps):
            if abs(cd[il, isd] - max_cd) > 1.0:
                continue
            if tc[il, isd] < min_cost:
                min_cost = tc[il, isd]
                max_cd = cd[il, isd]
                min_idx_l = il
                min_idx_s = isd

    return min_idx_l, min_idx_s


def _select_passes(cd, tc, length_veh, LD, SD):
    """The selection's two passes in flat (il, isd) order, every value and
    comparison in float32: (best flat index, min_cost, how many steps of
    the passes changed their state)."""
    f32 = np.float32
    c = cd.reshape(-1).to(torch.float32).cpu().numpy()
    t = tc.reshape(-1).to(torch.float32).cpu().numpy()
    lv = f32(length_veh.reshape(()).item()) \
        if isinstance(length_veh, torch.Tensor) else f32(length_veh)
    init_flat = min(LD // 2 + 1, LD - 1) * SD + SD - 1
    max_cd, updates = c[init_flat], 0
    for i in range(LD * SD):
        if t[i] < f32(1e6) and c[i] > f32(max_cd + lv):
            max_cd, updates = c[i], updates + 1
    min_cost, best = f32(np.inf), init_flat
    for i in range(LD * SD):
        if abs(f32(c[i] - max_cd)) <= f32(1.0) and t[i] < min_cost:
            max_cd, min_cost, best = c[i], t[i], i
            updates += 1
    return best, min_cost, updates


def select_reference(cd, tc, length_veh, LD, SD):
    """The plain version of the device selection (the JAX package's
    ``select_path_device``, poly_chain_kernel.py:78-113): the two passes in
    flat (il, isd) order, every value and comparison in float32.  Returns
    (best flat index int64, min_cost float32) as 0-d tensors on the device
    of ``cd``."""
    best, min_cost, _ = _select_passes(cd, tc, length_veh, LD, SD)
    dev = cd.device
    return (torch.tensor(best, dtype=torch.int64, device=dev),
            torch.tensor(min_cost, dtype=torch.float32, device=dev))


class PolyLatTraj:
    """Lateral trajectory: points (N, 12), see TC_* columns.
    (reference: poly_lat_planner.cuh:78-92, poly_lat_planner.cu:271-333)"""

    def __init__(self, points=None):
        self.points = points if points is not None else np.zeros((1, 12))
        self.cost = 0.0

    def copy(self):
        t = PolyLatTraj(self.points.copy())
        t.cost = self.cost
        return t

    def lerp(self, distance):
        """Vectorized interp by the distance column."""
        d = self.points[:, TC_DIST]
        distance = np.atleast_1d(np.asarray(distance, dtype=np.float64))
        idx = np.clip(np.searchsorted(d, distance, side="right") - 1,
                      0, max(len(d) - 2, 0))
        j = np.minimum(idx + 1, len(d) - 1)
        denom = np.maximum(d[j] - d[idx], 1e-9)
        a = np.clip((distance - d[idx]) / denom, 0.0, 1.0)[:, None]
        res = self.points[idx] * (1.0 - a) + self.points[j] * a
        res[:, TC_H] = self.points[idx, TC_H] + short_angle_dist(
            self.points[idx, TC_H], self.points[j, TC_H]) * a[:, 0]
        return res

    def lerp_one(self, distance):
        return self.lerp([distance])[0]

    def insert_after_station(self, s, other):
        """Keep points with s < given station, append other's points.
        (poly_lat_planner.cu:297-310)"""
        keep = self.points[self.points[:, TC_S] < s]
        self.points = np.vstack([keep, other.points])
        self.update_time_dist_curv()

    def update_time_dist_curv(self):
        """(poly_lat_planner.cu:312-333)"""
        p = self.points
        n = len(p)
        if n < 2:
            return
        dx = np.diff(p[:, TC_X])
        dy = np.diff(p[:, TC_Y])
        d = np.hypot(dx, dy)
        p[:-1, TC_K] = short_angle_dist(p[:-1, TC_H], p[1:, TC_H]) \
            / np.maximum(d, 1e-9)
        p[-1, TC_K] = p[-2, TC_K]
        p[:, TC_DIST] = np.concatenate([[0.0], np.cumsum(d)])
        dt_seg = d / np.maximum(p[:-1, TC_V], 1e-9)
        p[:, TC_T] = np.concatenate([[0.0], np.cumsum(dt_seg)])


class PolyLatPlanner:
    """Stateful wrapper mirroring the reference PolyLatPlanner API (the
    JAX package's ``PolyLatPlannerJax``): the candidate sweep on the
    device, the selection and the winner's expansion on the host."""

    def __init__(self):
        self.params = PolyLatParams()
        self._kernel = None
        self._spec = None

    def reinit_buffers(self, params):
        self.params = params

    def _get_kernel(self, env):
        ep = env.params
        spec = dict(s_steps=self.params.s_steps,
                    l_dst_steps=self.params.l_dst_steps,
                    s_dst_steps=self.params.s_dst_steps,
                    t_steps_env=ep.t_steps, s_steps_env=ep.s_steps,
                    l_steps_env=ep.l_steps)
        if self._spec != spec:
            self._kernel = make_poly_lat_kernel(spec)
            self._spec = spec
        return self._kernel

    def update(self, start, env):
        """start: dict/array-like with l, dl, ddl, s, v. env: DpEnvironment
        with its grid built.  Returns PolyLatTraj."""
        p = self.params
        kernel = self._get_kernel(env)

        start_vec = np.asarray([start["l"], start["dl"], start["ddl"],
                                start["s"], start["v"]], np.float32)
        cd, tc = kernel(env.grid.occ_map, env.grid.ref_line,
                        np.float32(env.ref_step), p.packed(),
                        pack_env_pp(env.params), start_vec)
        cd, tc = cd.cpu().numpy(), tc.cpu().numpy()
        il, isd = select_path(cd, tc, p.length_veh, p.l_dst_steps,
                              p.s_dst_steps)

        # expand winner on host (poly_lat_planner.cu:440-485)
        l_dst = p.l_dst_min + (p.l_dst_max - p.l_dst_min) \
            * il / max(p.l_dst_steps - 1, 1)
        s_dst = p.s_dst_min + (p.s_dst_max - p.s_dst_min) \
            * isd / max(p.s_dst_steps - 1, 1)

        s0 = float(start["s"])
        poly = PolyQuintic(s0, float(start["l"]), float(start["dl"]),
                           float(start["ddl"]), s0 + s_dst, l_dst, 0.0, 0.0)

        s_step = (p.s_max - p.s_min) / (p.s_steps - 1)
        ss = s0 + p.s_min + np.arange(p.s_steps) * s_step

        past = ss >= s0 + s_dst
        l = np.where(past, l_dst, np.asarray(poly.f(ss)))
        dl = np.where(past, 0.0, np.asarray(poly.df(ss)))
        ddl = np.where(past, 0.0, np.asarray(poly.ddf(ss)))
        dddl = np.where(past, 0.0, np.asarray(poly.dddf(ss)))

        rl = env.ref_line   # host (N, 8), offset-centered
        grid_s = np.arange(len(rl)) * env.ref_step
        rp_x = lerp_xs(ss, grid_s, rl[:, 0])
        rp_y = lerp_xs(ss, grid_s, rl[:, 1])
        rp_h = lerp_xs(ss, grid_s, rl[:, 2], angle=True)
        rp_v = lerp_xs(ss, grid_s, rl[:, 4])

        pts = np.zeros((p.s_steps, 12))
        pts[:, TC_S] = ss
        pts[:, TC_L] = l
        pts[:, TC_DL] = dl
        pts[:, TC_DDL] = ddl
        pts[:, TC_DDDL] = dddl
        heading_frenet = np.arctan(dl)
        pts[:, TC_X] = env.x_offset + rp_x - np.sin(rp_h) * l
        pts[:, TC_Y] = env.y_offset + rp_y + np.cos(rp_h) * l
        pts[:, TC_H] = heading_frenet + rp_h
        pts[:, TC_V] = rp_v

        traj = PolyLatTraj(pts)
        traj.update_time_dist_curv()
        traj.cost = float(tc[il, isd])
        return traj


# ---------------------------------------------------------------------
# bounds

# Operations of one sample of one candidate as the plain version defines
# them, in float64 but for the reference lerp (four quintic derivatives by
# Horner 30, the geometry and curvature 25, the speed limit 8, constraints
# 20, cost 14, the segment time 7, 9 occupancy lookups of 12 each), and of
# one candidate beside its samples (coefficients 40, the sums and terms 10).
OPS = dict(sample_f64=104, sample_lookup_f32=9 * 12, candidate=50)
# A candidate's critical path: one sample's chain (the quintic, the
# geometry, atan / cos, the curvature's divisions, the speed limit's square
# root and division), then the 201-long running sum of segment times, then
# a sample's lookups and a block reduction of 8 levels.
CHAIN_SAMPLE = dict(f64_mul=14, f64_add=16, f64_div=4, f64_sin=2,
                    f64_cos=1, smem_load=4)
CHAIN_PER_SAMPLE = dict(f64_add=1)
CHAIN_TAIL = dict(f64_div=1, f64_add=8, f32_add=8, smem_load=10)
# The last block's selection: its staging (a load through L2, priced as a
# shared-memory load, and a store), then for each pass and each 32
# candidates a warp's test of the update condition (a float32 add and
# compare on a staged value) and for each update of the serial pass a
# shuffle of the winner's value and the re-test of the lanes after it.  The
# arrival's fence and atomic are not priced (no probe).
CHAIN_STAGE = dict(smem_load=2)
CHAIN_SELECT_ROUND = dict(f32_add=2, smem_load=1)
CHAIN_SELECT_UPDATE = dict(f32_add=2, smem_load=1)
# the selection's float32 operations a candidate: two compares a pass
SELECT_OPS = 4


def traffic_bytes(LD, SD, S, n_ref, occ_cells):
    """Bytes one sweep must move: the reference rows it reads (8 channels
    each), the occupancy cells its lookups touch (at most the grid), the
    parameters and the start, the two maps and the winner's index and cost
    written once."""
    return (4 * (min(n_ref, S + 1) * 8 + len(PL_PP_KEYS) + len(ENV_PP_KEYS)
                 + 5 + 1) + 4 * occ_cells + (4 + 8) * LD * SD + 8 + 4)


def operations(LD, SD, S):
    """(float64 operations, float32 operations) of one sweep and its
    selection."""
    n = LD * SD
    return (n * (S * OPS["sample_f64"] + OPS["candidate"]),
            n * (S * OPS["sample_lookup_f32"] + SELECT_OPS))


def bound_ms(LD, SD, S, n_ref, occ_cells):
    """(ms, "bytes" or "operations"): the roofline bound of one sweep (its
    float64 and float32 operations each at their own peak)."""
    f64_ops, f32_ops = operations(LD, SD, S)
    t_ops = (f64_ops / _latency.PEAK_OPS_PER_S["float64"]
             + f32_ops / _latency.PEAK_OPS_PER_S["float32"]) * 1e3
    t_bytes = traffic_bytes(LD, SD, S, n_ref, occ_cells) \
        / _latency.HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_ms(S, cycles, sm_mhz):
    ops = _latency.add_ops(dict(CHAIN_SAMPLE), CHAIN_PER_SAMPLE, S)
    ops = _latency.add_ops(ops, CHAIN_TAIL, 1)
    return _latency.chain_ms(ops, cycles, sm_mhz)


def selection_updates(cd, tc, length_veh, LD, SD):
    """How many updates the selection's two serial passes make on these
    maps (the steps of :func:`select_reference` that change its state)."""
    return _select_passes(cd, tc, length_veh, LD, SD)[2]


def sweep_select_chain_ms(LD, SD, S, updates, cycles, sm_mhz):
    """The critical path of the one launch: a candidate's sweep
    (:func:`chain_ms`), then the last block's staging and the selection's
    two passes on a warp, ``updates`` of them taken
    (:func:`selection_updates`)."""
    ops = _latency.add_ops(dict(CHAIN_SAMPLE), CHAIN_PER_SAMPLE, S)
    _latency.add_ops(ops, CHAIN_TAIL, 1)
    _latency.add_ops(ops, CHAIN_STAGE, -(-(LD * SD) // THREADS))
    _latency.add_ops(ops, CHAIN_SELECT_ROUND, 2 * -(-(LD * SD) // 32))
    _latency.add_ops(ops, CHAIN_SELECT_UPDATE, updates)
    return _latency.chain_ms(ops, cycles, sm_mhz)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library, and load its code
    onto the current device, so that the first launch does not pay for
    it."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("poly_lat")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.poly_lat_sweep_select.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
        lib.poly_lat_sweep_select_profile.argtypes = (
            [ptr] * 13 + [i32] * 7 + [ptr])
        lib.poly_lat_sweep_select.restype = i32
        lib.poly_lat_sweep_select_profile.restype = i32
        for fn in (lib.poly_lat_max_samples, lib.poly_lat_max_candidates,
                   lib.poly_lat_n_params, lib.poly_lat_n_env_params,
                   lib.poly_lat_n_phases, lib.poly_lat_prepare):
            fn.restype = i32
            fn.argtypes = []
        if lib.poly_lat_n_params() != len(PL_PP_KEYS) \
                or lib.poly_lat_n_env_params() != len(ENV_PP_KEYS) \
                or lib.poly_lat_n_phases() != len(SWEEP_PHASES):
            raise RuntimeError("poly_lat.cu and PL_PP_KEYS / ENV_PP_KEYS / "
                               "SWEEP_PHASES disagree")
        _build.prepare(lib, "poly_lat")
        _LIB = lib
    return _LIB
