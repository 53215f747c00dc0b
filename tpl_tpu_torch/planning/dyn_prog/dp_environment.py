"""
DP environment: the shared Frenet-grid world model for the DP planners.

Swept prediction ribbons are built host-side as convex quads and
rasterized directly into the dense (t, s, l) Frenet grid by one pass of
tensor ops (point-in-dilated-convex-quad tests over all cells x quads);
distance maps are cumulative scans.  (reference: library/src/dyn_prog/
env.cu, occupancy_renderer.cu)

Occupancy cell values (env.cu:11-63): 0 = free, 1 = occupied (moving),
2 = off-road / grid boundary / zero-speed cell, 3 = stationary obstacle.

The directional distance field (the graph DP's obstacle lookup) is the
hand-written kernel of ``csrc/dir_dist_map.cu`` on a CUDA tensor and its
plain PyTorch version :func:`dir_dist_reference` on a CPU tensor
(:func:`dir_dist_map`); ``ray_steps`` is a runtime argument of both.

Divergence note: the reference dilates rasterized pixels with a circular
kernel (env.cu:25-43); here dilation is by euclidean distance to the quad's
supporting halfplanes, which over-approximates the dilation near convex
corners (strictly more conservative).
"""

import ctypes
import warnings

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch import _latency
from tpl_tpu_torch.ops import project
from tpl_tpu_torch.planning.dyn_prog.lon_kernel import _check, axis_points

dir_dist_launches = 0   # kernel launches since import (reset freely)

# the distance of a ray that meets nothing within its steps
FREE_DIST = 10000.0
# the time slices one march of the kernel serves (a mask word's bits)
SLICE_GROUP = 32


class DpEnvParams:
    """(reference: env.cuh:11-44 DynProgEnvParams)"""

    def __init__(self):
        self.t_min = 0.0
        self.t_max = 10.0
        self.l_min = -5.0
        self.l_max = 5.0
        self.s_min = 0.0
        self.s_max = 200.0

        self.ds_max = 36.0

        self.dir_min = -np.pi / 2
        self.dir_max = np.pi / 2

        self.dt = 1.0
        self.dt_start = 1.0

        self.t_steps = 10
        self.l_steps = 21
        self.s_steps = 201
        self.dir_steps = 21

        self.scale_objects = 1.0
        self.dilation = 2.0

    @property
    def l_step_size(self):
        return (self.l_max - self.l_min) / (self.l_steps - 1)

    @property
    def s_step_size(self):
        return (self.s_max - self.s_min) / (self.s_steps - 1)


class DpEnvGrid:
    """Device-resident environment grids."""

    def __init__(self, occ_map, dist_map_lon, ref_line, params):
        self.occ_map = occ_map            # (T, S, L) float32
        self.dist_map_lon = dist_map_lon  # (T, S, L, 2) float32
        self.ref_line = ref_line          # (N, 8) float32 device
        self.params = params
        self.dir_dist_map = None          # (T, S, L, D) float32, on demand


# ref line channel indices (x, y, heading, k, v_max, d_left, d_right, semantic)
RL_X, RL_Y, RL_H, RL_K, RL_V, RL_DL, RL_DR, RL_SEM = range(8)


def _build_grids(ref_line, ref_step, quads, quad_tbit, quad_stat, quad_valid,
                 dilation, s_min, s_step, l_min, l_step,
                 t_steps, s_steps, l_steps):
    """Rasterize quads into the Frenet grid and build distance maps.

    All tensor arguments live on one device; scalars are 0-d float32
    tensors.
    quads: (Q, 4, 2) CCW convex quads in the ref line's cartesian frame
    quad_tbit: (Q,) int32 time-slice index of each quad
    quad_stat: (Q,) bool stationary flag
    Returns occ_map (T, S, L) and dist_map_lon (T, S, L, 2), float32.
    """
    f32 = torch.float32
    dev = ref_line.device
    S, L, T = s_steps, l_steps, t_steps

    ss = s_min + torch.arange(S, dtype=f32, device=dev) * s_step
    ls = l_min + torch.arange(L, dtype=f32, device=dev) * l_step

    # ref line linear interp at cell s (reference: RefLine::lerp)
    n_ref = ref_line.shape[0]
    q = ss / ref_step
    i0 = torch.clamp(torch.floor(q), 0, n_ref - 1).long()
    i1 = torch.clamp(torch.ceil(q), 0, n_ref - 1).long()
    a = torch.clamp(q - i0, 0.0, 1.0)[:, None]
    rl = ref_line[i0] * (1.0 - a) + ref_line[i1] * a           # (S, 8)
    # nearest (texture point) channels for d_left/d_right/v_max/semantic
    i_n = torch.clamp(torch.round(q), 0, n_ref - 1).long()
    rl_tex = ref_line[i_n]                                     # (S, 8)

    x_c = rl[:, RL_X][:, None] - ls[None, :] * torch.sin(rl[:, RL_H])[:, None]
    y_c = rl[:, RL_Y][:, None] + ls[None, :] * torch.cos(rl[:, RL_H])[:, None]
    cells = torch.stack([x_c, y_c], dim=-1)                    # (S, L, 2)

    # point-in-dilated-quad: max over edge halfplane distances <= dilation
    e0 = quads                                                 # (Q, 4, 2)
    e1 = torch.roll(quads, -1, dims=1)
    ev = e1 - e0                                               # (Q, 4, 2)
    elen = torch.sqrt(torch.sum(ev * ev, dim=-1))              # (Q, 4)
    # outward normal for CCW polygons
    nrm = torch.stack([ev[..., 1], -ev[..., 0]], dim=-1) / torch.clamp(
        elen, min=1e-9)[..., None]
    degenerate = elen < 1e-9

    # dist[s, l, q] = max_edges dot(cell - e0, nrm)
    rel = cells[:, :, None, None, :] - e0[None, None, :, :, :]  # (S,L,Q,4,2)
    d_edge = torch.sum(rel * nrm[None, None], dim=-1)           # (S,L,Q,4)
    d_edge = torch.where(degenerate[None, None], -float("inf"), d_edge)
    d_quad = torch.amax(d_edge, dim=-1)                         # (S, L, Q)

    inside = (d_quad <= dilation) & quad_valid[None, None, :]

    t_ids = torch.arange(T, dtype=torch.int32, device=dev)
    hit_t = inside[None] & (quad_tbit[None, None, None, :]
                            == t_ids[:, None, None, None])      # (T,S,L,Q)
    occ_bit = torch.any(hit_t, dim=-1)                          # (T, S, L)
    stat_px = torch.any(inside & quad_stat[None, None, :], dim=-1)  # (S, L)

    val = torch.where(occ_bit, 1.0, 0.0)
    val = torch.where(stat_px[None], 3.0, val)

    # off-road / boundary / zero-speed overrides (env.cu:52-61)
    off_road = ((ls[None, :] > rl_tex[:, RL_DL][:, None])
                | (ls[None, :] < -rl_tex[:, RL_DR][:, None]))
    l_ar = torch.arange(L, device=dev)
    edge_l = (l_ar == 0) | (l_ar == L - 1)
    zero_v = rl_tex[:, RL_V][:, None] < 0.1
    blocked = off_road | edge_l[None, :] | zero_v
    val = torch.where(blocked[None], 2.0, val)

    # closeIntersections (env.cu:65-93): block full road width on occupied
    # intersection cells (semantic >= 0.5), inner l cells only
    semantic = torch.round(rl_tex[:, RL_SEM]) >= 0.5            # (S,)
    inner = ~edge_l
    occupied_inner = torch.any((val == 1.0) & inner[None, None, :], dim=-1)
    close = semantic[None, :] & occupied_inner                   # (T, S)
    val = torch.where(close[:, :, None] & inner[None, None, :], 1.0, val)

    occ_map = val

    # longitudinal distance maps (env.cu:95-129): channel 0 = distance to
    # next occupied cell ahead, channel 1 = behind; free tails accumulate
    # from 10000.
    occ_any = occ_map > 0.0
    s_idx = torch.arange(S, dtype=f32, device=dev)[None, :, None]
    inf = float("inf")

    nxt = torch.where(occ_any, s_idx, inf)
    # reverse cumulative min == flip, forward cummin, flip back
    next_occ = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values,
                          [1])                                   # (T, S, L)
    d_fwd = torch.where(torch.isfinite(next_occ),
                        (next_occ - s_idx) * s_step,
                        10000.0 + (S - s_idx) * s_step)

    prv = torch.where(occ_any, s_idx, -inf)
    prev_occ = torch.cummax(prv, dim=1).values
    d_bwd = torch.where(torch.isfinite(prev_occ),
                        (s_idx - prev_occ) * s_step,
                        10000.0 + (s_idx + 1.0) * s_step)

    dist_map_lon = torch.stack([d_fwd, d_bwd], dim=-1)

    return occ_map, dist_map_lon


def _dist_map_path(occ_map, path_sl, s_min, s_step, l_min, l_step):
    """Distance to the next occupied cell along an arbitrary path.

    path_sl: (S, 2) frenet (s, l) of the path sampled at each grid s index
    (env.cu:131-158); the scalars are 0-d tensors or floats.  The cell
    indices truncate toward zero (an int cast), then clamp.  Returns (T, S),
    a reverse cumulative minimum of the occupied rows.
    """
    T, S, L = occ_map.shape
    dev = occ_map.device
    idx_s = torch.clamp(((path_sl[:, 0] - s_min) / s_step).to(torch.int32),
                        0, S - 1).long()
    idx_l = torch.clamp(((path_sl[:, 1] - l_min) / l_step).to(torch.int32),
                        0, L - 1).long()
    occ = occ_map[:, idx_s, idx_l] > 0.0                         # (T, S)

    s_idx = torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    nxt = torch.where(occ, s_idx, float("inf"))
    next_occ = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values,
                          [1])
    return torch.where(torch.isfinite(next_occ),
                       (next_occ - s_idx) * s_step,
                       10000.0 + (S - s_idx) * s_step)


def ray_table(dir_min, dir_max, dir_steps, s_step, l_step):
    """The rays' per-sample steps ((D, 2) float32 [ds, dl]) and the sample
    spacing (a float32 value), as the JAX package's ``_dir_dist_map``
    computes them on the CPU: the angles ``dir_min + d * (dir_max -
    dir_min) / (D - 1)`` with the division by the constant a product with
    its float32 reciprocal contracted into the addition (``axis_points``),
    the spacing ``min(s_step, l_step)``, its cosine and sine of each angle
    correctly rounded to float32 (what XLA's float32 cosine gives on these
    angles), times the spacing in float32.  Kernel and plain version read
    this one table."""
    f32 = np.float32
    angles = axis_points(f32(dir_min), f32(dir_max),
                         torch.arange(dir_steps, dtype=torch.float32),
                         dir_steps - 1)
    step = f32(min(f32(s_step), f32(l_step)))
    ds = step * torch.cos(angles.double()).float()
    dl = step * torch.sin(angles.double()).float()
    return torch.stack([ds, dl], dim=1).contiguous(), float(step)


def dir_dist_reference(occ, ray, s_min, s_step, l_min, l_step, step,
                       ray_steps):
    """The directional distance field (T, S, L, D) float32 (the plain
    version; reference: env.cu:160-214 updateDirDistMap, the JAX package's
    ``_dir_dist_map``).  From cell (s, l) each ray d samples ``ss + ds * i``,
    ``ls + dl * i`` for i < ``ray_steps`` (each operation rounded on its
    own); a sample blocks when its float indices ``(x - min) / step`` leave
    the open grid (``<= 0`` or ``>= n``: row 0 and column 0 block at once)
    or its cell, ``trunc(clip(f, 0, n - 1))``, is occupied.  The distance is
    the first blocking sample's index times ``step``, or ``FREE_DIST``.
    ``occ`` (T, S, L) and ``ray`` (:func:`ray_table`) float32 on one device,
    the scalars float32 values."""
    f32 = torch.float32
    dev = occ.device
    T, S, L = occ.shape
    i = torch.arange(ray_steps, dtype=f32, device=dev)
    ss = s_min + torch.arange(S, dtype=f32, device=dev) * s_step
    ls = l_min + torch.arange(L, dtype=f32, device=dev) * l_step
    s_ray = ss[:, None, None, None] + ray[None, None, :, 0, None] * i
    l_ray = ls[None, :, None, None] + ray[None, None, :, 1, None] * i
    is_f = (s_ray - s_min) / s_step                     # (S, 1, D, R)
    il_f = (l_ray - l_min) / l_step                     # (1, L, D, R)
    out_of_grid = ((is_f <= 0.0) | (is_f >= S) | (il_f <= 0.0)
                   | (il_f >= L))                       # (S, L, D, R)
    cell = (torch.clamp(is_f, 0, S - 1).to(torch.int32).long() * L
            + torch.clamp(il_f, 0, L - 1).to(torch.int32).long())
    free = torch.tensor(FREE_DIST, dtype=f32, device=dev)
    out = []
    for t in range(T):
        blocked = (occ[t].reshape(-1)[cell] > 0.0) | out_of_grid
        first = blocked.to(torch.uint8).argmax(dim=-1).to(f32)
        out.append(torch.where(blocked.any(dim=-1), first * step, free))
    return torch.stack(out)


def _field_inputs(occ, ray, ray_steps):
    """Checks the field's inputs; returns (T, S, L, D)."""
    dev = occ.device
    if occ.dim() != 3:
        raise ValueError(f"occ must be (T, S, L), got {tuple(occ.shape)}")
    T, S, L = occ.shape
    _check("occ", occ, (T, S, L), torch.float32, dev)
    if ray.dim() != 2 or ray.shape[1] != 2:
        raise ValueError(f"ray must be (D, 2), got {tuple(ray.shape)}")
    D = ray.shape[0]
    _check("ray", ray, (D, 2), torch.float32, dev)
    if ray_steps < 1:
        raise ValueError(f"ray_steps must be positive, got {ray_steps}")
    return T, S, L, D


def dir_dist_map(occ, ray, s_min, s_step, l_min, l_step, step, ray_steps):
    """The directional distance field (T, S, L, D) float32: the kernel
    ``dir_dist_map`` on a CUDA tensor, :func:`dir_dist_reference` on a CPU
    tensor.  Arguments as
    :func:`dir_dist_reference`'s; ``ray_steps`` is a runtime integer, so a
    new value compiles nothing."""
    global dir_dist_launches
    dev = occ.device
    T, S, L, D = _field_inputs(occ, ray, ray_steps)
    if dev.type == "cpu":
        return dir_dist_reference(occ, ray, s_min, s_step, l_min, l_step,
                                  step, ray_steps)
    if dev.type != "cuda":
        raise ValueError(f"dir_dist_map: unsupported device {dev}")
    lib = _kernel()
    out = torch.empty((T, S, L, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dir_dist_map(occ.data_ptr(), ray.data_ptr(), s_min, s_step,
                               l_min, l_step, step, out.data_ptr(), T, S, L,
                               D, ray_steps,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dir_dist_map launch failed: CUDA error {err}")
    dir_dist_launches += 1
    return out


# the profiling instantiation's phases (csrc/dir_dist_map.cu Phase)
PHASES = ("stage", "march", "write")


def dir_dist_profile(occ, ray, s_min, s_step, l_min, l_step, step,
                     ray_steps):
    """The kernel's profiling instantiation on CUDA tensors (not counted as
    a launch of the main path): (the field, {phase: thread 0's clock64()
    cycles from barrier to barrier, summed over the blocks}, the number of
    blocks).  Its field is bit-equal to :func:`dir_dist_map`'s."""
    dev = occ.device
    T, S, L, D = _field_inputs(occ, ray, ray_steps)
    if dev.type != "cuda":
        raise ValueError("dir_dist_profile needs CUDA tensors")
    lib = _kernel()
    out = torch.empty((T, S, L, D), dtype=torch.float32, device=dev)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.dir_dist_map_profile(
            occ.data_ptr(), ray.data_ptr(), s_min, s_step, l_min, l_step,
            step, out.data_ptr(), prof.data_ptr(), T, S, L, D, ray_steps,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dir_dist_map_profile launch failed: CUDA error "
                           f"{err}")
    blocks = S * -(-T // SLICE_GROUP)
    return out, dict(zip(PHASES, prof.cpu().tolist())), blocks


# Operations of one ray sample as the plain version defines it: the two
# sample positions (a multiply and an add each), the two float indices (a
# subtraction and a division each), the four grid tests, the two clips and
# truncations, the cell index and its read; one more for the distance.
OPS_SAMPLE = 16
# the critical path of one cell: per sample a multiply, an add, a
# subtraction, a division, then the shared read of the cell
CHAIN_SAMPLE = dict(f32_mul=1, f32_add=2, f32_div=1, smem_load=1)


def _ray_samples(field, step, ray_steps):
    """Each ray's samples in each slice: the first blocking sample's index
    + 1, or ``ray_steps`` where none blocked (float64, like ``field``)."""
    f = field.double()
    return torch.where(f == FREE_DIST, float(ray_steps),
                       torch.round(f / step) + 1.0)


def dir_dist_samples(field, step, ray_steps):
    """The samples the rays of ``field`` (a computed field) marched, one
    march a slice (the work this run's data needs, with the early exit, as
    the plain version defines it)."""
    return int(_ray_samples(field, step, ray_steps).sum())


def dir_dist_merged_samples(field, step, ray_steps):
    """The samples one march of each ray for all slices needs: the longest
    of its slices (the kernel marches a ray once for up to ``SLICE_GROUP``
    slices)."""
    return int(_ray_samples(field, step, ray_steps).amax(dim=0).sum())


def dir_dist_bytes(T, S, L, D):
    """Bytes the field must move: the occupancy and the ray table read
    once, the field written once."""
    return 4 * T * S * L + 8 * D + 4 * T * S * L * D


def dir_dist_bound_ms(field, step, ray_steps):
    """The bound of one march a slice (the plain version's samples)."""
    T, S, L, D = field.shape
    return _latency.roofline_ms(
        dir_dist_bytes(T, S, L, D),
        dir_dist_samples(field, step, ray_steps) * OPS_SAMPLE + field.numel(),
        "float32")


def dir_dist_needed_bound_ms(field, step, ray_steps):
    """The needed-work bound: one march a ray for all slices
    (:func:`dir_dist_merged_samples`), each distance written."""
    T, S, L, D = field.shape
    return _latency.roofline_ms(
        dir_dist_bytes(T, S, L, D),
        dir_dist_merged_samples(field, step, ray_steps) * OPS_SAMPLE
        + field.numel(), "float32")


def dir_dist_chain_ms(field, step, ray_steps, cycles, sm_mhz):
    """The longest ray's chain: its samples (at most ``ray_steps``) one
    after the other."""
    longest = int(_ray_samples(field, step, ray_steps).max())
    return _latency.chain_ms(_latency.add_ops({}, CHAIN_SAMPLE, longest),
                             cycles, sm_mhz)


_LIB = None


def _kernel():
    """Build (first call) and bind the field's kernel library, and load its
    code onto the current device with the shared-memory limit set, so that
    the first launch pays for neither."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("dir_dist_map")
        head = [ctypes.c_void_p] * 2 + [ctypes.c_float] * 5
        tail = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.dir_dist_map.restype = ctypes.c_int
        lib.dir_dist_map.argtypes = head + [ctypes.c_void_p] + tail
        lib.dir_dist_map_profile.restype = ctypes.c_int
        lib.dir_dist_map_profile.argtypes = head + [ctypes.c_void_p] * 2 + tail
        for fn in (lib.dir_dist_map_n_phases, lib.dir_dist_map_prepare):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if lib.dir_dist_map_n_phases() != len(PHASES):
            raise RuntimeError("dir_dist_map.cu and PHASES disagree")
        _build.prepare(lib, "dir_dist_map")
        _LIB = lib
    return _LIB


def gen_prediction_quads(pred_states, hull, path, ts, station_step_size=5.0,
                         expansion_rate=0.0, sweep_length=0.5):
    """Swept prediction footprint as convex quads with time stamps.

    Host-side twin of the reference's triangle generator (reference:
    library/src/utils.cpp:576-692 genPredictionGeometry): the object's
    Frenet band [d_min, d_max] along its predicted map path, swept from
    s_mid - len/2 to s_mid + max(sweep_length, dt) * v + len/2, in
    station_step_size segments. Returns list of (quad (4, 2), t).
    """
    path = np.asarray(path, dtype=np.float64)
    if len(path) < 2:
        return []
    path_step = np.linalg.norm(path[1] - path[0])

    def get_path(s):
        a = s / path_step
        i_prev = int(np.clip(np.floor(a), 0, len(path) - 2))
        i_next = int(np.clip(np.ceil(a), 1, len(path) - 1))
        a = np.clip(a - i_prev, 0.0, 1.0)
        return path[i_prev] * (1.0 - a) + path[i_next] * a

    # approximate object shape as a box in the path's frenet frame
    s_min = np.inf
    s_max = -np.inf
    d_min = np.inf
    d_max = -np.inf
    for v in hull:
        proj = project(path, v)
        if proj.in_bounds:
            s_min = min(proj.arc_len, s_min)
            s_max = max(proj.arc_len, s_max)
            d_min = min(proj.distance, d_min)
            d_max = max(proj.distance, d_max)
    if not np.isfinite(s_min):
        return []

    # prediction state at ts[0]
    pt = pred_states[:, 0]

    def interp_pred(t):
        i = np.searchsorted(pt, t)
        i0 = int(np.clip(i - 1, 0, len(pt) - 1))
        i1 = int(np.clip(i, 0, len(pt) - 1))
        if i1 == i0:
            a = 0.0
        else:
            a = np.clip((t - pt[i0]) / max(pt[i1] - pt[i0], 1e-9), 0.0, 1.0)
        return pred_states[i0] * (1 - a) + pred_states[i1] * a

    pp0 = interp_pred(ts[0])
    proj0 = project(path, pp0[1:3])

    l = s_max - s_min
    s_mid = proj0.arc_len

    quads = []
    for t_idx in range(len(ts) - 1):
        t = ts[t_idx]
        dt = ts[t_idx + 1] - t
        pp = interp_pred(t)
        v = pp[4]

        sg = -1.0 if v < 0.0 else 1.0
        s_start = s_mid - sg * l * 0.5
        s_stop = s_mid + max(sweep_length, dt) * v + sg * l * 0.5
        steps = int(abs(s_stop - s_start) / station_step_size) + 1

        for i in range(steps):
            s = s_start + i * station_step_size * sg
            ds = sg * min(abs(s_stop - s), station_step_size)
            if abs(ds) < 1e-3:
                break
            p0 = get_path(s)
            p1 = get_path(s + ds)
            seg = (p1 - p0) * sg
            vl = np.linalg.norm(seg)
            if vl < 1e-3:
                break
            ortho = np.array([-seg[1], seg[0]]) / vl
            quad = np.array([
                p0 + ortho * d_min,
                p1 + ortho * d_min,
                p1 + ortho * d_max,
                p0 + ortho * d_max,
            ])
            quads.append((quad, t))

        l *= 1.0 + expansion_rate
        s_mid += dt * v

    return quads


def _make_ccw(quad):
    area = 0.0
    for i in range(4):
        x0, y0 = quad[i]
        x1, y1 = quad[(i + 1) % 4]
        area += x0 * y1 - x1 * y0
    if area < 0:
        return quad[::-1].copy()
    return quad


class DpEnvironment:
    """Frenet-grid DynProgEnvironment (reference: env.cu:281-513)."""

    # Quads beyond this count are dropped, as in the JAX package (kept for
    # parity); the first build that drops some warns once per process.
    MAX_QUADS = 192
    _warned_cap = False

    def __init__(self):
        self.params = DpEnvParams()
        self.ref_line = None        # host numpy (N, 8), offset-centered
        self.ref_step = 0.5
        self.true_rows = 0          # unpadded rows (see set_ref_line)
        self.grid = None            # DpEnvGrid (device tensors)
        self._quads = []            # list of (quad, t_idx, stationary)
        # f32 precision: UTM coordinates are offset-centered like the
        # reference's RefLine (utils.hpp:135-220)
        self.x_offset = 0.0
        self.y_offset = 0.0

    def reinit_buffers(self, params):
        self.params = params
        self._quads = []

    def set_ref_line(self, ref_line, step_size, true_rows=None):
        """ref_line: (N, >=9) array [x, y, heading, s, k, v, d_left,
        d_right, semantic] (dp_env.py layout).

        ``true_rows``: number of leading rows that carry real map
        geometry when the tail is synthetic padding (dp_env.py
        pack_ref_line pads to 64-row buckets); the coverage check in
        :meth:`device_inputs` runs against this count so padding cannot
        silently substitute for a too-short map window."""
        rl = np.asarray(ref_line, dtype=np.float64)
        self.true_rows = len(rl) if true_rows is None else int(true_rows)
        self.x_offset = float(np.mean(rl[:, 0]))
        self.y_offset = float(np.mean(rl[:, 1]))
        out = np.zeros((len(rl), 8), dtype=np.float32)
        out[:, RL_X] = rl[:, 0] - self.x_offset
        out[:, RL_Y] = rl[:, 1] - self.y_offset
        out[:, RL_H] = rl[:, 2]
        out[:, RL_K] = rl[:, 4]
        out[:, RL_V] = rl[:, 5]
        out[:, RL_DL] = rl[:, 6]
        out[:, RL_DR] = rl[:, 7]
        out[:, RL_SEM] = rl[:, 8] if rl.shape[1] > 8 else 0.0
        self.ref_line = out
        self.ref_step = float(step_size)

    def t_index(self, t):
        """Time -> slice index (env.cu:233-236)."""
        p = self.params
        return np.where(t < p.dt_start, 0,
                        np.round((np.asarray(t) - p.dt_start) / p.dt) + 1
                        ).astype(np.int32)

    def insert_geometry(self, quads_with_t, stationary):
        """quads_with_t: list of (quad (4,2) cartesian, t)."""
        offset = np.array([self.x_offset, self.y_offset])
        for quad, t in quads_with_t:
            t_idx = int(self.t_index(t))
            self._quads.append((_make_ccw(np.asarray(quad) - offset), t_idx,
                                bool(stationary)))

    def device_inputs(self, device=None):
        """Pack all :func:`_build_grids` tensor inputs onto ``device``
        (``tpl_tpu_torch.device()`` unless given; see
        lat_lon_kernel.make_latlon_replan)."""
        p = self.params
        if self.ref_line is None:
            raise RuntimeError("set_ref_line before update")
        # coverage is checked against the TRUE (unpadded) window: padded
        # rows are fabricated straight-road continuation and must never
        # satisfy this invariant (see set_ref_line)
        if self.true_rows * self.ref_step < p.s_max:
            raise RuntimeError(
                f"refline length = {self.true_rows * self.ref_step}"
                f" < environment s_max = {p.s_max}")

        Q = self.MAX_QUADS
        if len(self._quads) > Q and not DpEnvironment._warned_cap:
            DpEnvironment._warned_cap = True
            warnings.warn(f"DpEnvironment: {len(self._quads)} prediction "
                          f"quads, only the first MAX_QUADS={Q} are "
                          "rasterized (as in the JAX package)",
                          RuntimeWarning, stacklevel=2)
        quads = np.zeros((Q, 4, 2), dtype=np.float32)
        tbit = np.full(Q, -1, dtype=np.int32)
        stat = np.zeros(Q, dtype=bool)
        valid = np.zeros(Q, dtype=bool)
        for i, (quad, t_idx, stationary) in enumerate(self._quads[:Q]):
            quads[i] = quad
            tbit[i] = min(t_idx, p.t_steps - 1)
            stat[i] = stationary
            valid[i] = True

        dev = tpl_tpu_torch.device() if device is None else device

        def scalar(x):
            return torch.tensor(np.float32(x), device=dev)

        return (torch.from_numpy(self.ref_line).to(dev),
                scalar(self.ref_step),
                torch.from_numpy(quads).to(dev),
                torch.from_numpy(tbit).to(dev),
                torch.from_numpy(stat).to(dev),
                torch.from_numpy(valid).to(dev),
                scalar(p.dilation), scalar(p.s_min), scalar(p.s_step_size),
                scalar(p.l_min), scalar(p.l_step_size))

    def adopt_grid(self, occ, dist_lon):
        """Install externally computed (device-resident) grids."""
        self.grid = DpEnvGrid(
            occ, dist_lon,
            torch.from_numpy(self.ref_line).to(tpl_tpu_torch.device()),
            self.params)
        return self.grid

    def update(self):
        p = self.params
        inputs = self.device_inputs()
        occ, dist_lon = _build_grids(*inputs, p.t_steps, p.s_steps,
                                     p.l_steps)
        return self.adopt_grid(occ, dist_lon)

    def update_dist_map_path(self, path_sl):
        """path_sl: (s_steps, 2) frenet path samples; returns (T, S)."""
        p = self.params
        occ = self.grid.occ_map
        path_sl = torch.as_tensor(np.asarray(path_sl, np.float32)
                                  if not isinstance(path_sl, torch.Tensor)
                                  else path_sl, device=occ.device)

        def scalar(x):
            return torch.tensor(np.float32(x), device=occ.device)

        return _dist_map_path(occ, path_sl.to(torch.float32),
                              scalar(p.s_min), scalar(p.s_step_size),
                              scalar(p.l_min), scalar(p.l_step_size))

    def ray_steps_default(self):
        """The samples a ray takes: ``ds_max`` over the sample spacing
        (dp_environment.py of the JAX package, :472-473)."""
        p = self.params
        return int(p.ds_max / min(p.s_step_size, p.l_step_size))

    def update_dir_dist_map(self, ray_steps=None):
        """Compute the directional distance field (T, S, L, D) on the
        grid's device and keep it on the grid (``grid.dir_dist_map``).
        ``ray_steps`` (default :meth:`ray_steps_default`) is a runtime
        argument of the kernel: no value of it compiles anything."""
        p = self.params
        if ray_steps is None:
            ray_steps = self.ray_steps_default()
        f32 = np.float32
        ray, step = ray_table(p.dir_min, p.dir_max, p.dir_steps,
                              p.s_step_size, p.l_step_size)
        occ = self.grid.occ_map
        dd = dir_dist_map(occ, ray.to(occ.device), float(f32(p.s_min)),
                          float(f32(p.s_step_size)), float(f32(p.l_min)),
                          float(f32(p.l_step_size)), step, int(ray_steps))
        self.grid.dir_dist_map = dd
        return dd

    def adopt_dir_dist_map(self, dd):
        """Install an externally computed field (T, S, L, D) on the grid,
        moved to the grid's device as float32 (numpy or tensor)."""
        occ = self.grid.occ_map
        self.grid.dir_dist_map = torch.as_tensor(
            np.array(dd, np.float32) if not isinstance(dd, torch.Tensor)
            else dd, dtype=torch.float32, device=occ.device).contiguous()
        return self.grid.dir_dist_map

    # --- debug getters (env.cu:452-513) ---

    def get_occ_map(self):
        return self.grid.occ_map.cpu().numpy()

    def get_dist_map_lon(self):
        return self.grid.dist_map_lon.cpu().numpy()

    def get_dist_map_dir(self, idx_t):
        return self.grid.dir_dist_map[idx_t].cpu().numpy()
