"""
Device kernel for the Frenet polynomial sampling planner.
(reference: library/src/poly_sampling.cpp:37-258; the JAX package's form is
tpl_tpu/planning/poly_sampling/poly_kernel.py)

One entry evaluates the whole Werling candidate grid and returns the
winning candidate: the quintic lateral and quartic longitudinal
coefficients, the (C, N) candidate x step evaluation, the jerk, time and
deviation costs, the cartesian conversion along the reference path, the
curvature, the constraint penalties, the separating-axis screen of the ego
rectangle against the padded obstacle hulls, then the first minimum of the
cost and the winner's 11 rows.  On a CUDA tensor that is the hand-written
kernel of ``csrc/poly_sampling.cu`` (one launch: a block per candidate, and
the last block to finish takes the selection); on a CPU tensor the plain
PyTorch version :func:`run_reference`.

Dtypes are the JAX program's (the JAX package turns x64 on): the inputs
are float32, the float64 Hermite and quartic inverses promote the
polynomials, the geometry and the cost to float64; the obstacles' edge
normals and self-projections stay float32, as do the time-cost terms
``k_t * T`` and the collision penalty.  The plain version sums over the
steps in index order (the kernel's order).  The winner is the first
minimum of the costs, a NaN first (``torch.argmin``, ``jnp.argmin``).
``launches`` counts the kernel's launches.
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.ops.interp import short_angle_dist_t
from tpl_tpu_torch.ops.splines import PolyQuintic, PolyQuartic, \
    _HERMITE_INV, _M4_INV
from tpl_tpu_torch.planning.dyn_prog.lon_kernel import _check

launches = 0            # kernel launches since import (reset freely)

PENALTY = 10.0e6

# params shipped to the device as ONE packed f32 vector
PP_KEYS = ("k_j", "k_t", "trg_d", "k_d", "k_v", "k_lat", "k_lon",
           "k_overtake_right", "a_max", "k_max",
           "rear_axis_to_rear", "rear_axis_to_front", "width_ego")

OUT_KEYS = ("d", "d_d", "d_dd", "s", "s_d", "s_dd", "x", "y", "yaw",
            "c", "ds")


def pack_pp(pp):
    return np.array([getattr(pp, k) for k in PP_KEYS], np.float32)


def _sat_separated_on(axes, pts_a, pts_b):
    """True where some axis in ``axes`` separates pts_a from pts_b.

    axes: (..., A, 2); pts_a: (..., Ka, 2); pts_b: (..., Kb, 2);
    broadcasting over leading dims. Zero axes (from padded vertices)
    never separate.
    """
    pa = torch.einsum("...ka,...ja->...kj", pts_a, axes)   # (..., Ka, A)
    pb = torch.einsum("...ka,...ja->...kj", pts_b, axes)
    return torch.any((pa.amax(-2) < pb.amin(-2))
                     | (pb.amax(-2) < pa.amin(-2)), dim=-1)


def _edges_normals(pts):
    e = torch.roll(pts, -1, dims=-2) - pts
    return torch.stack([-e[..., 1], e[..., 0]], dim=-1)


def hulls_intersect(hulls_a, hulls_b):
    """Batched convex SAT: broadcastable (..., Ka, 2) x (..., Kb, 2) ->
    (...,) bool. Padded (repeated) vertices are harmless: their zero
    edge normals cannot act as separating axes."""
    sep = (_sat_separated_on(_edges_normals(hulls_a), hulls_a, hulls_b)
           | _sat_separated_on(_edges_normals(hulls_b), hulls_a, hulls_b))
    return ~sep


def _lerp_xs(x, xs, ys, angle=False):
    """ops.interp.lerp_xs on tensors with the JAX package's promotion: x
    float64, xs / ys float32 columns."""
    n = ys.shape[0]
    dx = xs[1] - xs[0]
    q = (x - xs[0].double()) / dx.double()
    start = torch.clamp(torch.floor(q), 0, n - 2).long()
    end = torch.clamp(torch.ceil(q), 0, n - 1).long()
    a = q - start.double()
    y0, y1 = ys[start], ys[end]
    if angle:
        return y0.double() + short_angle_dist_t(y0, y1).double() * a
    return y0.double() * (1.0 - a) + y1.double() * a


def _hypot(x1, x2):
    """jnp.hypot: max * sqrt(1 + (min / max)^2), 0 where max is 0."""
    x1, x2 = torch.abs(x1), torch.abs(x2)
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    x = torch.where(zero, hi, hi * torch.sqrt(1 + r * r))
    return torch.where(torch.isinf(x1) | torch.isinf(x2),
                       torch.full_like(x, float("inf")), x)


def _sum_steps(x):
    """The sum over the step axis (last) in index order."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def run_reference(start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp_vec):
    """The plain version (the JAX package's ``make_poly_sampling_kernel``
    ``run``, poly_kernel.py:76-196).  start (6,) [d, d_d, d_dd, s, s_d,
    s_dd], di / Ti / tv (C,), ts (N,), path (n_path, 6), obs_hulls (O, K, 2),
    obs_valid (O,) 0.0 / 1.0, pp_vec (:data:`PP_KEYS`); float32.  Returns
    (packed (11, N) float64, the winner's cost float64, the winner's index
    int64), 0-d tensors beside the packed rows."""
    f32, f64 = torch.float32, torch.float64
    dev = di.device
    pp = {k: pp_vec[i] for i, k in enumerate(PP_KEYS)}
    d0, dd0, ddd0, s0, sd0, sdd0 = (start[i] for i in range(6))
    C, N = di.shape[0], ts.shape[0]
    zeros = torch.zeros(C, dtype=f32, device=dev)
    lat = PolyQuintic(zeros, d0.expand(C), dd0.expand(C), ddd0.expand(C), Ti,
                      di, zeros, zeros)
    lon = PolyQuartic(zeros, s0.expand(C), sd0.expand(C), sdd0.expand(C), Ti,
                      tv, zeros)
    tc = ts[:, None].expand(N, C)
    d, d_d, d_dd, d_ddd = (f(tc).T for f in (lat.f, lat.df, lat.ddf,
                                              lat.dddf))
    s, s_d, s_dd, s_ddd = (f(tc).T for f in (lon.f, lon.df, lon.ddf,
                                              lon.dddf))

    # jerk / time / terminal-deviation costs (poly_sampling.cpp:66-149)
    zero = torch.zeros((), dtype=f64, device=dev)
    Jp = _sum_steps(d_ddd ** 2)
    Js = _sum_steps(s_ddd ** 2)
    Jright = _sum_steps(torch.where(d < 0.0, -d, zero))
    kt_T = pp["k_t"] * Ti
    cd = (pp["k_j"] * Jp + kt_T + pp["k_d"] * (pp["trg_d"] - d[:, -1]) ** 2
          + pp["k_overtake_right"] * Jright)
    cv = pp["k_j"] * Js + kt_T + pp["k_v"] * (100.0 - s_d[:, -1]) ** 2
    cost = pp["k_lat"] * cd + pp["k_lon"] * cv

    # cartesian conversion (poly_sampling.cpp:151-190)
    ref_s = path[:, 3]
    heading_frenet = torch.atan(d_d / torch.where(
        s_d == 0, torch.full_like(s_d, 1e-9), s_d))
    rx = _lerp_xs(s, ref_s, path[:, 0])
    ry = _lerp_xs(s, ref_s, path[:, 1])
    rh = _lerp_xs(s, ref_s, path[:, 2], angle=True)
    rv = _lerp_xs(s, ref_s, path[:, 5])
    x = rx - torch.sin(rh) * d
    y = ry + torch.cos(rh) * d
    yaw = heading_frenet + rh

    seg = _hypot(torch.diff(x, dim=1), torch.diff(y, dim=1))
    curv_in = short_angle_dist_t(yaw[:, :-1], yaw[:, 1:]) \
        / torch.clamp(seg, min=1e-9)
    curv = torch.cat([curv_in, curv_in[:, -1:]], dim=1)

    # constraint penalties (poly_sampling.cpp:192-258)
    cost = cost + PENALTY * _sum_steps(torch.clamp(torch.abs(s_d) - rv,
                                                   min=0.0))
    cost = cost + PENALTY * _sum_steps(torch.clamp(
        torch.abs(curv) - pp["k_max"], min=0.0))
    cost = cost + PENALTY * _sum_steps(torch.clamp(
        torch.abs(s_dd) - pp["a_max"], min=0.0))
    cost = cost + PENALTY * _sum_steps(torch.clamp(torch.abs(d) - 4.0,
                                                   min=0.0))

    # the collision screen: the ego rectangle posed at every (candidate,
    # step) against every obstacle hull (the rectangle-analytic SAT)
    O = obs_hulls.shape[0]
    if O > 0:
        x0e = -pp["rear_axis_to_rear"]
        x1e = pp["rear_axis_to_front"]
        be = pp["width_ego"] / 2
        cs, sn = torch.cos(yaw), torch.sin(yaw)                # (C, N)
        hx, hy = obs_hulls[..., 0], obs_hulls[..., 1]          # (O, K)
        rel_x = hx - x[..., None, None]                        # (C,N,O,K)
        rel_y = hy - y[..., None, None]
        c4, s4 = cs[..., None, None], sn[..., None, None]
        qx = rel_x * c4 + rel_y * s4
        qy = -rel_x * s4 + rel_y * c4
        sep_ego = ((qx.amax(-1) < x0e) | (qx.amin(-1) > x1e)
                   | (qy.amax(-1) < -be) | (qy.amin(-1) > be))
        nrm = _edges_normals(obs_hulls)                        # (O, K, 2)
        po = (hx[:, :, None] * nrm[:, None, :, 0]
              + hy[:, :, None] * nrm[:, None, :, 1])          # (O, Kv, Ka)
        po_min, po_max = po.amin(-2), po.amax(-2)              # (O, K)
        n_x, n_y = nrm[..., 0], nrm[..., 1]
        nx = n_x * c4 + n_y * s4
        ny = -n_x * s4 + n_y * c4
        pc = n_x * x[..., None, None] + n_y * y[..., None, None]
        hi = torch.maximum(nx * x0e, nx * x1e) + torch.abs(ny) * be
        lo = torch.minimum(nx * x0e, nx * x1e) - torch.abs(ny) * be
        sep_obs = torch.any((pc + hi < po_min) | (pc + lo > po_max), dim=-1)
        hits = ~(sep_ego | sep_obs) & (obs_valid != 0.0)      # (C, N, O)
        n_hits = torch.sum(hits, dim=(1, 2)).to(f32)
        cost = cost + PENALTY * n_hits

    best = torch.argmin(cost)
    rows = [a[best] for a in (d, d_d, d_dd, s, s_d, s_dd, x, y, yaw, curv)]
    rows.append(torch.cat([seg[best], torch.zeros(1, dtype=f64,
                                                  device=dev)]))
    return torch.stack(rows), cost[best], best


_INV = {}


def _inverses(dev):
    """The quintic's and the quartic's float64 inverses on ``dev``, packed
    (36 + 25 values), made once."""
    inv = _INV.get(dev)
    if inv is None:
        inv = _INV[dev] = torch.as_tensor(
            np.concatenate([_HERMITE_INV[5].ravel(), _M4_INV.ravel()]),
            dtype=torch.float64, device=dev).contiguous()
    return inv


def _inputs(start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp_vec):
    """Checks the grid's inputs; returns (C, N, O, K)."""
    dev = di.device
    f32 = torch.float32
    C, N = di.shape[0], ts.shape[0]
    O = obs_hulls.shape[0]
    K = obs_hulls.shape[1] if obs_hulls.dim() == 3 else 0
    _check("start", start, (6,), f32, dev)
    for name, t in (("di", di), ("Ti", Ti), ("tv", tv)):
        _check(name, t, (C,), f32, dev)
    _check("ts", ts, (N,), f32, dev)
    if path.dim() != 2 or path.shape[1] != 6 or path.shape[0] < 2:
        raise ValueError(f"path must be (n, 6), got {tuple(path.shape)}")
    _check("path", path, path.shape, f32, dev)
    _check("obs_hulls", obs_hulls, (O, K, 2), f32, dev)
    _check("obs_valid", obs_valid, (O,), f32, dev)
    _check("pp", pp_vec, (len(PP_KEYS),), f32, dev)
    if C < 1 or N < 2:
        raise ValueError(f"{C} candidates of {N} steps: outside what the "
                         "grid takes")
    return C, N, O, K


def _launch(fn, args, C, N, O, K, prof=()):
    """``poly_sampling`` (or its profiling entry ``fn`` with the counter
    buffer ``prof``) on CUDA tensors: (packed, cost, best); the candidates'
    scratch is allocated here, the arrival counter is the stream's."""
    from tpl_tpu_torch import _build

    dev = args[1].device
    f64 = torch.float64
    lib = _kernel()
    if N > lib.poly_sampling_max_steps():
        raise ValueError(f"{N} steps: the grid takes at most "
                         f"{lib.poly_sampling_max_steps()}")
    rows = torch.empty((C, len(OUT_KEYS), N), dtype=f64, device=dev)
    costs = torch.empty(C, dtype=f64, device=dev)
    packed = torch.empty((len(OUT_KEYS), N), dtype=f64, device=dev)
    cost = torch.empty((), dtype=f64, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() for a in args), _inverses(dev).data_ptr(),
                 rows.data_ptr(), costs.data_ptr(), packed.data_ptr(),
                 cost.data_ptr(), best.data_ptr(),
                 _build.arrival_counter(dev, stream).data_ptr(),
                 *(b.data_ptr() for b in prof), C, N, args[5].shape[0], O, K,
                 stream)
    if err != 0:
        raise RuntimeError(f"poly_sampling launch failed: CUDA error {err}")
    return packed, cost, best


def run(start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp_vec):
    """The candidate grid's winner: (packed (11, N) float64, cost float64,
    index int64), the last two 0-d.  One launch (``poly_sampling``) on a
    CUDA tensor, :func:`run_reference` on a CPU tensor.  Arguments as
    :func:`run_reference`'s, float32, contiguous, on one device."""
    global launches
    args = (start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp_vec)
    C, N, O, K = _inputs(*args)
    dev = di.device
    if dev.type == "cpu":
        return run_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"poly_kernel: unsupported device {dev}")
    res = _launch(_kernel().poly_sampling, args, C, N, O, K)
    launches += 1
    return res


# the profiling instantiation's phases (csrc/poly_sampling.cu Phase): thread
# 0's cycles from barrier to barrier, summed over the blocks; the last one
# the last block's alone
PHASES = ("coefficients", "steps", "screen", "sums", "arrival", "selection")


def run_profile(start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp_vec):
    """The kernel's profiling instantiation on CUDA tensors (not counted
    as a launch of the main path): (packed, cost, best bit-equal to
    :func:`run`'s, {phase: clock64() cycles})."""
    args = (start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp_vec)
    C, N, O, K = _inputs(*args)
    if di.device.type != "cuda":
        raise ValueError("run_profile needs CUDA tensors")
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=di.device)
    res = _launch(_kernel().poly_sampling_profile, args, C, N, O, K, (prof,))
    return res + (dict(zip(PHASES, prof.cpu().tolist())),)


def make_poly_sampling_kernel(n_cand, n_steps, n_path, n_obs, n_hull):
    """The JAX package's factory: returns ``run(start, di, Ti, tv, ts, path,
    obs_hulls, obs_valid, pp)`` -> (packed (11, N), cost), on the device of
    the tensors given (host arrays go to :func:`tpl_tpu_torch.device`)."""

    def run_(start, di, Ti, tv, ts, path, obs_hulls, obs_valid, pp):
        from tpl_tpu_torch import device

        tensors = [a for a in (start, di, Ti, tv, ts, path, obs_hulls,
                               obs_valid, pp) if isinstance(a, torch.Tensor)]
        dev = tensors[0].device if tensors else device()

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32)
                                   if not isinstance(a, torch.Tensor) else a,
                                   dtype=torch.float32, device=dev
                                   ).contiguous()

        hulls = f32(obs_hulls).reshape(n_obs, n_hull, 2)
        packed, cost, _ = run(f32(start), f32(di), f32(Ti), f32(tv), f32(ts),
                              f32(path), hulls, f32(obs_valid), f32(pp))
        return packed, cost

    return run_


def unpack_result(packed, cost):
    packed = packed.cpu().numpy() if isinstance(packed, torch.Tensor) \
        else np.asarray(packed)
    out = {k: packed[i] for i, k in enumerate(OUT_KEYS)}
    out["cost"] = float(cost)
    return out


def pack_obstacles(obstacles, pad_multiple=4):
    """Pad variable obstacle hulls to a fixed (O, K, 2) block.

    Degenerate hulls (<3 vertices) are dropped; vertex padding repeats
    the last vertex (SAT-safe); obstacle-count padding rounds up to
    ``pad_multiple``.  Returns (hulls (O, K, 2) f32, valid (O,) bool).
    """
    hulls = [np.asarray(o["hull"], np.float32)[:, :2] for o in obstacles]
    hulls = [h for h in hulls if len(h) >= 3]
    n = len(hulls)
    O = max(pad_multiple, int(np.ceil(n / pad_multiple)) * pad_multiple) \
        if n else 0
    if O == 0:
        return np.zeros((0, 3, 2), np.float32), np.zeros(0, bool)
    K = max(len(h) for h in hulls)
    out = np.zeros((O, K, 2), np.float32)
    valid = np.zeros(O, bool)
    for i, h in enumerate(hulls):
        out[i, :len(h)] = h
        out[i, len(h):] = h[-1]
        valid[i] = True
    # padded entries: repeat the first hull so SAT math stays finite
    out[n:] = out[0]
    return out, valid


# ---------------------------------------------------------------------
# bounds

# Operations of one (candidate, step) as the plain version defines them,
# float64: the two polynomials and their derivatives by Horner (8
# evaluations of 2 x degree + 2), the four path lookups 8 each, the
# cartesian point, heading and curvature 20, the penalties and sums 20; per
# obstacle the rectangle SAT, 8 per vertex and 14 per edge normal.  Per
# candidate the coefficients (6 x 6 + 5 x 5 products and sums) and the
# cost, 160.
OPS = dict(step=8 * 11 + 32 + 20 + 20, vertex=8, edge=14, candidate=160)
# The critical path of one candidate's block, the kernel's phases one after
# the other: a coefficient (a 6-term sum); a polynomial value (Horner of 6
# terms, its division) a round of its warp's lanes; the heading of a step
# (the station's division and the heading's lookup, the slope's division
# and arc tangent; the x, the y and the speed-limit term take as long or
# less on their warps) a round; one (step, obstacle) test (the
# pose's sine, cosine and rotation, a running max a vertex, an edge
# normal's test a hull edge) a round; one term's N-step sum, the cost; then
# the last block's selection (its warp's compares, C / 32 a lane, and 5
# shuffle rounds).  The arrival's fence and atomic are not priced (no
# probe).
THREADS = 256
CHAIN_COEF = dict(f64_mul=1, f64_add=6)
CHAIN_VALUE = dict(f64_mul=6, f64_add=6, f64_div=1, smem_load=1)
CHAIN_GEOMETRY = dict(f64_mul=3, f64_add=6, f64_div=2, f32_fmod=1,
                      f64_atan=1, smem_load=3)
CHAIN_PAIR = dict(f64_sin=1, f64_cos=1, f64_mul=2, f64_add=2, smem_load=3)
CHAIN_PAIR_VERTEX = dict(f64_add=1)
CHAIN_PAIR_EDGE = dict(f64_mul=2, f64_add=4)
CHAIN_SUM_STEP = dict(f64_add=1, smem_load=1)
CHAIN_COST = dict(f64_mul=6, f64_add=12, smem_load=7)
CHAIN_SELECT_ROUND = dict(f64_add=1, smem_load=1)
CHAIN_REDUCE = dict(f64_add=5, smem_load=10)
# the pricing of the earlier two-launch design: a step's whole chain on one
# thread (Horner, a lookup, the sine and cosine, the curvature's division),
# then the step sums on one thread, N steps of 7 float64 additions, then
# the selection's C compares on one thread
SERIAL_STEP = dict(f64_mul=12, f64_add=20, f64_div=4, f64_sin=1, f64_cos=1,
                   smem_load=8)
SERIAL_PER_STEP = dict(f64_add=7, smem_load=7)
SERIAL_PER_CAND = dict(f64_add=1, smem_load=1)


def operations(C, N, O, K):
    per_step = OPS["step"] + O * (OPS["vertex"] * K + OPS["edge"] * K)
    return C * (N * per_step + OPS["candidate"])


def traffic_bytes(C, N, n_path, O, K):
    """Bytes the grid must move: the start, the three grids, the step
    times, the path rows the lookups touch (at most the path), the
    obstacles, the parameters and the inverses read once, the winner's
    rows and cost written once."""
    return (4 * (6 + 3 * C + N + min(n_path, 4 * C * N) * 6 + O * K * 2 + O
                 + len(PP_KEYS)) + 8 * (36 + 25) + 8 * (len(OUT_KEYS) * N
                                                        + 1) + 8)


def bound_ms(C, N, n_path, O, K):
    return _latency.roofline_ms(traffic_bytes(C, N, n_path, O, K),
                                operations(C, N, O, K), "float64")


def chain_ms(C, N, O, K, cycles, sm_mhz):
    """The critical path of the one-launch design (the constants above)."""
    ops = _latency.add_ops(dict(CHAIN_COEF), CHAIN_VALUE, -(-N // 32))
    _latency.add_ops(ops, CHAIN_GEOMETRY, -(-N // 32))
    if O:
        pair = _latency.add_ops(_latency.add_ops(
            dict(CHAIN_PAIR), CHAIN_PAIR_VERTEX, K), CHAIN_PAIR_EDGE, K)
        _latency.add_ops(ops, pair, -(-(N * O) // THREADS))
    _latency.add_ops(ops, CHAIN_SUM_STEP, N)
    _latency.add_ops(ops, CHAIN_COST, 1)
    _latency.add_ops(ops, CHAIN_SELECT_ROUND, -(-C // 32))
    _latency.add_ops(ops, CHAIN_REDUCE, 1)
    return _latency.chain_ms(ops, cycles, sm_mhz)


def serial_chain_ms(C, N, cycles, sm_mhz):
    """The pricing of the earlier two-launch design: a step's chain, then
    the 7 step sums on one thread, then C compares on one thread."""
    ops = _latency.add_ops(dict(SERIAL_STEP), SERIAL_PER_STEP, N)
    ops = _latency.add_ops(ops, SERIAL_PER_CAND, C)
    return _latency.chain_ms(ops, cycles, sm_mhz)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("poly_sampling")
        for fn, n_ptr in ((lib.poly_sampling, 16),
                          (lib.poly_sampling_profile, 17)):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
        for fn in (lib.poly_sampling_max_steps, lib.poly_sampling_n_params,
                   lib.poly_sampling_n_phases):
            fn.restype = ctypes.c_int
            fn.argtypes = []
        if (lib.poly_sampling_n_params() != len(PP_KEYS)
                or lib.poly_sampling_n_phases() != len(PHASES)):
            raise RuntimeError("poly_sampling.cu and PP_KEYS / PHASES "
                               "disagree")
        _LIB = lib
    return _LIB
