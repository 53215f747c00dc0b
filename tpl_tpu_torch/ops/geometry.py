"""
Polyline / polygon geometry kernel (host side, vectorized numpy).

Re-implements the behavior of the reference's C++ geometry kernel
(reference: library/src/utils.cpp — ``project`` utils.cpp:257, ``resample``
utils.cpp:410, ``convexHull`` utils.cpp:160, ``pointInPolygon`` utils.cpp:25,
SAT ``intersectPolygons`` utils.cpp:67-158) and the python path helpers
(reference: library/tpl/util.py:119-245).

The implementations here are new, vectorized numpy designs.
"""

import numpy as np

from tpl_tpu_torch import native
from tpl_tpu_torch.ops.interp import short_angle_dist


class Projection:
    """Projection of a point onto a polyline.

    Fields mirror the reference struct (library/include/tplcpp/utils.hpp:240-256):
    ``start``/``end`` are the vertex indices of the matched segment, ``alpha``
    the relative position on it, ``index`` the nearest vertex index, ``point``
    the foot point, ``distance`` the signed lateral distance (positive = left
    of the path), ``arc_len`` the arc length at the foot point, ``angle`` /
    ``tangent`` the interpolated path direction, ``in_bounds`` False when the
    projection clamps at an open path's first/last vertex.
    """

    __slots__ = ("start", "end", "alpha", "index", "point", "distance",
                 "arc_len", "angle", "tangent", "in_bounds")

    def __init__(self):
        self.start = 0
        self.end = 0
        self.alpha = 0.0
        self.index = 0
        self.point = np.zeros(2)
        self.distance = 0.0
        self.arc_len = 0.0
        self.angle = 0.0
        self.tangent = np.zeros(2)
        self.in_bounds = False

    def __repr__(self):
        return (f"Projection(index={self.index}, arc_len={self.arc_len:.3f}, "
                f"distance={self.distance:.3f}, in_bounds={self.in_bounds})")


def _project_core(points, positions, closed):
    """Vectorized core: project M positions onto an N-vertex polyline.

    Returns dict of arrays with all Projection fields (leading dim M).
    Takes the C route of :mod:`tpl_tpu_torch.native` unless that is switched
    off; the numpy path below is its oracle.
    """
    points = np.asarray(points, dtype=np.float64)
    positions = np.atleast_2d(np.asarray(positions, dtype=np.float64))
    n = len(points)

    if n < 2:
        # degenerate polyline (e.g. a path_segment window clipped at an
        # open path's end): no segments to visit — the reference returns
        # a default projection with distance = INFINITY in that case
        # (utils.cpp:257-263: the segment loop never runs)
        m = len(positions)
        return dict(
            start=np.zeros(m, dtype=np.int64),
            end=np.zeros(m, dtype=np.int64),
            alpha=np.zeros(m),
            index=np.zeros(m, dtype=np.int64),
            point=(np.tile(points[0], (m, 1)) if n == 1
                   else np.zeros((m, 2))),
            distance=np.full(m, np.inf),
            arc_len=np.zeros(m),
            angle=np.zeros(m),
            tangent=np.zeros((m, 2)),
            in_bounds=np.zeros(m, dtype=bool))

    if native.enabled():
        res = native.project(points, positions, closed)
        return dict(
            start=res[:, 0].astype(np.int64),
            end=res[:, 1].astype(np.int64),
            alpha=res[:, 2],
            index=res[:, 3].astype(np.int64),
            point=res[:, 4:6],
            distance=res[:, 6],
            arc_len=res[:, 7],
            angle=res[:, 8],
            tangent=res[:, 9:11],
            in_bounds=res[:, 11] != 0.0)

    if closed:
        seg_prev = points
        seg_next = np.roll(points, -1, axis=0)
    else:
        seg_prev = points[:-1]
        seg_next = points[1:]

    v = seg_next - seg_prev                          # (S, 2)
    seg_len = np.linalg.norm(v, axis=1)              # (S,)
    vv = np.maximum(np.sum(v * v, axis=1), 1e-300)

    # arc length at segment starts
    arc0 = np.concatenate([[0.0], np.cumsum(seg_len)])[:-1]   # (S,)

    pv = positions[:, None, :] - seg_prev[None, :, :]          # (M, S, 2)
    q = np.einsum("msd,sd->ms", pv, v) / vv                    # (M, S)

    n_seg = len(seg_prev)
    # in-bounds bookkeeping matches utils.cpp:294-305: clamping at an interior
    # vertex keeps in_bounds; only the open path's outermost clamps lose it
    # (and any clamp on a closed path).
    first_seg = np.zeros(n_seg, dtype=bool)
    last_seg = np.zeros(n_seg, dtype=bool)
    if not closed:
        first_seg[0] = True
        last_seg[-1] = True

    below = q < 0.0
    above = q > 1.0
    if closed:
        in_b = ~(below | above)
    else:
        in_b = np.ones_like(q, dtype=bool)
        in_b = np.where(below & first_seg[None, :], False, in_b)
        in_b = np.where(above & last_seg[None, :], False, in_b)

    qc = np.clip(q, 0.0, 1.0)
    foot = seg_prev[None, :, :] + v[None, :, :] * qc[..., None]  # (M, S, 2)
    d2 = np.sum((positions[:, None, :] - foot) ** 2, axis=2)     # (M, S)

    best = np.argmin(d2, axis=1)                                  # (M,)
    m_idx = np.arange(len(positions))

    alpha = qc[m_idx, best]
    point = foot[m_idx, best]
    dist = np.sqrt(d2[m_idx, best])
    in_bounds = in_b[m_idx, best]

    # segment index i in the reference counts from 1 (end-vertex index)
    i_ref = best + 1

    if closed:
        idx_start = np.mod(i_ref - 1, n)
        idx_end = np.mod(i_ref, n)
        idx_next = np.mod(i_ref + 1, n)
    else:
        idx_start = np.maximum(0, i_ref - 1)
        idx_end = i_ref.copy()
        idx_next = np.minimum(n - 1, i_ref + 1)

    index = np.where(alpha < 0.5, idx_start, idx_end)

    # arc length: cumulative up to segment start + distance from segment start
    arc_dist = np.linalg.norm(point - seg_prev[best], axis=1)
    arc_len = arc0[best] + arc_dist

    # interpolated tangent (utils.cpp:376-390)
    pv0 = points[idx_start]
    pv1 = points[idx_end]
    seg_v = pv1 - pv0
    seg_v = seg_v / np.maximum(np.linalg.norm(seg_v, axis=1, keepdims=True), 1e-300)
    pv2 = points[idx_next]
    next_v = pv2 - pv1
    nv_norm = np.linalg.norm(next_v, axis=1, keepdims=True)
    next_v = next_v / np.maximum(nv_norm, 1e-300)
    interp_ok = index < n - 2
    tangent = np.where(interp_ok[:, None],
                       alpha[:, None] * next_v + (1.0 - alpha[:, None]) * seg_v,
                       seg_v)
    angle = np.arctan2(tangent[:, 1], tangent[:, 0])

    # distance sign: positive when the position lies left of the path
    # (utils.cpp:392-404)
    ortho = point - positions
    on = np.linalg.norm(ortho, axis=1, keepdims=True)
    ortho = ortho / np.maximum(on, 1e-300)
    ortho_rot = np.stack([-ortho[:, 1], ortho[:, 0]], axis=1)
    sign_neg = np.einsum("md,md->m", seg_v, ortho_rot) <= 0.0
    dist = np.where(sign_neg, -dist, dist)
    # degenerate: position exactly on the line -> distance 0, keep +0
    dist = np.where(on[:, 0] < 1e-12, 0.0, dist)

    return dict(start=idx_start, end=idx_end, alpha=alpha, index=index,
                point=point, distance=dist, arc_len=arc_len, angle=angle,
                tangent=tangent, in_bounds=in_bounds)


def _make_proj(res, i):
    p = Projection()
    p.start = int(res["start"][i])
    p.end = int(res["end"][i])
    p.alpha = float(res["alpha"][i])
    p.index = int(res["index"][i])
    p.point = res["point"][i].copy()
    p.distance = float(res["distance"][i])
    p.arc_len = float(res["arc_len"][i])
    p.angle = float(res["angle"][i])
    p.tangent = res["tangent"][i].copy()
    p.in_bounds = bool(res["in_bounds"][i])
    return p


def project(points, position, closed=False):
    """Project position(s) onto a polyline.

    Single position -> single Projection; (M, 2) positions -> list of
    Projections (matching the reference pybind API, utils.cpp:778+).
    """
    position = np.asarray(position, dtype=np.float64)
    single = position.ndim == 1
    res = _project_core(points, position, closed)
    if single:
        return _make_proj(res, 0)
    return [_make_proj(res, i) for i in range(len(res["alpha"]))]


def project_many(points, positions, closed=False):
    """Batched projection returning the raw dict of field arrays."""
    return _project_core(points, positions, closed)


def resample(points, sampling_dist, steps, start_index=0, closed=False):
    """Equidistant (euclidean chord) resampling of a polyline.

    Marches along the polyline intersecting each segment with a circle of
    radius ``sampling_dist`` centered at the last sample (reference:
    library/src/utils.cpp:410-560). Returns an (steps, 5) array with
    columns [x, y, alpha, prev_idx, next_idx], where ``alpha`` is the
    relative position on segment (prev, next) (can exceed 1 when
    extrapolating past the end of an open path).

    Raises RuntimeError when no next sample can be found.
    """
    pts_arr = np.asarray(points, dtype=np.float64)
    if (native.enabled() and pts_arr.ndim == 2 and pts_arr.shape[0] > 0
            and steps > 0):
        return native.resample(pts_arr, sampling_dist, steps, start_index,
                               closed)
    pts = pts_arr[:, :2]
    if len(pts) == 0 or steps == 0:
        return np.zeros((0, 5))

    # drop consecutive duplicates
    keep = np.ones(len(pts), dtype=bool)
    keep[1:] = np.linalg.norm(np.diff(pts, axis=0), axis=1) != 0.0
    pts = pts[keep]
    n = len(pts)

    if n == 1:
        out = np.zeros((1, 5))
        out[0, :2] = pts[0]
        return out

    if closed:
        start_index = start_index % n
    else:
        start_index = max(0, min(start_index, n - 1))

    out = np.zeros((steps, 5))
    out[0, :2] = pts[start_index]
    out[0, 3] = start_index
    out[0, 4] = (start_index + 1) % n if closed else min(start_index + 1, n - 1)

    r2 = sampling_dist * sampling_dist
    i = start_index
    count = 1
    while count < steps:
        progressed = False
        for k in range(n):
            prev_idx = i + k
            next_idx = i + k + 1
            if closed:
                prev_idx %= n
                next_idx %= n
            else:
                prev_idx = max(0, min(prev_idx, n - 2))
                next_idx = max(0, min(next_idx, n - 1))

            p0 = pts[prev_idx]
            p1 = pts[next_idx]
            v = p1 - p0
            ls = v @ v
            l = np.sqrt(ls)
            c = out[count - 1, :2]

            # line-circle intersection (determinant form)
            D = (p0[0] - c[0]) * (p1[1] - c[1]) - (p1[0] - c[0]) * (p0[1] - c[1])
            disc = r2 * ls - D * D
            if disc < 0:
                raise RuntimeError("cannot solve for next sampling point")

            sq = np.sqrt(disc)
            sign_y = -1.0 if v[1] < 0.0 else 1.0
            x_part0 = D * v[1]
            y_part0 = -D * v[0]
            x_part1 = sign_y * v[0] * sq
            y_part1 = abs(v[1]) * sq

            pa = np.array([(x_part0 + x_part1) / ls + c[0],
                           (y_part0 + y_part1) / ls + c[1]])
            pb = np.array([(x_part0 - x_part1) / ls + c[0],
                           (y_part0 - y_part1) / ls + c[1]])

            qa = (v / l) @ (pa - p0) / l
            qb = (v / l) @ (pb - p0) / l
            if qa < qb:
                qa, pa = qb, pb

            tol = 1e-8
            if (not closed and next_idx == n - 1) or (-tol < qa and qa - 1.0 < tol):
                i = prev_idx
                out[count, 0] = pa[0]
                out[count, 1] = pa[1]
                out[count, 2] = qa
                out[count, 3] = prev_idx
                out[count, 4] = next_idx
                count += 1
                progressed = True
                break
        if not progressed:
            raise RuntimeError("resampling failed")

    return out


def interp_resampled_path(path, rsi, step_size, steps, zero_vel_at_end=False,
                          closed=False):
    """Recover [x, y, phi, s, k, v] channels on a resampled path.

    (reference: library/tpl/util.py:154-191) ``path`` carries at least 6
    columns with orientation at col 2 and velocity at col 5; ``rsi`` is the
    output of :func:`resample`.
    """
    path = np.asarray(path, dtype=np.float64)
    rsi = np.asarray(rsi, dtype=np.float64)
    m = len(rsi)

    rs = np.zeros((steps, 6))
    rs[:m, :2] = rsi[:, :2]

    t = rsi[:, 2]
    prevs = path[rsi[:, 3].astype(int)]
    nexts = path[rsi[:, 4].astype(int)]

    extrap = (not closed) & (rsi[:, 4].astype(int) == len(path) - 1) & (t > 1.0)

    phi_interp = prevs[:, 2] + t * short_angle_dist(prevs[:, 2], nexts[:, 2])
    v_interp = (1.0 - t) * prevs[:, 5] + t * nexts[:, 5]
    v_extrap = np.zeros(m) if zero_vel_at_end else nexts[:, 5]

    rs[:m, 2] = np.where(extrap, nexts[:, 2], phi_interp)
    rs[:m, 3] = step_size * np.arange(m)
    rs[:m, 5] = np.where(extrap, v_extrap, v_interp)

    # curvature from consecutive orientations (util.py:178-189)
    if m > 1:
        dphi = short_angle_dist(rs[:m - 1, 2], rs[1:m, 2])
        rs[:m - 1, 4] = 2.0 * np.sin(dphi / 2.0) / step_size
        if closed:
            gap = np.linalg.norm(rs[0, :2] - rs[m - 1, :2])
            if gap == 0.0:
                rs[m - 1, 4] = rs[m - 2, 4]
            else:
                rs[m - 1, 4] = 2.0 * np.sin(
                    short_angle_dist(rs[m - 1, 2], rs[0, 2]) / 2.0) / gap
        else:
            rs[m - 1, 4] = rs[m - 2, 4]

    return rs


def resample_path(path, step_size, steps, start_index=0, zero_vel_at_end=False,
                  closed=False):
    """Resample a [x, y, ...] path into equidistant steps.

    (reference: library/tpl/util.py:134-151). Returns None on failure.
    """
    path = np.asarray(path)
    try:
        rsi = resample(path[:, :2], step_size, steps, start_index, closed)
    except RuntimeError:
        return None
    return interp_resampled_path(path, rsi, step_size, steps,
                                 zero_vel_at_end, closed)


def path_segment(path, steps_max, start_index=0, closed=False):
    """Slice a window out of a path, wrapping if closed.

    (reference: library/tpl/util.py:119-131)
    """
    end_index = int(start_index + steps_max)
    step = 1 if end_index >= start_index else -1
    if closed:
        steps = np.arange(start_index, end_index, step) % len(path)
    else:
        end_index = max(0, min(len(path) - 1, end_index))
        steps = np.arange(start_index, end_index, step)
    return path[steps]


def build_route(route):
    """Augment an (N, >=2) waypoint array to [x, y, phi, s, k, v_lim].

    (reference: library/tpl/util.py:194-245)
    """
    route = np.asarray(route, dtype=np.float64)
    pos = route[:, :2]
    d = np.diff(pos, axis=0)
    seg_len = np.linalg.norm(d, axis=1)

    angles = np.zeros(len(pos))
    angles[:-1] = np.arctan2(d[:, 1], d[:, 0])
    angles[-1] = angles[-2]

    dists = np.concatenate([[0.0], np.cumsum(seg_len)])

    # k_i = short_angle_dist(a_i, a_{i+1}) / |p_{i+1} - p_i|
    curvs = np.zeros(len(pos))
    prev_a = np.r_[angles[0], angles[1:-1]]
    curvs[:-1] = short_angle_dist(prev_a, angles[1:]) / np.maximum(seg_len, 1e-12)
    curvs[-1] = curvs[-2]

    if route.shape[1] > 2:
        v_lim = route[:, -1]
    else:
        v_lim = np.full(len(pos), 30.0 / 3.6)

    return np.column_stack([pos, angles, dists, curvs, v_lim])


def convex_hull(points):
    """Convex hull via Andrew's monotone chain, CCW order.

    (reference behavior: library/src/utils.cpp:160-230 convexHull)
    """
    pts = np.unique(np.asarray(points, dtype=np.float64)[:, :2], axis=0)
    if len(pts) <= 2:
        return pts
    # lexicographic sort
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points_iter):
        hull = []
        for p in points_iter:
            while len(hull) >= 2 and cross2(hull[-2], hull[-1], p) <= 0:
                hull.pop()
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def point_in_polygon(point, polygon):
    """Ray-casting point-in-polygon test. (utils.cpp:25-65)"""
    poly = np.asarray(polygon, dtype=np.float64)
    x, y = np.asarray(point, dtype=np.float64)[:2]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    cond = (y0 > y) != (y1 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    crossings = cond & (x < x_int)
    return bool(np.count_nonzero(crossings) % 2)


def _sat_separated(poly0, poly1):
    """True if some edge normal of poly0 separates the polygons."""
    edges = np.roll(poly0, -1, axis=0) - poly0
    normals = np.stack([-edges[:, 1], edges[:, 0]], axis=1)
    p0 = poly0 @ normals.T   # (n0, n_axes)
    p1 = poly1 @ normals.T
    return np.any((p0.max(axis=0) < p1.min(axis=0)) |
                  (p1.max(axis=0) < p0.min(axis=0)))


def intersect_polygons(poly0, poly1):
    """Convex polygon intersection test via separating axes.

    (reference: library/src/utils.cpp:67-158)
    """
    poly0 = np.asarray(poly0, dtype=np.float64)[:, :2]
    poly1 = np.asarray(poly1, dtype=np.float64)[:, :2]
    if len(poly0) == 0 or len(poly1) == 0:
        return False
    if len(poly0) == 1:
        return point_in_polygon(poly0[0], poly1)
    if len(poly1) == 1:
        return point_in_polygon(poly1[0], poly0)
    return not (_sat_separated(poly0, poly1) or _sat_separated(poly1, poly0))


def intersect_polygons_batch(hulls, poly):
    """Batched convex SAT: hulls (M, Ka, 2) each tested against one convex
    poly (Kb, 2); returns (M,) bool intersection flags.  One vectorized
    program instead of M scalar `intersect_polygons` calls — this is the
    host-side batch twin used by the sampling planners' per-candidate
    collision screens (reference does these per-pair in C++,
    library/src/poly_sampling.cpp:192-258)."""
    hulls = np.asarray(hulls, dtype=np.float64)[..., :2]
    poly = np.asarray(poly, dtype=np.float64)[:, :2]
    if hulls.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    if hulls.shape[1] == 0:
        return np.zeros(hulls.shape[0], dtype=bool)
    if len(poly) < 2 or hulls.shape[1] < 2:
        return np.array([intersect_polygons(h, poly) for h in hulls])

    # axes from each hull's edges: (M, Ka, 2)
    e_h = np.roll(hulls, -1, axis=1) - hulls
    n_h = np.stack([-e_h[..., 1], e_h[..., 0]], axis=-1)
    # hull projections onto own axes: (M, Ka_pts, Ka_axes)
    p_hh = np.einsum("mka,mja->mkj", hulls, n_h)
    # poly projections onto hull axes: (M, Kb, Ka_axes)
    p_ph = np.einsum("ka,mja->mkj", poly, n_h)
    sep_h = np.any((p_hh.max(axis=1) < p_ph.min(axis=1)) |
                   (p_ph.max(axis=1) < p_hh.min(axis=1)), axis=1)

    # axes from the poly's edges (shared): (Kb, 2)
    e_p = np.roll(poly, -1, axis=0) - poly
    n_p = np.stack([-e_p[:, 1], e_p[:, 0]], axis=1)
    p_pp = poly @ n_p.T                       # (Kb_pts, Kb_axes)
    p_hp = hulls @ n_p.T                      # (M, Ka, Kb_axes)
    sep_p = np.any((p_pp.max(axis=0)[None] < p_hp.min(axis=1)) |
                   (p_hp.max(axis=1) < p_pp.min(axis=0)[None]), axis=1)

    return ~(sep_h | sep_p)
