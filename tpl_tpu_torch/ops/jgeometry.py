"""
Torch twins of the host geometry kernel for device-resident inputs.

Semantics follow :mod:`tpl_tpu_torch.ops.geometry` (and thereby the
reference's library/src/utils.cpp:257 ``project``): signed distance positive
left of the path, arc length at the foot point, in_bounds False when
clamping at an open polyline's outermost vertices.
"""

import torch


def project_polyline(points, pos):
    """Project position(s) onto an open polyline.

    points: (N, 2); pos: (..., 2).
    Returns dict with arc_len, distance, in_bounds, angle, point, alpha,
    index (leading dims match pos).
    """
    seg_a = points[:-1]                       # (S, 2)
    seg_b = points[1:]
    v = seg_b - seg_a                         # (S, 2)
    vv = torch.clamp(torch.sum(v * v, dim=-1), min=1e-12)
    seg_len = torch.sqrt(vv)
    arc0 = torch.cat([seg_len.new_zeros(1), torch.cumsum(seg_len, 0)])[:-1]

    pv = pos[..., None, :] - seg_a            # (..., S, 2)
    q = torch.sum(pv * v, dim=-1) / vv        # (..., S)
    qc = torch.clamp(q, 0.0, 1.0)
    foot = seg_a + v * qc[..., None]          # (..., S, 2)
    d2 = torch.sum((pos[..., None, :] - foot) ** 2, dim=-1)

    best = torch.argmin(d2, dim=-1)           # (...,) first minimum

    def take(arr):
        return torch.gather(arr, -1, best[..., None])[..., 0]

    alpha = take(qc)
    dist = torch.sqrt(take(d2))
    point = torch.gather(
        foot, -2, best[..., None, None].expand(*best.shape, 1, 2))[..., 0, :]

    n_seg = seg_a.shape[0]
    in_bounds = ~(((best == 0) & (take(q) < 0.0))
                  | ((best == n_seg - 1) & (take(q) > 1.0)))

    arc_len = arc0[best] + torch.sqrt(
        torch.sum((point - seg_a[best]) ** 2, dim=-1))

    seg_dir = v[best] / seg_len[best][..., None]
    angle = torch.atan2(seg_dir[..., 1], seg_dir[..., 0])

    # sign: positive when pos is left of the path
    ortho = point - pos
    on = torch.sqrt(torch.sum(ortho * ortho, dim=-1, keepdim=True))
    ortho = ortho / torch.clamp(on, min=1e-12)
    ortho_rot = torch.stack([-ortho[..., 1], ortho[..., 0]], dim=-1)
    sign_neg = torch.sum(seg_dir * ortho_rot, dim=-1) <= 0.0
    dist = torch.where(sign_neg, -dist, dist)
    dist = torch.where(on[..., 0] < 1e-9, torch.zeros_like(dist), dist)

    return dict(arc_len=arc_len, distance=dist, in_bounds=in_bounds,
                angle=angle, point=point, alpha=alpha, index=best)


def polygons_intersect(poly_a, poly_b):
    """SAT convex intersection test, batched over leading dims.

    poly_a: (..., Ka, 2); poly_b: (..., Kb, 2). Degenerate repeated
    vertices are handled (zero-length edge axes skipped).
    """
    def separated(p, q):
        e = torch.roll(p, -1, dims=-2) - p
        elen = torch.sqrt(torch.sum(e * e, dim=-1))
        n = torch.stack([-e[..., 1], e[..., 0]], dim=-1)
        pa = torch.einsum("...kd,...ad->...ka", n, p)
        pb = torch.einsum("...kd,...ad->...ka", n, q)
        gap = ((torch.amax(pa, dim=-1) < torch.amin(pb, dim=-1))
               | (torch.amax(pb, dim=-1) < torch.amin(pa, dim=-1)))
        gap = gap & (elen > 1e-9)
        return torch.any(gap, dim=-1)

    return ~(separated(poly_a, poly_b) | separated(poly_b, poly_a))
