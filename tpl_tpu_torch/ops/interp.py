"""
Interpolation primitives: host-side numpy helpers and the torch table
lookups of the solver problems.

``normalize_angle`` / ``short_angle_dist`` follow the reference's python
helpers (library/tpl/util.py:92-108); ``lerp_xs`` is the equally-spaced
vector interpolation of library/tpl/environment/prediction_module.py:10-38.

``lerp`` / ``lerp_angle`` / ``lerp_multi`` / ``box_interp`` / ``blerp`` are
the torch lookups of the generated solver runtime (optim.c:332-480): floor /
ceil indices clamped to the table, alpha clamped to [0, 1].  Written as plain
index-and-clamp formulas, torch autograd and ``torch.func`` give them the
genopt-parity derivatives of the JAX package's custom JVPs: slope
``v1 - v0`` between the clamped indices (zero exactly on a grid point,
where both indices coincide, and in the clamped regions), no second
derivative in the query, and a zero slope for ``box_interp``
(tests/test_torch_ilqr.py checks this).

The five lookups are overridable (``torch.overrides``): an argument with
``__torch_function__`` (the tracer's symbolic tensor,
:mod:`tpl_tpu_torch.optim.trace`) receives the lookup whole instead of its
floor / gather internals.  Tensors take the formulas below.
"""

import numpy as np
import torch
from torch.overrides import handle_torch_function, has_torch_function


def normalize_angle(a):
    """Normalize angle(s) to (-pi, pi]. (reference: library/tpl/util.py:92-100)"""
    a = np.mod(np.mod(a, 2 * np.pi) + 2 * np.pi, 2 * np.pi)
    return np.where(a > np.pi, a - 2 * np.pi, a)


def short_angle_dist(a0, a1):
    """Shortest signed angular distance from a0 to a1, in [-pi, pi).

    (reference: library/tpl/optim/templates/optim.c:332-338 shortAngleDist)
    Implemented as the single-mod form ``mod(da + pi, 2pi) - pi``, which
    is the identical function to the reference's double-mod form in
    exact arithmetic but has no float32 cancellation catastrophe: the
    double-mod rounds ``mod(-1e-9, 2pi)`` to exactly 2pi in f32, making
    the result -2pi instead of ~0."""
    return np.mod((a1 - a0) + np.pi, 2 * np.pi) - np.pi


def lerp_xs(x, xs, ys, angle=False, clip_alpha=False):
    """Interpolation assuming equally spaced `xs`, vector-valued `ys`.

    (reference: library/tpl/environment/prediction_module.py:10-38)
    """
    ys = np.asarray(ys)
    l = ys.shape[0]
    if l == 1:
        return ys[0]
    dx = xs[1] - xs[0]
    q = (x - xs[0]) / dx
    start = np.clip(np.floor(q), 0, l - 2).astype(int)
    end = np.clip(np.ceil(q), 0, l - 1).astype(int)
    a = q - start
    if clip_alpha:
        a = np.clip(a, 0.0, 1.0)
    if angle:
        return ys[start] + short_angle_dist(ys[start], ys[end]) * a
    if ys.ndim > 1:
        a = np.expand_dims(a, -1) if np.ndim(a) else a
    return ys[start] * (1.0 - a) + ys[end] * a


def short_angle_dist_t(a0, a1):
    """torch :func:`short_angle_dist` (floored mod, as ``jnp.mod``)."""
    return torch.remainder((a1 - a0) + np.pi, 2 * np.pi) - np.pi


def _indices_t(q, n):
    """Clamped floor / ceil indices and alpha of fractional index ``q``.
    A NaN query reads row 0; its alpha, and so the lookup, stays NaN."""
    qs = torch.nan_to_num(q, nan=0.0)
    i0 = torch.clamp(torch.floor(qs), 0, n - 1)
    i1 = torch.clamp(torch.ceil(qs), 0, n - 1)
    a = torch.clamp(q - i0, 0.0, 1.0)
    return i0.long(), i1.long(), a


def _take(table, idx):
    """``table[idx]`` along the first dim (``index_select``, which also
    batches under ``torch.func.vmap``)."""
    rows = torch.index_select(table, 0, idx.reshape(-1))
    return rows.reshape(idx.shape + table.shape[1:])


def lerp(x0, dx, x, arr):
    """Linear interpolation into the equally spaced 1-D tensor ``arr``."""
    args = (x0, dx, x, arr)
    if has_torch_function(args):
        return handle_torch_function(lerp, args, *args)
    i0, i1, a = _indices_t((x - x0) / dx, arr.shape[0])
    v0, v1 = _take(arr, i0), _take(arr, i1)
    return v0 + a * (v1 - v0)


def lerp_multi(x0, dx, x, mat):
    """:func:`lerp` into the columns of ``mat`` (n, C) at one query;
    returns shape (..., C)."""
    args = (x0, dx, x, mat)
    if has_torch_function(args):
        return handle_torch_function(lerp_multi, args, *args)
    i0, i1, a = _indices_t((x - x0) / dx, mat.shape[0])
    v0, v1 = _take(mat, i0), _take(mat, i1)
    return v0 + a[..., None] * (v1 - v0)


def lerp_angle(x0, dx, x, arr):
    """Like :func:`lerp`, along the short angular distance."""
    args = (x0, dx, x, arr)
    if has_torch_function(args):
        return handle_torch_function(lerp_angle, args, *args)
    n = arr.shape[0]
    q = torch.clamp((x - x0) / dx, 0.0, n - 1.0)
    i0, i1, a = _indices_t(q, n)
    v0, v1 = _take(arr, i0), _take(arr, i1)
    return v0 + short_angle_dist_t(v0, v1) * a


def box_interp(dx, x, arr):
    """Nearest-below (piecewise constant) lookup. (optim.c:357-369)"""
    args = (dx, x, arr)
    if has_torch_function(args):
        return handle_torch_function(box_interp, args, *args)
    q = torch.nan_to_num(x / dx, nan=0.0)
    return _take(arr, torch.clamp(torch.floor(q), 0, arr.shape[0] - 1).long())


def blerp(x0, y0, dx, dy, x, y, arr):
    """Bilinear interpolation into the equally spaced 2-D tensor ``arr``
    (rows along y, columns along x), both axes clamped as :func:`lerp`.
    (optim.c:452-480)"""
    args = (x0, y0, dx, dy, x, y, arr)
    if has_torch_function(args):
        return handle_torch_function(blerp, args, *args)
    rows, cols = arr.shape
    xs, xe, xa = _indices_t((x - x0) / dx, cols)
    ys, ye, ya = _indices_t((y - y0) / dy, rows)
    p0 = (1.0 - ya) * arr[ys, xs] + ya * arr[ye, xs]
    p1 = (1.0 - ya) * arr[ys, xe] + ya * arr[ye, xe]
    return (1.0 - xa) * p0 + xa * p1
