"""
Small fixed-(A, B, Q, R) LQR tracking smoother.

Re-implements the reference's header-only ``lqrSmoother`` and ``smoothPath``
(reference: library/include/tplcpp/utils.hpp:278-347,
library/src/utils.cpp:694-777): a finite-horizon LQR that tracks a reference
state sequence, used for path smoothing and for the DP planners'
trajectory smoothing stage.
"""

import numpy as np
import torch


# The Vxx recursion (and thus the feedback gains K and all derived
# operators) depends only on (H, fx, fu, lxx, luu) — NOT on the tracked
# reference — so it is cached per problem shape.  Per call, only the
# reference-dependent Vx recursion runs: Vx_i = -lxx_i @ xref_i + G_i @
# Vx_{i+1} with k_i = Wfu_i @ Vx_{i+1}, where G and Wfu are the cached
# condensed operators.  This makes the per-tick trajectory smoothing of
# the DP planners (two 4-state chains per tick) a cheap linear recursion.
_GAIN_CACHE = {}
_GAIN_CACHE_MAX = 64


def _lqr_gains(H, fx, fu, lxx, luu):
    key = (H, fx.tobytes(), fu.tobytes(), lxx.tobytes(), luu.tobytes())
    hit = _GAIN_CACHE.get(key)
    if hit is not None:
        return hit

    X = fx.shape[0]
    U = fu.shape[1]
    Ks = np.zeros((H, U, X))
    Gs = np.zeros((H - 1, X, X))
    Wfus = np.zeros((H - 1, U, X))

    Vxx = lxx[-1].copy()
    for i in range(H - 2, -1, -1):
        Qxx = lxx[i] + fx.T @ Vxx @ fx
        Quu = luu[i] + fu.T @ Vxx @ fu
        Qux = fu.T @ Vxx @ fx
        W = -np.linalg.inv(Quu)
        Ks[i] = W @ Qux
        Wfu = W @ fu.T
        Wfus[i] = Wfu
        Gs[i] = fx.T + (Ks[i].T @ Quu @ W + Ks[i].T + Qux.T @ W) @ fu.T
        tmp = Ks[i].T @ Qux
        Vxx = Qxx + Ks[i].T @ Quu @ Ks[i] + tmp + tmp.T

    if len(_GAIN_CACHE) >= _GAIN_CACHE_MAX:
        _GAIN_CACHE.clear()
    _GAIN_CACHE[key] = (Ks, Gs, Wfus)
    return Ks, Gs, Wfus


def lqr_smoother(x0, x_ref, fx, fu, lxx, luu):
    """Track x_ref with linear dynamics (fx, fu) and quadratic costs.

    lxx: (H, X, X) or (X, X); luu: (H, U, U) or (U, U).
    Returns (xs (H, X), us (H, U)).
    """
    x_ref = np.asarray(x_ref, dtype=np.float64)
    H, X = x_ref.shape
    fx = np.asarray(fx, dtype=np.float64)
    fu = np.asarray(fu, dtype=np.float64)
    U = fu.shape[1]

    lxx = np.asarray(lxx, dtype=np.float64)
    luu = np.asarray(luu, dtype=np.float64)
    if lxx.ndim == 2:
        lxx = np.broadcast_to(lxx, (H, X, X))
    if luu.ndim == 2:
        luu = np.broadcast_to(luu, (H, U, U))

    Ks, Gs, Wfus = _lqr_gains(H, fx, fu, lxx, luu)

    # reference-dependent feedforward: backward linear recursion over the
    # condensed operators
    lx_terms = -np.einsum("hij,hj->hi", lxx, x_ref)
    ks = np.zeros((H, U))
    Vx = lx_terms[-1]
    for i in range(H - 2, -1, -1):
        ks[i] = Wfus[i] @ Vx
        Vx = lx_terms[i] + Gs[i] @ Vx

    xs = np.zeros((H, X))
    us = np.zeros((H, U))
    xs[0] = x0
    for i in range(H - 1):
        us[i] = Ks[i] @ xs[i] + ks[i]
        xs[i + 1] = fx @ xs[i] + fu @ us[i]
    return xs, us


def lqr_smoother_torch(x0, x_ref, fx, fu, lxx, luu, device=None):
    """:func:`lqr_smoother` on tensors, float64, on ``device`` (the port's,
    ``tpl_tpu_torch.device()``, unless given), with per-step ``lxx`` (H, X,
    X) and ``luu`` (H, U, U): the Riccati recursion backward over the
    steps, then the rollout.  The counterpart of the JAX package's
    ``lqr_smoother_jax``.  Returns tensors (xs (H, X), us (H, U)); the last
    step's action is 0."""
    if device is None:
        import tpl_tpu_torch
        device = tpl_tpu_torch.device()
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64)
                                  if not torch.is_tensor(a) else a,
                                  dtype=torch.float64, device=device)
    x0, x_ref, fx, fu, lxx, luu = map(f, (x0, x_ref, fx, fu, lxx, luu))
    H, X = x_ref.shape
    U = fu.shape[1]
    ks = torch.zeros((H, U), dtype=torch.float64, device=device)
    Ks = torch.zeros((H, U, X), dtype=torch.float64, device=device)
    Vxx = lxx[-1]
    Vx = -lxx[-1] @ x_ref[-1]
    for i in range(H - 2, -1, -1):
        Qx = -lxx[i] @ x_ref[i] + fx.T @ Vx
        Qu = fu.T @ Vx
        Qxx = lxx[i] + fx.T @ Vxx @ fx
        Quu = luu[i] + fu.T @ Vxx @ fu
        Qux = fu.T @ Vxx @ fx
        W = -torch.linalg.inv(Quu)
        k, K = W @ Qu, W @ Qux
        Vx = Qx + K.T @ Quu @ k + K.T @ Qu + Qux.T @ k
        tmp = K.T @ Qux
        Vxx = Qxx + K.T @ Quu @ K + tmp + tmp.T
        ks[i], Ks[i] = k, K
    xs, us, x = [], [], x0
    for i in range(H):
        u = Ks[i] @ x + ks[i]
        xs.append(x)
        us.append(u)
        x = fx @ x + fu @ u
    return torch.stack(xs), torch.stack(us)


def smooth_path_positions(path_xy, ds, w_v=1.0, w_a=1.0, w_j=1.0,
                          closed=False):
    """LQR-smooth a 2-D polyline (triple-integrator per axis, jerk input).

    (reference: library/src/utils.cpp:694-777 smoothPath)
    """
    path = np.asarray(path_xy, dtype=np.float64)
    n = len(path)
    if n < 3:
        return path.copy()

    x_ref = np.zeros((n, 6))
    x_ref[:, 0] = path[:, 0]
    x_ref[:, 3] = path[:, 1]

    dir_start = path[1] - path[0]
    dir_start = dir_start / np.linalg.norm(dir_start) * ds
    x_ref[0, 1] = dir_start[0]
    x_ref[0, 4] = dir_start[1]
    if closed:
        x_ref[-1] = x_ref[0]

    A = np.eye(6)
    A[0, 1] = ds
    A[1, 2] = ds
    A[3, 4] = ds
    A[4, 5] = ds

    B = np.zeros((6, 2))
    B[2, 0] = ds
    B[5, 1] = ds

    Q = np.diag([1.0, w_v, w_a, 1.0, w_v, w_a])
    R = np.diag([w_j, w_j])

    Qs = np.broadcast_to(Q, (n, 6, 6)).copy()
    Rs = np.broadcast_to(R, (n, 2, 2)).copy()
    Qs[0] = np.eye(6) * 1.0e6
    Qs[-1] = np.eye(6) * 1.0e6

    xs, _ = lqr_smoother(x_ref[0], x_ref, A, B, Qs, Rs)
    return np.column_stack([xs[:, 0], xs[:, 3]])
