"""
Hermite boundary-value polynomials (cubic/quintic/septic) and the
free-end-position quartic used for longitudinal connections.

Batched coefficient solves: the coefficients come from one constant
matrix-vector product, so a whole grid of candidate polynomials (the
lateral sampling of the poly-lat planner) is one matrix product.
(reference: library/include/tplcpp/poly_interp.cuh:7-112,
library/src/poly_interp.cu)

Works with numpy and torch inputs alike.  The constant inverse matrices are
float64 and promote the coefficients to float64, as numpy does; a torch
evaluation promotes its query to the coefficients' dtype first, so that a
0-d coefficient promotes a float32 query as numpy would (torch keeps the
dtype of a dimensioned tensor over a 0-d one of the same kind).
"""

import numpy as np
import torch


def _is_torch(*arrays):
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _hermite_matrix(order):
    """Constraint matrix for monomial coefficients on u in [0, 1].

    Rows: derivatives 0..(order-1)/2 at u=0, then at u=1.
    """
    n = order + 1
    nd = n // 2
    m = np.zeros((n, n))
    for d in range(nd):
        # d-th derivative of u^k: k!/(k-d)! * u^(k-d)
        for k in range(d, n):
            fac = np.prod(np.arange(k - d + 1, k + 1), dtype=np.float64)
            if k == d:
                m[d, k] = fac          # at u=0 only k==d survives
            m[nd + d, k] = fac         # at u=1 all survive
    return m


_HERMITE_INV = {o: np.linalg.inv(_hermite_matrix(o)) for o in (3, 5, 7)}


def _as(v, like):
    """``v`` as a tensor: tensors stay as they are, Python / numpy scalars
    take the dtype and device of the tensor ``like`` (a scalar argument
    does not set the dtype)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _first_tensor(arrays):
    return next(a for a in arrays if isinstance(a, torch.Tensor))


def _solve(b, inv):
    """``b @ inv.T`` with the float64 constant ``inv``, promoting ``b``."""
    if isinstance(b, torch.Tensor):
        dt = torch.promote_types(b.dtype, torch.float64)
        return b.to(dt) @ torch.as_tensor(inv.T, dtype=dt, device=b.device)
    return b @ inv.T


def _horner(c, u, deriv, top):
    """The ``deriv``-th u-derivative of the monomial series ``c`` (degree
    ``top``), by Horner's rule."""
    if isinstance(u, torch.Tensor) or isinstance(c, torch.Tensor):
        if not isinstance(u, torch.Tensor):
            u = torch.as_tensor(u, dtype=c.dtype, device=c.device)
        u = u.to(torch.promote_types(u.dtype, c.dtype))
    acc = 0.0
    for k in range(top, deriv - 1, -1):
        fac = float(np.prod(np.arange(k - deriv + 1, k + 1),
                            dtype=np.float64))
        acc = acc * u + c[..., k] * fac
    return acc


def _pow(d, k):
    """``d ** k`` as repeated products (the rounding of ``jnp`` integer
    powers: d * (d * d) for a cube)."""
    if k == 0:
        return 1.0
    if k == 1:
        return d
    if k == 2:
        return d * d
    return d * _pow(d, k - 1)


class _HermitePoly:
    """Polynomial on [x0, x1] built from boundary derivatives.

    Stored in normalized coordinates u = (x - x0) / d with monomial
    coefficients ``c`` (shape (..., order+1)); derivative k in x is the
    u-derivative scaled by d^-k. Broadcasts over leading batch dims.
    """

    ORDER = None

    def __init__(self, x0, x1, c, d):
        self.x0 = x0
        self.x1 = x1
        self.c = c
        self.d = d

    def _init_from_bc(self, x0, x1, bc0, bc1):
        """bc0/bc1: lists of derivative values (value, d1, d2, ...) at ends."""
        vals = (x0, x1, *bc0, *bc1)
        if _is_torch(*vals):
            like = _first_tensor(vals)
            x0, x1 = _as(x0, like), _as(x1, like)
            bc0 = [_as(v, like) for v in bc0]
            bc1 = [_as(v, like) for v in bc1]
            stack = torch.stack
            shape = torch.broadcast_shapes(*(v.shape for v in (x0, x1, *bc0,
                                                               *bc1)))
            bc = [v.expand(shape) for v in (*bc0, *bc1)]
            bc0, bc1 = bc[:len(bc0)], bc[len(bc0):]
        else:
            x0, x1 = np.asarray(x0), np.asarray(x1)
            bc0 = [np.asarray(v) for v in bc0]
            bc1 = [np.asarray(v) for v in bc1]
            stack = np.stack
        d = x1 - x0
        # scale derivative k by d^k to move to normalized coordinates
        rows = [v * _pow(d, k) for k, v in enumerate(bc0)]
        rows += [v * _pow(d, k) for k, v in enumerate(bc1)]
        b = stack(rows, -1)                              # (..., order+1)
        c = _solve(b, _HERMITE_INV[self.ORDER])          # (..., order+1)
        _HermitePoly.__init__(self, x0, x1, c, d)

    def _u(self, x):
        return (x - self.x0) / self.d

    def _eval(self, x, deriv):
        acc = _horner(self.c, self._u(x), deriv, self.ORDER)
        return acc / _pow(self.d, deriv)

    def f(self, x):
        return self._eval(x, 0)

    def df(self, x):
        return self._eval(x, 1)

    def ddf(self, x):
        return self._eval(x, 2)

    def dddf(self, x):
        return self._eval(x, 3)

    def df0to2(self, x):
        return self.f(x), self.df(x), self.ddf(x)

    def i1(self, x, ic0):
        """First antiderivative with integration constant ic0 at x0."""
        u = self._u(x)
        n = self.ORDER + 1
        acc = 0.0
        for k in range(n - 1, -1, -1):
            acc = acc * u + self.c[..., k] / (k + 1)
        return ic0 + acc * u * self.d

    def i2(self, x, ic0, ic1):
        """Second antiderivative; ic0 integrates into i1, ic1 offsets i2."""
        u = self._u(x)
        n = self.ORDER + 1
        acc = 0.0
        for k in range(n - 1, -1, -1):
            acc = acc * u + self.c[..., k] / ((k + 1) * (k + 2))
        return ic1 + ic0 * (x - self.x0) + acc * u * u * self.d * self.d


class PolyCubic(_HermitePoly):
    """Cubic Hermite: (x0, y0, dy0) -> (x1, y1, dy1).
    (reference: poly_interp.cuh:7-32)"""

    ORDER = 3

    def __init__(self, x0, y0, dy0, x1, y1, dy1):
        self._init_from_bc(x0, x1, (y0, dy0), (y1, dy1))


class PolyQuintic(_HermitePoly):
    """Quintic Hermite: position/velocity/acceleration at both ends.
    (reference: poly_interp.cuh:34-61)"""

    ORDER = 5

    def __init__(self, x0, y0, dy0, ddy0, x1, y1, dy1, ddy1):
        self._init_from_bc(x0, x1, (y0, dy0, ddy0), (y1, dy1, ddy1))


class PolySeptic(_HermitePoly):
    """Septic Hermite: up to jerk at both ends. (poly_interp.cuh:63-89)"""

    ORDER = 7

    def __init__(self, x0, y0, dy0, ddy0, dddy0, x1, y1, dy1, ddy1, dddy1):
        self._init_from_bc(x0, x1, (y0, dy0, ddy0, dddy0),
                           (y1, dy1, ddy1, dddy1))


# free-end-position quartic: 5 constraints
# f(0)=s, f'(0)=v, f''(0)=a, f'(T)=ve, f''(T)=ae  on normalized u in [0,1]
_M4 = np.zeros((5, 5))
_M4[0, 0] = 1.0                      # f(0)
_M4[1, 1] = 1.0                      # f'(0)
_M4[2, 2] = 2.0                      # f''(0)
for _k in range(1, 5):               # f'(1)
    _M4[3, _k] = _k
for _k in range(2, 5):               # f''(1)
    _M4[4, _k] = _k * (_k - 1)
_M4_INV = np.linalg.inv(_M4)


class PolyQuartic:
    """Quartic with free end position for longitudinal connections.

    Matches the reference constructor signature
    ``PolyQuartic(ts, ss, vs, as, te, ve, ae)`` (poly_interp.cuh:91-112):
    start state fixed (pos, vel, acc), end constrains only (vel, acc).
    """

    def __init__(self, ts, ss, vs, acs, te, ve, ae):
        vals = (ts, ss, vs, acs, te, ve, ae)
        if _is_torch(*vals):
            like = _first_tensor(vals)
            ts, ss, vs, acs, te, ve, ae = (_as(v, like) for v in vals)
            shape = torch.broadcast_shapes(*(v.shape for v in (
                ts, ss, vs, acs, te, ve, ae)))
            stack = torch.stack
        else:
            ts, ss, vs, acs, te, ve, ae = (np.asarray(v) for v in vals)
            shape = np.broadcast_shapes(*(np.shape(v) for v in (
                ts, ss, vs, acs, te, ve, ae)))
            stack = np.stack
        self.x0 = ts
        d = te - self.x0
        self.d = d
        rows = [ss, vs * d, acs * d * d, ve * d, ae * d * d]
        if _is_torch(*rows):
            rows = [r.expand(shape) for r in rows]
        b = stack(rows, -1)
        self.c = _solve(b, _M4_INV)

    def _eval(self, x, deriv):
        u = (x - self.x0) / self.d
        acc = _horner(self.c, u, deriv, 4)
        return acc / _pow(self.d, deriv)

    def f(self, x):
        return self._eval(x, 0)

    def df(self, x):
        return self._eval(x, 1)

    def ddf(self, x):
        return self._eval(x, 2)

    def dddf(self, x):
        return self._eval(x, 3)
