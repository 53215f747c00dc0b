"""
Trace a torch :class:`~tpl_tpu_torch.optim.ilqr.Problem` into sympy and
print it as a problem struct of the generic AL-iLQR kernel.

The JAX package solves any problem on its device: ``jax.jit`` traces the
problem's jnp functions into one XLA program (``tpl_tpu/optim/ilqr.py:126``
make_update_fn) and ``vmap`` takes it over a batch
(``tpl_tpu/optim/batched.py:30``).  The port's kernel for any problem is
``csrc/ilqr_generic_body.cuh``, instantiated for a problem struct in C++
over the forward-mode jet of ``csrc/ilqr_jet.cuh``; the sympy front end
prints one from a config's expressions (:func:`genopt.cuda_spec`).  This
module gives a plain torch problem the same: it runs the problem's
``dynamics``, ``cost``, ``constraints`` and ``end_cost`` once on symbolic
tensors (:class:`Sym`, an object array of sympy expressions with
``__torch_function__``) and hands the four lists of expressions to the
same printer.

The functions see the states ``x0..x{nx-1}`` and actions ``u0..u{nu-1}``
(``x[..., i]``, ``x.unbind(-1)``), the step index ``t`` and the step ``dt``
as symbols, each scalar param as a ``sympy.Symbol`` and each table param as
a :class:`~tpl_tpu_torch.optim.symext.ArraySymbol`.  What they may do
(:data:`OPERATIONS`), as ``jax.jit`` takes it in the JAX package:

- the arithmetic operators, the comparisons, ``&`` / ``|`` / ``~``,
  ``.detach()`` (``symext.fixed``: the value without its derivatives,
  printed as ``val``), ``.float()`` / ``.to(dtype)`` as the identity, the
  ``*_like`` constructors, ``where`` (a ``Piecewise``: the slope of the
  taken branch only), ``maximum`` / ``minimum`` (``Max`` / ``Min``: a tie
  splits the slope, as autograd does), ``clamp`` / ``clip`` /
  ``clamp_min`` / ``clamp_max`` (a ``Piecewise``: the slope passes at the
  bounds, as autograd's clamp does);
- the elementwise functions: ``abs`` (slope 0 at 0), ``sign``, ``neg``,
  ``reciprocal``, ``sqrt``, ``rsqrt``, ``square``, the trigonometric and
  hyperbolic functions, ``exp``, ``expm1``, ``log``, ``log1p``, ``erf``,
  ``sigmoid``, ``softplus`` (torch's ``beta`` and ``threshold``), ``relu``
  (slope 0 at 0), ``atan2`` and ``hypot``, each with autograd's slope at
  its kinks (the jet forms of ``csrc/ilqr_jet.cuh``);
- products over the small static shapes of a problem, formed as sums:
  ``@``, ``matmul``, ``mm``, ``mv``, ``dot``, ``outer``, ``einsum``;
- shape operations: ``stack``, ``cat``, ``broadcast_tensors``,
  ``unbind``, ``reshape``, ``view``, ``flatten``, ``unsqueeze``,
  ``squeeze``, ``transpose``, ``.T``, ``permute``, ``expand`` and indexing
  by Python ints, slices and index arrays;
- reductions over any dims: ``sum``, ``mean``, ``prod``, ``amax`` /
  ``amin`` and ``max`` / ``min`` without a dim (a tie shares the slope
  evenly, as autograd's), ``linalg.vector_norm`` / ``linalg.norm`` /
  ``norm`` (ord 2: slope 0 at 0, as autograd's; 1, inf, -inf and 0), and
  ``cumsum``;
- indexing by a traced value (``W[t]``, ``REF[t]``, ``x[i]``): as jnp
  reads it, a negative index counts from the end once and the index is
  clamped to the dim (a captured tensor or a table is read with
  ``symext.take``, a traced tensor through a ``Piecewise`` of its
  entries);
- the lookups of :mod:`tpl_tpu_torch.ops.interp` (overridable, so that the
  tracer sees them whole): ``lerp``, ``lerp_angle``, ``box_interp`` and
  ``blerp`` as their ``symext`` functions, ``lerp_multi`` as one
  ``symext.lerp`` a column, on a table param, ``torch.stack`` of table
  params along dim 1, a table param reshaped to 2-D (``blerp``) or a
  captured tensor.

A captured tensor or array (one the functions close over, as ``jax.jit``
folds a closed-over array into its program) of at most :data:`FOLD_MAX`
numbers, read by arithmetic, becomes sympy numbers; a larger one, or one
that a lookup or a traced index reads, becomes a constant table of the
struct (a ``symext.ConstArray``; its values go with the trace, and the
launcher uploads them once).  A table param is read only through a lookup
or an index.

The tracer refuses what ``jax.jit`` refuses, a Python branch or number read
off a traced value (``bool``, ``float``, ``int``, a traced value as a
Python index), and an operation outside that table, with
:class:`Untraceable` naming the problem's function and the operation.

Sympy rewrites as it builds: it orders the terms of a sum or product, folds
constants in exact arithmetic and cancels ``a - a`` to 0 (dropping a NaN
that the plain version keeps).  The printed struct therefore rounds in
another order than the plain version; the tests hold a float64 solve to
1e-12 of it.
"""

import dataclasses

import numpy as np
import sympy as sp
import torch

from tpl_tpu_torch.optim import genopt
from tpl_tpu_torch.optim import symext as spx
from tpl_tpu_torch.ops import interp


class Untraceable(NotImplementedError):
    """A problem the tracer refuses: the message names the problem's
    function and the operation."""


# A captured tensor of at most FOLD_MAX numbers that arithmetic reads is
# folded into the expressions: sympy then simplifies with its values (a
# weight matrix's zeros drop their terms, constant products fold) and the
# struct reads no memory for it.  A larger one becomes a constant table:
# folded, each number would be printed as a literal at every use, and the
# struct's text and nvcc's time grow with the tensor, while a table read is
# one cached load.  64 folds an 8 x 8 weight matrix.
FOLD_MAX = 64


class _Context:
    """The problem and the function being traced, for the refusals, and
    the constant tables of the captured tensors."""

    def __init__(self, problem):
        self.problem = problem
        self.function = None
        self.consts = []        # (name, float64 array) in the struct's order
        self._seen = {}         # (id(tensor), kind) -> (tensor, ConstArray)

    def refuse(self, what):
        raise Untraceable(f"{self.problem}.{self.function}: {what}")

    def constant(self, obj, arr, kind):
        """The constant table of the captured ``obj`` read as ``arr`` (one
        table for each object and kind: "flat", "2d", a column)."""
        key = (id(obj), kind)
        if key not in self._seen:
            sym = spx.ConstArray(f"const:{len(self.consts)}")
            self.consts.append((sym.name, np.array(arr, np.float64)))
            self._seen[key] = (obj, sym)
        return self._seen[key][1]


def _number(v):
    """A Python or numpy number as a sympy number (an integral float as an
    Integer, so that ``x ** 2.0`` prints as a product)."""
    if isinstance(v, (bool, np.bool_)):
        return sp.true if v else sp.false
    if isinstance(v, (int, np.integer)):
        return sp.Integer(int(v))
    v = float(v)
    if v == v and abs(v) < 2.0 ** 53 and v.is_integer():
        return sp.Integer(int(v))
    return sp.Float(v)


def _scalar_array(e):
    out = np.empty((), dtype=object)
    out[()] = e
    return out


def _array(v):
    """An indexing result as an object array (numpy returns an element of
    an object array itself)."""
    return v if isinstance(v, np.ndarray) else _scalar_array(v)


def _vector(items):
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


def _map(fn, *arrays):
    """``fn`` on the broadcast elements of object arrays."""
    arrays = np.broadcast_arrays(*arrays)
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(a[idx] for a in arrays))
    return out


def _is_bool(e):
    """Whether ``e`` is a truth value (a comparison, ``And``, ``true``); a
    sympy symbol is a Boolean too, but an Expr."""
    return isinstance(e, sp.logic.boolalg.Boolean) and not isinstance(
        e, sp.Expr)


def _as_number(e):
    """A comparison used as a number: 1 where it holds, else 0."""
    if _is_bool(e):
        return sp.Piecewise((sp.Integer(1), e), (sp.Integer(0), True))
    return e


def _fixed(e):
    """``symext.fixed`` of an expression, its tables left as they are."""
    return e.xreplace({s: sp.Symbol(spx.FIXED_PREFIX + s.name)
                       for s in e.free_symbols
                       if not isinstance(s, spx.ArraySymbol)
                       and not s.name.startswith(spx.FIXED_PREFIX)})


def _captured(v):
    return isinstance(v, (torch.Tensor, np.ndarray))


def _host(v):
    """A captured tensor or array as a numpy array of its values."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _clamped_index(i, n):
    """A traced index into a dim of ``n`` as jnp takes it: a negative one
    counts from the end once, then it is clamped to [0, n - 1]."""
    i = _as_number(i)
    return sp.Min(sp.Max(sp.Piecewise((i + n, i < 0), (i, True)), 0),
                  n - 1)


class Sym:
    """A traced tensor: an object array of sympy expressions, ``a``, with
    numpy's broadcasting and indexing.  Torch functions reach
    :data:`OPERATIONS` through ``__torch_function__``, the tensor methods
    through attribute access, the Python operators through the dunder
    methods set below the table."""

    __array_ufunc__ = None      # a numpy number on the left defers to Sym
    __hash__ = object.__hash__  # __eq__ is the elementwise comparison

    def __init__(self, ctx, a):
        self.ctx = ctx
        self.a = a

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        ctx = _context(args, kwargs)
        name = getattr(func, "__name__", repr(func))
        op = (_LOOKUPS.get(func) if func in _LOOKUPS
              else OPERATIONS.get(name))
        if op is None:
            ctx.refuse(f"the operation {name!r} (no form in the tracer)")
        return op(ctx, *args, **(kwargs or {}))

    @property
    def shape(self):
        return torch.Size(self.a.shape)

    @property
    def ndim(self):
        return self.a.ndim

    @property
    def T(self):
        return Sym(self.ctx, self.a.T)

    def dim(self):
        return self.a.ndim

    def size(self, dim=None):
        return self.shape if dim is None else self.a.shape[dim]

    def __len__(self):
        return len(self.a)

    def __getitem__(self, key):
        return _getitem(self.ctx, self, key)

    def __getattr__(self, name):
        if name.startswith("__") or name in ("ctx", "a"):
            raise AttributeError(name)
        op = OPERATIONS.get(name)
        if op is None:
            self.ctx.refuse(f"the tensor method {name!r} (no form in the "
                            "tracer)")
        return lambda *args, **kwargs: op(self.ctx, self, *args, **kwargs)

    # what a traced function cannot do, as jax.jit cannot
    def __bool__(self):
        self.ctx.refuse("a Python branch on a traced value (bool())")

    def __float__(self):
        self.ctx.refuse("a traced value read as a Python number (float())")

    def __index__(self):
        self.ctx.refuse("a traced value used as a Python index")

    __int__ = __float__

    def __repr__(self):
        return f"Sym({self.a!r})"


class _Table(Sym):
    """A table param, or ``torch.stack`` of tables along dim 1 (``matrix``:
    a column a table); read only through a lookup or an index."""

    def __init__(self, ctx, cols, matrix=False):
        super().__init__(ctx, None)
        self.cols = cols
        self.matrix = matrix

    @property
    def shape(self):
        self.ctx.refuse(f"the shape of the table {self._name()}")

    def __getitem__(self, key):
        """``table[i]``, ``i`` an int or a traced number: ``symext.take``
        (its length is the table's capacity, known at the launch)."""
        if self.matrix or isinstance(key, tuple) or not (
                isinstance(key, (int, np.integer))
                or (isinstance(key, Sym) and key.a.ndim == 0)):
            self.ctx.refuse(f"the table {self._name()} indexed by "
                            f"{key!r} (one int or traced number is taken)")
        i = _num(self.ctx, key)[()]
        return Sym(self.ctx, _scalar_array(spx.take(self.cols[0], i)))

    def _name(self):
        return ", ".join(c.name for c in self.cols)


class _Table2(Sym):
    """A table param read as ``rows`` x ``cols`` (its ``reshape``), for
    ``blerp``."""

    def __init__(self, ctx, sym, rows, cols):
        super().__init__(ctx, None)
        self.sym, self.rows, self.cols = sym, rows, cols

    def __getitem__(self, key):
        self.ctx.refuse(f"the table {self.sym.name} indexed after reshape")


def _context(args, kwargs):
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, Sym):
            return a.ctx
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, Sym):
                    return b.ctx
    raise TypeError("no traced value among the arguments")


def _values(ctx, v):
    """An argument as an object array of sympy expressions; a captured
    tensor of more than FOLD_MAX numbers is read from its constant
    table."""
    if isinstance(v, (_Table, _Table2)):
        ctx.refuse("a table outside a lookup or an index")
    if isinstance(v, Sym):
        return v.a
    if _captured(v):
        arr = _host(v)
        if arr.size <= FOLD_MAX:
            return _map(_number, np.asarray(arr, dtype=object))
        c = ctx.constant(v, arr.reshape(-1), "flat")
        return np.reshape(_vector([spx.take(c, sp.Integer(k))
                                   for k in range(arr.size)]), arr.shape)
    if isinstance(v, (bool, int, float, np.number, np.bool_)):
        return _scalar_array(_number(v))
    ctx.refuse(f"an argument of type {type(v).__name__}")


def _num(ctx, v):
    """:func:`_values` with a comparison taken as 1 or 0."""
    return _map(_as_number, _values(ctx, v))


def _static(ctx, k):
    if isinstance(k, torch.Tensor):
        return k.cpu().numpy()
    if isinstance(k, (list, tuple)) and any(isinstance(v, Sym) for v in k):
        ctx.refuse("a traced value used as a Python index (in a list)")
    return k


def _getitem(ctx, obj, key):
    """``obj[key]`` of a traced tensor or a captured one: numpy's indexing
    where the key is static, else (an int, slice or traced number a dim)
    each traced index clamped as jnp clamps it, a captured tensor read from
    its constant table, a traced one through a Piecewise of its entries."""
    keys = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, Sym) for k in keys):
        return Sym(ctx, _array(_values(ctx, obj)[tuple(
            _static(ctx, k) for k in keys)]))
    if any(isinstance(k, Sym) and any(_is_bool(v) for v in k.a.reshape(-1))
           for k in keys):
        ctx.refuse("indexing by a boolean mask of a traced value (its "
                   "shape depends on the values)")
    captured = _captured(obj)
    shape = _host(obj).shape if captured else obj.a.shape
    if len(keys) > len(shape) or not all(
            isinstance(k, (int, np.integer, slice))
            or (isinstance(k, Sym) and k.a.ndim == 0) for k in keys):
        ctx.refuse(f"indexing by {key!r} (with a traced index, one int, "
                   "slice or traced number a dim is taken)")
    keys = keys + (slice(None),) * (len(shape) - len(keys))
    picks = []      # a dim: one index expression, or the list of a slice
    for k, n in zip(keys, shape):
        if isinstance(k, Sym):
            picks.append(_clamped_index(k.a[()], n))
        elif isinstance(k, slice):
            picks.append([sp.Integer(i) for i in range(*k.indices(n))])
        else:
            if not -n <= int(k) < n:
                ctx.refuse(f"the index {k} of a dim of {n}")
            picks.append(sp.Integer(int(k) % n))
    out_shape = tuple(len(p) for p in picks if isinstance(p, list))
    out = np.empty(out_shape, dtype=object)
    if captured:
        arr = _host(obj)
        table = ctx.constant(obj, arr.reshape(-1), "flat")
        strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
    for idx in np.ndindex(out_shape):
        it = iter(idx)
        at = [p[next(it)] if isinstance(p, list) else p for p in picks]
        if captured:
            out[idx] = spx.take(table, sp.Add(*(a * s for a, s in
                                                zip(at, strides))))
        else:
            out[idx] = _select(obj.a, at)
    return Sym(ctx, _array(out))


def _select(a, at):
    """The entry of object array ``a`` at the index expressions ``at``: a
    Piecewise over a traced index's values (clamped: the last one takes
    the rest)."""
    d = next((i for i, e in enumerate(at) if not e.is_Integer), None)
    if d is None:
        return a[tuple(int(e) for e in at)]
    n = a.shape[d]
    pieces = [(_select(a, at[:d] + [sp.Integer(j)] + at[d + 1:]),
               at[d] <= j) for j in range(n - 1)]
    return sp.Piecewise(*pieces, (_select(a, at[:d] + [sp.Integer(n - 1)]
                                          + at[d + 1:]), True))


def _dim(a, dim):
    return dim % a.ndim if a.ndim else 0


# ---------------------------------------------------------------------
# the operations

def _unary(fn):
    def op(ctx, a, *rest, **kwargs):
        if rest or kwargs:
            ctx.refuse("a function with more arguments (out, dim)")
        return Sym(ctx, _map(fn, _num(ctx, a)))
    return op


def _binary(fn):
    def op(ctx, a, b, *rest, **kwargs):
        if rest or kwargs:
            ctx.refuse("an operation with more arguments (alpha, out)")
        return Sym(ctx, _map(fn, _num(ctx, a), _num(ctx, b)))
    return op


_add = _binary(lambda a, b: a + b)
_sub = _binary(lambda a, b: a - b)
_mul = _binary(lambda a, b: a * b)
_div = _binary(lambda a, b: a / b)
_pow = _binary(lambda a, b: a ** b)


def _logic(fn):
    def op(ctx, *args):
        def both(*es):
            if not all(_is_bool(e) for e in es):
                ctx.refuse("&, | or ~ of a value that is no comparison")
            return fn(*es)
        return Sym(ctx, _map(both, *(_values(ctx, a) for a in args)))
    return op


def _where(ctx, cond, a, b):
    return Sym(ctx, _map(lambda c, x, y: sp.Piecewise((x, c), (y, True)),
                         _values(ctx, cond), _num(ctx, a), _num(ctx, b)))


def _clamp(ctx, a, min=None, max=None):
    """torch.clamp: the bound where the value lies beyond it, else the value
    (its slope passes at the bounds, as autograd's does; a NaN passes)."""
    lo = _scalar_array(None) if min is None else _num(ctx, min)
    hi = _scalar_array(None) if max is None else _num(ctx, max)

    def clamp(v, l, h):
        pieces = ([] if l is None else [(l, v < l)]) + (
            [] if h is None else [(h, v > h)])
        return sp.Piecewise(*pieces, (v, True))
    return Sym(ctx, _map(clamp, _num(ctx, a), lo, hi))


def _relu(ctx, a, inplace=False):
    return Sym(ctx, _map(spx.relu, _num(ctx, a)))


def _softplus(ctx, a, beta=1.0, threshold=20.0):
    b, th = _number(beta), _number(threshold)
    return Sym(ctx, _map(lambda e: spx.softplus(e, b, th), _num(ctx, a)))


def _seq(ctx, tensors):
    return [_num(ctx, t) for t in tensors]


def _stack(ctx, tensors, dim=0):
    tensors = list(tensors)
    if any(isinstance(t, _Table) for t in tensors):
        if not all(isinstance(t, _Table) and not t.matrix for t in tensors):
            ctx.refuse("torch.stack of tables and values")
        if dim not in (1, -1):
            ctx.refuse("torch.stack of tables along a dim other than 1 (a "
                       "lookup takes a column a table)")
        return _Table(ctx, [t.cols[0] for t in tensors], matrix=True)
    arrays = np.broadcast_arrays(*_seq(ctx, tensors))
    return Sym(ctx, np.stack(arrays, axis=dim))


def _cat(ctx, tensors, dim=0):
    arrays = _seq(ctx, tensors)
    return Sym(ctx, np.concatenate([np.atleast_1d(a) for a in arrays],
                                   axis=dim))


def _broadcast(ctx, *tensors):
    return tuple(Sym(ctx, a.copy()) for a in
                 np.broadcast_arrays(*_seq(ctx, tensors)))


def _filled(value):
    def op(ctx, a, *rest, **kwargs):
        v = _number(value if value is not None else rest[0])
        return Sym(ctx, _map(lambda _: v, _values(ctx, a)))
    return op


def _unbind(ctx, a, dim=0):
    x = _values(ctx, a)
    if x.ndim == 0:
        ctx.refuse("unbind of a 0-d traced value")
    d = _dim(x, dim)
    return tuple(Sym(ctx, _array(np.take(x, i, axis=d)))
                 for i in range(x.shape[d]))


def _same(ctx, a, *args, **kwargs):
    """``.float()``, ``.double()``, ``.to(dtype)``: the value (a comparison
    taken as 1 or 0)."""
    return Sym(ctx, _num(ctx, a))


def _detach(ctx, a):
    return Sym(ctx, _map(_fixed, _num(ctx, a)))


# products, formed as sums over the static shapes

def _matmul(ctx, a, b):
    x, y = _num(ctx, a), _num(ctx, b)
    if x.ndim == 0 or y.ndim == 0:
        ctx.refuse("a matrix product of a 0-d value")
    return Sym(ctx, _array(np.matmul(x, y)))


def _dot(ctx, a, b):
    x, y = _num(ctx, a), _num(ctx, b)
    if x.ndim != 1 or y.ndim != 1:
        ctx.refuse("dot of values that are not 1-D")
    return Sym(ctx, _scalar_array(sp.Add(*(x * y))))


def _outer(ctx, a, b):
    return Sym(ctx, np.multiply.outer(_num(ctx, a), _num(ctx, b)))


def _einsum(ctx, equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = operands[0]
    return Sym(ctx, _array(np.einsum(equation,
                                     *(_num(ctx, o) for o in operands))))


# shape operations

def _shape_arg(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        return tuple(shape[0])
    return tuple(shape)


def _reshape(ctx, a, *shape):
    shape = _shape_arg(shape)
    if isinstance(a, _Table):
        if a.matrix or len(shape) != 2 or min(shape) < 1:
            ctx.refuse(f"the table {a._name()} reshaped to {shape} (one "
                       "table as rows x cols is taken, for blerp)")
        return _Table2(ctx, a.cols[0], int(shape[0]), int(shape[1]))
    return Sym(ctx, _num(ctx, a).reshape(shape))


def _flatten(ctx, a, start_dim=0, end_dim=-1):
    x = _num(ctx, a)
    if x.ndim == 0:
        return Sym(ctx, x.reshape(1))
    s, e = start_dim % x.ndim, end_dim % x.ndim
    return Sym(ctx, x.reshape(x.shape[:s] + (-1,) + x.shape[e + 1:]))


def _unsqueeze(ctx, a, dim):
    return Sym(ctx, np.expand_dims(_num(ctx, a), dim))


def _squeeze(ctx, a, dim=None):
    x = _num(ctx, a)
    if dim is None:
        return Sym(ctx, _array(np.squeeze(x)))
    dims = tuple(d % max(x.ndim, 1) for d in np.atleast_1d(dim))
    return Sym(ctx, _array(np.squeeze(x, tuple(
        d for d in dims if x.ndim and x.shape[d] == 1))))


def _transpose(ctx, a, dim0, dim1):
    return Sym(ctx, np.swapaxes(_num(ctx, a), dim0, dim1))


def _permute(ctx, a, *dims):
    return Sym(ctx, np.transpose(_num(ctx, a), _shape_arg(dims)))


def _expand(ctx, a, *sizes):
    x = _num(ctx, a)
    sizes = _shape_arg(sizes)
    lead = len(sizes) - x.ndim
    shape = tuple(x.shape[i - lead] if s == -1 else s
                  for i, s in enumerate(sizes))
    return Sym(ctx, np.broadcast_to(x, shape).copy())


# reductions

def _reduction(fn):
    """A reduction of the elements along ``dim`` (all where None) by
    ``fn(list of elements)``."""
    def op(ctx, a, dim=None, keepdim=False, dtype=None, out=None):
        x = _num(ctx, a)
        if dim is None or (isinstance(dim, (tuple, list)) and not dim):
            dims = tuple(range(x.ndim))
        else:
            dims = tuple(sorted({_dim(x, d) for d in np.atleast_1d(dim)}))
        rest = [d for d in range(x.ndim) if d not in dims]
        moved = np.transpose(x, rest + list(dims)) if x.ndim else x
        lead = moved.shape[:len(rest)]
        flat = moved.reshape(lead + (-1,))
        res = np.empty(lead, dtype=object)
        for idx in np.ndindex(lead):
            res[idx] = fn(list(flat[idx]))
        if keepdim:
            res = res.reshape(tuple(1 if d in dims else x.shape[d]
                                    for d in range(x.ndim)))
        return Sym(ctx, _array(res))
    return op


def _extremum(f):
    return lambda els: els[0] if len(els) == 1 else f(*els)


_amax = _reduction(_extremum(spx.amax))
_amin = _reduction(_extremum(spx.amin))


def _vector_norm(ord):
    """The p-norm of the elements for ``ord`` 2, 1, inf, -inf or 0."""
    if ord == 2:
        return lambda els: spx.norm2(*els)
    if ord == 1:
        return lambda els: sp.Add(*(sp.Abs(e) for e in els))
    if ord in (np.inf, -np.inf):
        pick = _extremum(spx.amax if ord > 0 else spx.amin)
        return lambda els: pick([sp.Abs(e) for e in els])
    if ord == 0:
        return lambda els: sp.Add(*(sp.Piecewise(
            (sp.Integer(1), sp.Ne(e, 0)), (sp.Integer(0), True))
            for e in els))
    return None


def _norm(ctx, a, ord=2, dim=None, keepdim=False, dtype=None, out=None,
          p=None):
    """linalg.vector_norm, linalg.norm (ord None: 2) and torch.norm /
    Tensor.norm (``p``, "fro": 2)."""
    if p is not None:
        ord = p
    if ord is None or ord == "fro":
        ord = 2
    fn = _vector_norm(ord) if not isinstance(ord, str) else None
    if fn is None:
        ctx.refuse(f"the norm of order {ord!r} (2, 1, inf, -inf and 0 are "
                   "taken)")
    return _reduction(fn)(ctx, a, dim, keepdim)


def _norm_method(ctx, a, p="fro", dim=None, keepdim=False, dtype=None,
                 out=None):
    return _norm(ctx, a, dim=dim, keepdim=keepdim, p=p)


def _max_or_min(reduce, pair):
    """torch.max / min: of all elements, or of two tensors; a dim (values
    and indices) is refused."""
    def op(ctx, a, other=None, *rest, **kwargs):
        if isinstance(other, (Sym, torch.Tensor, np.ndarray)):
            return pair(ctx, a, other)
        if other is not None or rest or kwargs:
            ctx.refuse("max / min along a dim (values and indices)")
        return reduce(ctx, a)
    return op


def _cumsum(ctx, a, dim, dtype=None, out=None):
    x = _num(ctx, a)
    d = _dim(x, dim)
    out_ = np.empty(x.shape, dtype=object)
    for idx in np.ndindex(x.shape):
        pre = list(idx)
        pre[d] = slice(0, idx[d] + 1)
        out_[idx] = sp.Add(*x[tuple(pre)].reshape(-1))
    return Sym(ctx, out_)


# the lookups of ops/interp.py

def _table_arg(ctx, v, what):
    """A lookup's 1-D table: a table param or a captured 1-D tensor."""
    if isinstance(v, _Table) and not v.matrix:
        return v.cols[0]
    if _captured(v) and _host(v).ndim == 1:
        return ctx.constant(v, _host(v), "flat")
    ctx.refuse(f"{what} of a value that is not one table")


def _lookup(fn):
    """A lookup of ops/interp.py as its symext function, the table last."""
    def op(ctx, *args):
        *queries, table = args
        col = _table_arg(ctx, table, fn.__name__)
        return Sym(ctx, _map(lambda *q: fn(*q, col),
                             *(_num(ctx, q) for q in queries)))
    return op


def _lerp_multi(ctx, x0, dx, x, mat):
    if isinstance(mat, _Table) and mat.matrix:
        cols = mat.cols
    elif _captured(mat) and _host(mat).ndim == 2:
        arr = _host(mat)
        cols = [ctx.constant(mat, arr[:, j], ("col", j))
                for j in range(arr.shape[1])]
    else:
        ctx.refuse("lerp_multi of a value that is not torch.stack of tables "
                   "along dim 1 or a captured 2-D tensor")
    q = [_num(ctx, v) for v in (x0, dx, x)]
    out = [_map(lambda *e, c=c: spx.lerp(*e, c), *q) for c in cols]
    return Sym(ctx, np.stack(out, axis=-1))


def _blerp(ctx, x0, y0, dx, dy, x, y, arr):
    if isinstance(arr, _Table2):
        tab = spx.table2(arr.sym, arr.rows, arr.cols)
    elif _captured(arr) and _host(arr).ndim == 2:
        tab = ctx.constant(arr, _host(arr), "2d")
    else:
        ctx.refuse("blerp of a value that is not a 2-D table (a captured "
                   "2-D tensor or a table param reshaped)")
    q = [_num(ctx, v) for v in (x0, y0, dx, dy, x, y)]
    return Sym(ctx, _map(lambda *e: spx.blerp(*e, tab), *q))


_LOOKUPS = {
    interp.lerp: _lookup(spx.lerp),
    interp.lerp_angle: _lookup(spx.lerp_angle),
    interp.box_interp: _lookup(spx.box_interp),
    interp.lerp_multi: _lerp_multi,
    interp.blerp: _blerp,
}

_SYMPY_UNARY = {
    "sin": sp.sin, "cos": sp.cos, "tan": sp.tan, "asin": sp.asin,
    "acos": sp.acos, "atan": sp.atan, "sinh": sp.sinh, "cosh": sp.cosh,
    "tanh": sp.tanh, "exp": sp.exp, "log": sp.log, "abs": sp.Abs,
    "sign": sp.sign, "sqrt": sp.sqrt, "square": lambda e: e ** 2,
    "neg": lambda e: -e, "negative": lambda e: -e,
    "reciprocal": lambda e: 1 / e, "rsqrt": lambda e: e ** sp.Rational(-1, 2),
    "erf": sp.erf, "special_erf": sp.erf, "sigmoid": spx.sigmoid,
    "special_expit": spx.sigmoid, "log1p": spx.log1p, "expm1": spx.expm1,
}
_RELATIONS = {"gt": sp.StrictGreaterThan, "ge": sp.GreaterThan,
              "lt": sp.StrictLessThan, "le": sp.LessThan, "eq": sp.Eq,
              "ne": sp.Ne}

_sum = _reduction(lambda els: sp.Add(*els))

# what a traced function may call, by the torch function's (or tensor
# method's) name; a tensor on the left of an operator reaches it as "add",
# "gt", "__and__"...
OPERATIONS = {
    **{n: _unary(f) for n, f in _SYMPY_UNARY.items()},
    **{n: _binary(r) for n, r in _RELATIONS.items()},
    "atan2": _binary(sp.atan2), "hypot": _binary(spx.hypot),
    "relu": _relu, "softplus": _softplus,
    "add": _add, "sub": _sub, "mul": _mul, "div": _div, "pow": _pow,
    "__and__": _logic(sp.And), "__or__": _logic(sp.Or),
    "where": _where, "maximum": _binary(sp.Max),
    "minimum": _binary(sp.Min), "clamp": _clamp, "clip": _clamp,
    "clamp_min": lambda ctx, a, m: _clamp(ctx, a, min=m),
    "clamp_max": lambda ctx, a, m: _clamp(ctx, a, max=m),
    "stack": _stack, "cat": _cat, "broadcast_tensors": _broadcast,
    "ones_like": _filled(1), "zeros_like": _filled(0),
    "full_like": _filled(None), "unbind": _unbind,
    "detach": _detach, "float": _same, "double": _same, "to": _same,
    "__getitem__": _getitem,
    # products
    "matmul": _matmul, "__matmul__": _matmul, "mm": _matmul, "mv": _matmul,
    "dot": _dot, "outer": _outer, "einsum": _einsum,
    # shape operations
    "reshape": _reshape, "view": _reshape, "flatten": _flatten,
    "unsqueeze": _unsqueeze, "squeeze": _squeeze, "transpose": _transpose,
    "permute": _permute, "expand": _expand,
    # reductions
    "sum": _sum, "mean": _reduction(lambda els: sp.Add(*els) / len(els)),
    "prod": _reduction(lambda els: sp.Mul(*els)),
    "amax": _amax, "amin": _amin,
    "max": _max_or_min(_amax, _binary(sp.Max)),
    "min": _max_or_min(_amin, _binary(sp.Min)),
    "linalg_vector_norm": _norm, "linalg_norm": _norm,
    "norm": _norm_method, "cumsum": _cumsum,
}


def _operator(op, swap=False):
    if swap:
        return lambda self, other: op(self.ctx, other, self)
    return lambda self, *other: op(self.ctx, self, *other)


for _name, _op in (("add", _add), ("sub", _sub), ("mul", _mul),
                   ("truediv", _div), ("pow", _pow), ("matmul", _matmul)):
    setattr(Sym, f"__{_name}__", _operator(_op))
    setattr(Sym, f"__r{_name}__", _operator(_op, swap=True))
for _name in _RELATIONS:
    setattr(Sym, f"__{_name}__", _operator(OPERATIONS[_name]))
Sym.__and__ = Sym.__rand__ = _operator(OPERATIONS["__and__"])
Sym.__or__ = Sym.__ror__ = _operator(OPERATIONS["__or__"])
Sym.__invert__ = _operator(_logic(sp.Not))
Sym.__neg__ = _operator(_unary(lambda e: -e))
Sym.__abs__ = _operator(OPERATIONS["abs"])


# ---------------------------------------------------------------------
# the trace

class _Params(dict):
    def __init__(self, ctx, values):
        super().__init__(values)
        self.ctx = ctx

    def __missing__(self, name):
        self.ctx.refuse(f"the param {name!r}, which the solver's params do "
                        "not hold")


@dataclasses.dataclass(frozen=True)
class Traced:
    """A problem's four lists of sympy expressions (what
    :func:`genopt.make_problem` hands to :func:`genopt.cuda_spec`), over
    its state, action and param symbols, and its constant tables ((name,
    array) pairs of the captured tensors they read)."""

    states: list
    actions: list
    params: list
    dynamics: list
    cost: list
    constraints: list
    end_cost: list
    constants: list = ()


def _run(ctx, function, fn, args, shape):
    """The expressions of one traced function, checked against ``shape``."""
    ctx.function = function
    try:
        out = fn(*args)
    except Untraceable:
        raise
    except Exception as e:      # the plain functions' own errors, named
        raise Untraceable(f"{ctx.problem}.{function}: {type(e).__name__}: "
                          f"{e}") from e
    if isinstance(out, (list, tuple)):
        out = OPERATIONS["stack"](ctx, out, -1) if out else Sym(
            ctx, np.empty((0,), dtype=object))
    values = _num(ctx, out)
    if values.shape != shape:
        ctx.refuse(f"returns shape {values.shape}, the problem's sizes "
                   f"want {shape}")
    return list(values.reshape(-1))


def trace(problem, kinds):
    """The :class:`Traced` expressions of ``problem``; ``kinds`` is the
    params' ``(name, is_table)`` pairs in the struct's order.  Raises
    :class:`Untraceable`."""
    ctx = _Context(problem.name)
    states = [sp.Symbol(f"x{i}") for i in range(problem.nx)]
    actions = [sp.Symbol(f"u{i}") for i in range(problem.nu)]
    taken = {s.name for s in states + actions} | {"t", "dt"}
    params, syms = {}, []
    for name, is_table in kinds:
        if name in taken or name.startswith(spx.FIXED_PREFIX):
            raise Untraceable(f"{problem.name}: the param {name!r} collides "
                              "with a state, action, t or dt symbol")
        if is_table:
            sym = spx.ArraySymbol(name)
            params[name] = _Table(ctx, [sym])
        else:
            sym = sp.Symbol(name)
            params[name] = Sym(ctx, _scalar_array(sym))
        syms.append(sym)
    p = _Params(ctx, params)
    x = Sym(ctx, _vector(states))
    u = Sym(ctx, _vector(actions))
    t = Sym(ctx, _scalar_array(sp.Symbol("t")))
    dt = Sym(ctx, _scalar_array(sp.Symbol("dt")))
    nx, nc = problem.nx, problem.nc
    dyn = _run(ctx, "dynamics", problem.dynamics, (x, u, t, dt, p), (nx,))
    cost = _run(ctx, "cost", problem.cost, (x, u, t, dt, p), ())
    cons = (_run(ctx, "constraints", problem.constraints, (x, u, t, dt, p),
                 (nc,)) if problem.constraints is not None and nc > 0
            else [])
    end = (_run(ctx, "end_cost", problem.end_cost, (x, t, dt, p), ())
           if problem.end_cost is not None else [sp.Integer(0)])
    return Traced(states, actions, syms, dyn, cost, cons, end, ctx.consts)


def kinds_of_spec(param_spec):
    """The ``(name, is_table)`` pairs of a solver's param spec (an
    :class:`~tpl_tpu_torch.optim.problems.ArraySpec` is a table)."""
    return tuple((n, hasattr(s, "capacity")) for n, s in param_spec.items())


def kinds_of_params(params, per_instance=()):
    """The ``(name, is_table)`` pairs of a batch's params: a 0-d value, or
    a ``(B,)`` one named in ``per_instance``, is a scalar; one of 1-D or
    more a table."""
    return tuple((n, n not in per_instance and np.ndim(v) >= 1)
                 for n, v in params.items())


def spec(problem, kinds):
    """The generic kernel's :class:`~tpl_tpu_torch.optim.ilqr_generic.Spec`
    of a traced problem (its printed struct, op counts and dependent chain),
    cached on the problem by ``kinds``; raises :class:`Untraceable` for a
    problem the tracer or the printer refuses."""
    kinds = tuple((n, bool(t)) for n, t in kinds)
    cache = problem.__dict__.get("_traced")
    if cache is None:
        cache = {}
        object.__setattr__(problem, "_traced", cache)
    if kinds not in cache:
        try:
            tr = trace(problem, kinds)
            cache[kinds] = genopt.cuda_spec(
                problem.name, tr.states, tr.actions, problem, tr.dynamics,
                tr.cost, tr.constraints, tr.end_cost, tr.params,
                tr.constants)
        except Untraceable as e:
            cache[kinds] = e
        except genopt.Unprintable as e:
            cache[kinds] = Untraceable(f"{problem.name}.{e.args[0]} (no "
                                       "form in the CUDA printer)")
    out = cache[kinds]
    if isinstance(out, Exception):
        raise out
    return out
