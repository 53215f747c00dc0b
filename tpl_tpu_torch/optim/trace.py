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
(:data:`OPERATIONS`): the arithmetic operators, the comparisons, ``&`` /
``|`` / ``~``, ``.detach()`` (``symext.fixed``: the value without its
derivatives, printed as ``val``), ``.float()`` / ``.to(dtype)`` as the
identity, ``stack``, ``cat``, ``broadcast_tensors``, the ``*_like``
constructors, ``where`` (a ``Piecewise``: the slope of the taken branch
only), ``maximum`` / ``minimum`` (``Max`` / ``Min``: a tie splits the
slope, as autograd does), ``clamp`` / ``clip`` (a ``Piecewise``: the slope
passes at the bounds, as autograd's clamp does), ``abs`` (slope 0 at 0),
``sign``, ``sqrt``, ``square``, the trigonometric and hyperbolic functions,
``exp``, ``log``, ``atan2`` and ``sum``, and the lookups of
:mod:`tpl_tpu_torch.ops.interp` (overridable, so that the tracer sees them
whole): ``lerp``, ``lerp_angle`` and ``box_interp`` as their ``symext``
functions, ``lerp_multi`` over ``torch.stack`` of tables as one
``symext.lerp`` a column (``blerp``, which no problem of the repo uses, has
no form in the printer and is refused).  A table is read only through a
lookup.

The tracer refuses, with :class:`Untraceable` naming the problem's function
and the operation: an operation outside that table, a Python branch or
number read off a traced value (``bool``, ``float``: as ``jax.jit``
refuses one), and a captured tensor or array that is not one number after
indexing.

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


class _Context:
    """The problem and the function being traced, for the refusals."""

    def __init__(self, problem):
        self.problem = problem
        self.function = None

    def refuse(self, what):
        raise Untraceable(f"{self.problem}.{self.function}: {what}")


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

    def dim(self):
        return self.a.ndim

    def __getitem__(self, key):
        return Sym(self.ctx, _array(self.a[_index(self.ctx, key)]))

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
        self.ctx.refuse("a traced value used as an index")

    __int__ = __float__

    def __repr__(self):
        return f"Sym({self.a!r})"


class _Table(Sym):
    """A table param, or ``torch.stack`` of tables along dim 1 (``matrix``:
    a column a table); read only through a lookup."""

    def __init__(self, ctx, cols, matrix=False):
        super().__init__(ctx, None)
        self.cols = cols
        self.matrix = matrix

    @property
    def shape(self):
        self.ctx.refuse(f"the shape of the table {self._name()}")

    def __getitem__(self, key):
        self.ctx.refuse(f"the table {self._name()} indexed (a table is "
                        "read only through a lookup)")

    def _name(self):
        return ", ".join(c.name for c in self.cols)


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
    """An argument as an object array of sympy expressions."""
    if isinstance(v, _Table):
        ctx.refuse(f"the table {v._name()} outside a lookup")
    if isinstance(v, Sym):
        return v.a
    if isinstance(v, (torch.Tensor, np.ndarray)):
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        if arr.size != 1:
            ctx.refuse(f"a captured {type(v).__name__} of shape "
                       f"{tuple(arr.shape)}: only one number after "
                       "indexing is taken")
        return _map(_number, np.asarray(arr, dtype=object))
    if isinstance(v, (bool, int, float, np.number, np.bool_)):
        return _scalar_array(_number(v))
    ctx.refuse(f"an argument of type {type(v).__name__}")


def _num(ctx, v):
    """:func:`_values` with a comparison taken as 1 or 0."""
    return _map(_as_number, _values(ctx, v))


def _index(ctx, key):
    keys = key if isinstance(key, tuple) else (key,)
    out = []
    for k in keys:
        if isinstance(k, Sym):
            ctx.refuse("indexing by a traced value")
        if isinstance(k, torch.Tensor):
            k = k.cpu().numpy()
        out.append(k)
    return tuple(out)


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


def _sum(ctx, a, dim=None):
    x = _num(ctx, a)
    if dim is None:
        out = _scalar_array(sp.Add(*x.reshape(-1)) if x.size else
                            sp.Integer(0))
        return Sym(ctx, out)
    d = _dim(x, dim)
    parts = [_array(np.take(x, i, axis=d)) for i in range(x.shape[d])]
    out = parts[0]
    for p in parts[1:]:
        out = _map(lambda u, v: u + v, out, p)
    return Sym(ctx, out)


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


def _lookup(fn):
    """A lookup of ops/interp.py as its symext function, the table last."""
    def op(ctx, *args):
        *queries, table = args
        if not isinstance(table, _Table) or table.matrix:
            ctx.refuse(f"{fn.__name__} of a value that is not one table")
        col = table.cols[0]
        return Sym(ctx, _map(lambda *q: fn(*q, col),
                             *(_num(ctx, q) for q in queries)))
    return op


def _lerp_multi(ctx, x0, dx, x, mat):
    if not (isinstance(mat, _Table) and mat.matrix):
        ctx.refuse("lerp_multi of a value that is not torch.stack of tables "
                   "along dim 1")
    q = [_num(ctx, v) for v in (x0, dx, x)]
    cols = [_map(lambda *e, c=c: spx.lerp(*e, c), *q) for c in mat.cols]
    return Sym(ctx, np.stack(cols, axis=-1))


_LOOKUPS = {
    interp.lerp: _lookup(spx.lerp),
    interp.lerp_angle: _lookup(spx.lerp_angle),
    interp.box_interp: _lookup(spx.box_interp),
    interp.lerp_multi: _lerp_multi,
}

_SYMPY_UNARY = {
    "sin": sp.sin, "cos": sp.cos, "tan": sp.tan, "asin": sp.asin,
    "acos": sp.acos, "atan": sp.atan, "sinh": sp.sinh, "cosh": sp.cosh,
    "tanh": sp.tanh, "exp": sp.exp, "log": sp.log, "abs": sp.Abs,
    "sign": sp.sign, "sqrt": sp.sqrt, "square": lambda e: e ** 2,
}
_RELATIONS = {"gt": sp.StrictGreaterThan, "ge": sp.GreaterThan,
              "lt": sp.StrictLessThan, "le": sp.LessThan, "eq": sp.Eq,
              "ne": sp.Ne}

# what a traced function may call, by the torch function's (or tensor
# method's) name; a tensor on the left of an operator reaches it as "add",
# "gt", "__and__"...
OPERATIONS = {
    **{n: _unary(f) for n, f in _SYMPY_UNARY.items()},
    **{n: _binary(r) for n, r in _RELATIONS.items()},
    "atan2": _binary(sp.atan2),
    "add": _add, "sub": _sub, "mul": _mul, "div": _div, "pow": _pow,
    "__and__": _logic(sp.And), "__or__": _logic(sp.Or),
    "where": _where, "maximum": _binary(sp.Max),
    "minimum": _binary(sp.Min), "clamp": _clamp, "clip": _clamp,
    "stack": _stack, "cat": _cat, "broadcast_tensors": _broadcast,
    "ones_like": _filled(1), "zeros_like": _filled(0),
    "full_like": _filled(None), "sum": _sum, "unbind": _unbind,
    "detach": _detach, "float": _same, "double": _same, "to": _same,
    "__getitem__": lambda ctx, *a: ctx.refuse(
        "indexing a captured tensor by a traced value"),
}


def _operator(op, swap=False):
    if swap:
        return lambda self, other: op(self.ctx, other, self)
    return lambda self, *other: op(self.ctx, self, *other)


for _name, _op in (("add", _add), ("sub", _sub), ("mul", _mul),
                   ("truediv", _div), ("pow", _pow)):
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
    its state, action and param symbols."""

    states: list
    actions: list
    params: list
    dynamics: list
    cost: list
    constraints: list
    end_cost: list


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
    return Traced(states, actions, syms, dyn, cost, cons, end)


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
                tr.cost, tr.constraints, tr.end_cost, tr.params)
        except Untraceable as e:
            cache[kinds] = e
        except genopt.Unprintable as e:
            cache[kinds] = Untraceable(f"{problem.name}.{e.args[0]} (no "
                                       "form in the CUDA printer)")
    out = cache[kinds]
    if isinstance(out, Exception):
        raise out
    return out
