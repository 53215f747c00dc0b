"""
Symbolic extensions for the genopt-compatible sympy frontend.

The port's own copy of ``tpl_tpu/optim/symext.py`` (it imports only sympy;
the port keeps its own so that it never imports the JAX package).  It
mirrors the reference's ``tpl.optim.symext`` surface
(reference: library/tpl/optim/symext.py:13-157): an opaque
:class:`ArraySymbol`, the interpolation functions ``lerp`` /
``lerp_angle`` / ``box_interp`` / ``blerp`` / ``lerp_wrap`` /
``get_array_value``, and ``fixed()`` / ``unfixed()`` to freeze
subexpressions during differentiation.

Here the functions are not C-codegen hooks: :mod:`tpl_tpu_torch.optim.genopt`
translates them to the torch interpolation lookups in
:mod:`tpl_tpu_torch.ops.interp`, and ``fixed_<name>`` symbols become
``<name>.detach()`` — which reproduces the reference's behavior of
excluding the frozen symbol from the generated derivatives while
evaluating it with the live value.
"""

import copy

import sympy as sp
from sympy.core import cache


class ArraySymbol(sp.Symbol):
    """An opaque 1-D (or N-D for blerp) double array parameter.

    Sympy treats it as a plain scalar symbol; the genopt translation layer
    recognizes the type and binds a fixed-capacity array parameter instead.
    """


def _opaque(name, n_args):
    """Create a sympy Function subclass with a fixed arity.

    The function stays unevaluated in sympy; genopt maps it onto the
    matching lookup from :mod:`tpl_tpu_torch.ops.interp`.
    """
    return type(name, (sp.Function,), {"nargs": (n_args,)})


# arguments follow the reference solver-template helpers
# (reference: library/tpl/optim/templates/optim.c:297-491)
lerp = _opaque("lerp", 4)             # (x0, dx, x, arr)
lerp_angle = _opaque("lerp_angle", 4)  # (x0, dx, x, arr)
box_interp = _opaque("box_interp", 3)  # (dx, x, arr)
blerp = _opaque("blerp", 7)           # (x0, y0, dx, dy, x, y, arr)
lerp_wrap = _opaque("lerp_wrap", 5)   # (len, dx, x, xs, arr)
get_array_value = _opaque("get_array_value", 2)  # (arr, i)


# The port's own functions, beyond the reference's surface: the forms the
# tracer (tpl_tpu_torch/optim/trace.py) gives a torch problem's operations,
# which the CUDA printer (genopt.py) prints as the jet forms of
# csrc/ilqr_jet.cuh.
sigmoid = _opaque("sigmoid", 1)       # torch.sigmoid
softplus = _opaque("softplus", 3)     # (x, beta, threshold): F.softplus
relu = _opaque("relu", 1)             # torch.relu
log1p = _opaque("log1p", 1)
expm1 = _opaque("expm1", 1)
hypot = _opaque("hypot", 2)
# the reductions of any number of values: torch.amax / amin (a tie shares
# the slope evenly) and the 2-norm torch.linalg.vector_norm (slope 0 at 0)
amax = type("amax", (sp.Function,), {})
amin = type("amin", (sp.Function,), {})
norm2 = type("norm2", (sp.Function,), {})
take = _opaque("take", 2)             # (arr, i): arr[i] as jnp reads it
# (arr, rows, cols): the table arr read as rows x cols, row-major, the 2-D
# table of blerp (a config's, or a traced table param's reshape)
table2 = _opaque("table2", 3)


class ConstArray(ArraySymbol):
    """A captured tensor of a traced problem, as a constant table of the
    struct (its values and layout live beside the trace, by name)."""


FIXED_PREFIX = "fixed_"


def fixed(expr):
    """Freeze all free symbols of ``expr`` for differentiation.

    Every free symbol ``s`` is replaced by a symbol named
    ``fixed_<s>``; the translation layer evaluates it as ``s.detach()``,
    so the value tracks the live variable while all solver derivatives
    treat it as a constant.
    """
    expr = sp.sympify(expr)
    for s in list(expr.free_symbols):
        if not s.name.startswith(FIXED_PREFIX):
            expr = expr.subs(s, sp.Symbol(FIXED_PREFIX + s.name))
    return expr


def unfixed(expr):
    """Inverse of :func:`fixed`: strip the ``fixed_`` prefix again."""
    expr = sp.sympify(expr)
    for s in list(expr.free_symbols):
        if s.name.startswith(FIXED_PREFIX):
            expr = expr.subs(s, sp.Symbol(s.name[len(FIXED_PREFIX):]))
    return expr


def clear_cache():
    cache.clear_cache()


def clone(expr):
    """Deep-copy symbols/expressions (clears the sympy cache first,
    which otherwise aliases copied symbols)."""
    clear_cache()
    return copy.deepcopy(expr)
