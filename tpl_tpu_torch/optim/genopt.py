"""
genopt-compatible sympy frontend for the torch iLQR solver core.

The port of ``tpl_tpu/optim/genopt.py``.  The reference's genopt takes a
problem described with sympy expressions, differentiates it symbolically,
and generates a C extension solver (reference:
library/tpl/optim/genopt.py:428-449,650-665).  This module keeps the same
public surface — :class:`Config`, :func:`build`, :func:`build_parallel` —
but instead of codegen it *translates* the sympy problem into plain torch
functions for :class:`tpl_tpu_torch.optim.ilqr.Problem`:

- sympy expressions are lambdified with the torch printer, so the solver
  derivatives come from batched autograd on the translated functions
  (:func:`tpl_tpu_torch.optim.ilqr.derivatives`; no symbolic jacobians or
  hessians, no C compiler, no build cache),
- the translated functions broadcast over leading dimensions of ``x``,
  ``u`` and ``t`` like the port's native problems (``x[..., i]``, results
  stacked on the last dimension), and every result is promoted to a tensor
  of the state's dtype and device: the printer leaves a constant
  expression a Python number and prints ``Max`` / ``Min`` as
  ``torch.max`` / ``torch.min``, which take no Python number, so
  ``max`` / ``min`` / ``atan2`` go through promoting stand-ins,
- :class:`tpl_tpu_torch.optim.symext.ArraySymbol` parameters become
  fixed-capacity array params (edge-padded, preserving the reference's
  clamped variable-length lerp semantics),
- the opaque interpolation functions (``spx.lerp`` etc.) map onto the
  lookups in :mod:`tpl_tpu_torch.ops.interp` (sympy's torch printer
  refuses a function it has no mapping for, so a subclass prints them by
  name, as the JAX printer does),
- ``spx.fixed()`` symbols (``fixed_<name>``) evaluate as
  ``<name>.detach()`` — the frozen value tracks the live variable while
  every derivative treats it as constant, exactly the reference's
  differentiation-time freeze,
- constraint handling (augmented-Lagrangian terms, multiplier updates)
  lives in the iLQR core, so ``Config.constraints`` are passed through
  untransformed (feasible iff <= 0, the reference's convention from
  genopt.py:73-90).

``build(config)`` returns a zero-argument factory producing a
:class:`tpl_tpu_torch.optim.solver.Solver` with the config's parameter
defaults applied — the same call shape as the reference
(``opt = genopt.build(cfg)()``).  The solver runs on
``tpl_tpu_torch.device()`` (the card) unless a device is given.

On the card a config solves in one kernel launch an update, as the JAX
package's solve is one XLA program: the CUDA printer (:func:`cuda_struct`)
prints the config's sympy expressions, after ``sp.cse``, as a problem
struct in C++ over the forward-mode jet of ``csrc/ilqr_jet.cuh``, and the
generic AL-iLQR body (``csrc/ilqr_generic_body.cuh``) is instantiated for
it.  The source lands in ``build/tpl_tpu_torch/`` and ``nvcc`` builds it at
its first solve on a CUDA device (``build_parallel`` on a CUDA device
builds its configs' sources at once, in parallel), cached by the hash of
its text, the headers and the flags; a build or launch that fails raises.
A config with a function outside the printer's table (``CUDA_FUNCTIONS``)
warns once at ``build``: it solves with the plain iLQR on the CPU and
raises on a CUDA device.  The same printer prints a torch ``Problem``'s
functions traced by :mod:`.trace`.  The struct carries no name a native kernel
matches: a translated problem never takes a hand-written kernel of the
native problems, whatever its name.  On a CPU device the plain iLQR
solves.

Inside expressions, the symbol ``t`` is the step index and ``dt`` the
integration step, matching the generated solvers' routine signatures
(reference: optim.c:1091-1105 passes the loop index as ``t``).
"""

import dataclasses
import multiprocessing.dummy as mp_dummy
import warnings

import numpy as np
import sympy as sp
import torch
from sympy.printing.codeprinter import CodePrinter
from sympy.printing.pytorch import TorchPrinter

from tpl_tpu_torch.optim import ilqr_generic
from tpl_tpu_torch.optim import symext as spx
from tpl_tpu_torch.optim.ilqr import Problem
from tpl_tpu_torch.optim.problems import ArraySpec
from tpl_tpu_torch.optim import solver
from tpl_tpu_torch.ops import interp


class Config:
    """Problem description, field-compatible with the reference Config
    (reference: genopt.py:428-449). ``use_cache``/``output_dir`` are
    accepted for drop-in compatibility and ignored (there is no build
    step to cache)."""

    def __init__(self,
                 states,
                 actions,
                 params,
                 dynamics,
                 costs,
                 end_costs=0.0,
                 constraints=(),
                 use_cache=True,
                 output_dir=None,
                 name=None,
                 horizon_max=300,
                 array_capacity=512):
        self.states = list(states)
        self.actions = list(actions)
        self.params = params
        self.dynamics = dynamics
        self.costs = costs
        self.end_costs = end_costs
        self.constraints = list(constraints)
        self.use_cache = use_cache
        self.output_dir = output_dir
        self.name = name or "genopt_problem"
        self.horizon_max = horizon_max
        self.array_capacity = array_capacity


def _like(v, ref):
    """``v`` as a tensor of ``ref``'s dtype and device (a Python number or
    a tensor of another dtype, such as an integer step index)."""
    if isinstance(v, torch.Tensor):
        return v if v.dtype == ref.dtype else v.to(ref.dtype)
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _promote(*args):
    """The arguments as tensors of the first tensor argument's dtype and
    device."""
    ref = next(a for a in args if isinstance(a, torch.Tensor))
    if not ref.is_floating_point():
        ref = ref.to(torch.get_default_dtype())
    return [_like(a, ref) for a in args]


def _maximum(*args):
    """sympy ``Max`` (the printer nests it pairwise): elementwise, NaN
    propagating as ``jnp.maximum``."""
    args = _promote(*args)
    out = args[0]
    for a in args[1:]:
        out = torch.maximum(out, a)
    return out


def _minimum(*args):
    args = _promote(*args)
    out = args[0]
    for a in args[1:]:
        out = torch.minimum(out, a)
    return out


def _atan2(y, x):
    return torch.atan2(*_promote(y, x))


def _lerp_wrap(length, dx, x, xs, arr):
    """Periodic linear interpolation over a table whose first sample sits
    at ``xs[0]`` and that wraps with period ``length``
    (reference: optim.c:410-455)."""
    x = torch.as_tensor(x)
    n = arr.shape[0]
    first = xs[0]
    last = first + (n - 1) * dx
    gap = _like(length - (last - first), x)

    x = torch.remainder(x - first, length) + first

    q = (x - first) / dx
    lo = torch.clamp(torch.floor(q).long(), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    alpha_in = q - lo
    v_in = (1.0 - alpha_in) * arr[lo] + alpha_in * arr[hi]

    alpha_gap = torch.where(
        gap > 0, (x - last) / torch.where(gap > 0, gap, 1.0), 0.0)
    v_gap = (1.0 - alpha_gap) * arr[n - 1] + alpha_gap * arr[0]

    return torch.where((x >= last) & (gap > 0), v_gap, v_in)


def _get_array_value(arr, i):
    idx = torch.clamp(torch.as_tensor(i, device=arr.device).long(), 0,
                      arr.shape[0] - 1)
    return arr[idx]




_FN_MODULE = {
    "lerp": interp.lerp,
    "lerp_angle": interp.lerp_angle,
    "box_interp": interp.box_interp,
    "blerp": interp.blerp,
    "lerp_wrap": _lerp_wrap,
    "get_array_value": _get_array_value,
    # a table read as rows x cols, the 2-D table of blerp
    "table2": lambda arr, rows, cols: arr[:rows * cols].reshape(rows, cols),
    # the torch printer's names for Max / Min / atan2
    "max": _maximum,
    "min": _minimum,
    "atan2": _atan2,
}


class _Printer(TorchPrinter):
    """sympy's torch printer, printing a function it has no mapping for
    (the opaque lookups of :mod:`.symext`) by name as the other printers
    do, instead of refusing it."""

    def _print_Function(self, expr):
        if type(expr) in self.mapping:
            return super()._print_Function(expr)
        return CodePrinter._print_Function(self, expr)


def _printer():
    return _Printer({"fully_qualified_modules": False, "inline": True,
                     "allow_unknown_functions": True,
                     "user_functions": {k: k for k in _FN_MODULE}})


def _as_expr_list(obj):
    if isinstance(obj, sp.MatrixBase):
        return list(obj)
    if isinstance(obj, (list, tuple)):
        return [sp.sympify(e) for e in obj]
    return [sp.sympify(obj)]


def _param_symbols(params):
    if isinstance(params, dict):
        return list(params.keys())
    return list(params)


def _param_defaults(params):
    if isinstance(params, dict):
        return {s.name: v for s, v in params.items() if v is not None}
    return {}


def _lead(x, u, t):
    """The leading (broadcast) shape of one evaluation."""
    shapes = [x.shape[:-1]]
    if u is not None:
        shapes.append(u.shape[:-1])
    if isinstance(t, torch.Tensor):
        shapes.append(t.shape)
    return torch.broadcast_shapes(*shapes)


def _terms(values, x, lead):
    """Each translated value as a tensor of ``x``'s dtype and device,
    broadcast to ``lead``."""
    return [torch.broadcast_to(_like(v, x), lead) for v in values]


class _Translator:
    """Lambdifies config expressions into (x, u, t, dt, p) torch
    functions."""

    def __init__(self, config):
        self.states = config.states
        self.actions = config.actions
        self.param_syms = _param_symbols(config.params)

        names = [s.name for s in self.states + self.actions + self.param_syms]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate symbol names: {sorted(dupes)}")
        reserved = {"t", "dt"} & set(names)
        if reserved:
            raise ValueError(f"symbols named {sorted(reserved)} collide with "
                             "the step-index/step-size arguments")

        self.known = set(names) | {"t", "dt"}

    def lambdify(self, exprs, with_actions=True, label=""):
        """Translate a list of expressions into
        ``f(x, u, t, dt, p) -> list`` (``u`` ignored if not with_actions)."""
        exprs = [sp.sympify(e) for e in exprs]

        free = set()
        for e in exprs:
            free |= e.free_symbols

        fixed_names = []
        for s in free:
            if s.name.startswith(spx.FIXED_PREFIX):
                base = s.name[len(spx.FIXED_PREFIX):]
                if base not in self.known:
                    raise ValueError(
                        f"{label}: fixed symbol {s.name!r} has no matching "
                        f"state/action/param {base!r}")
                fixed_names.append(s.name)
            elif s.name not in self.known:
                raise ValueError(
                    f"{label}: unknown free symbol {s.name!r} (not a "
                    "state, action, param, or t/dt)")

        arg_syms = (self.states + self.actions
                    + [sp.Symbol("t"), sp.Symbol("dt")]
                    + self.param_syms
                    + [sp.Symbol(n) for n in sorted(fixed_names)])
        fn = sp.lambdify(arg_syms, exprs, modules=[_FN_MODULE, "torch"],
                         printer=_printer())

        states = self.states
        actions = self.actions
        param_syms = self.param_syms
        fixed_sorted = sorted(fixed_names)

        def call(x, u, t, dt, p):
            env = {s.name: x[..., i] for i, s in enumerate(states)}
            if with_actions:
                env.update({s.name: u[..., i] for i, s in enumerate(actions)})
            else:
                env.update({s.name: torch.zeros_like(x[..., 0])
                            for s in actions})
            env["t"] = t
            env["dt"] = dt
            for s in param_syms:
                env[s.name] = p[s.name]
            args = [env[s.name] for s in states + actions]
            args += [t, dt]
            args += [env[s.name] for s in param_syms]
            args += [torch.as_tensor(env[n[len(spx.FIXED_PREFIX):]]).detach()
                     for n in fixed_sorted]
            return fn(*args)

        return call


# ---------------------------------------------------------------------
# the CUDA printer: a config's problem struct for the generic kernel

class Unprintable(Exception):
    """An expression the CUDA printer has no form for; its argument names
    the function."""


# sympy functions -> their jet forms in csrc/ilqr_jet.cuh
_CUDA_FUNCS = {
    sp.sin: "j_sin", sp.cos: "j_cos", sp.tan: "j_tan", sp.asin: "j_asin",
    sp.acos: "j_acos", sp.atan: "j_atan", sp.sinh: "j_sinh",
    sp.cosh: "j_cosh", sp.tanh: "j_tanh", sp.exp: "j_exp", sp.log: "j_log",
    sp.Abs: "j_abs", sp.sign: "j_sign", sp.atan2: "j_atan2",
    sp.erf: "j_erf", spx.sigmoid: "j_sigmoid", spx.softplus: "j_softplus",
    spx.relu: "j_relu", spx.log1p: "j_log1p", spx.expm1: "j_expm1",
    spx.hypot: "j_hypot",
}
# the reductions of any number of values, each argument lifted to the
# function's scalar type S
_CUDA_VARIADIC = {spx.amax: "j_amax", spx.amin: "j_amin",
                  spx.norm2: "j_norm2"}
# the lookups of symext -> (jet form, positions of their table arguments);
# blerp's table is 2-D
_CUDA_LOOKUPS = {
    spx.lerp: ("j_lerp", (3,)), spx.lerp_angle: ("j_lerp_angle", (3,)),
    spx.box_interp: ("j_box_interp", (2,)),
    spx.lerp_wrap: ("j_lerp_wrap", (3, 4)),
    spx.get_array_value: ("j_get_array_value", (0,)),
    spx.take: ("j_take", (0,)),
    spx.blerp: ("j_blerp", (6,)),
}
_TABLES_2D = {spx.blerp: (6,)}
# the printer's functions that a config of the reference's surface cannot
# write for the JAX package's genopt: the port's own symext functions (the
# tracer's forms), blerp, whose table is 2-D (a traced problem's captured
# tensor, or symext.table2 of a table) where a config's tables are 1-D, and
# erf, which the JAX package's genopt evaluates with math.erf, outside jit
PORT_FUNCTIONS = ("amax", "amin", "blerp", "erf", "expm1", "hypot", "log1p",
                  "norm2", "relu", "sigmoid", "softplus", "take")
# what the printer takes, by name (the table of the printer's functions)
CUDA_FUNCTIONS = tuple(sorted(
    [f.__name__ for f in _CUDA_FUNCS] + [f.__name__ for f in _CUDA_LOOKUPS]
    + [f.__name__ for f in _CUDA_VARIADIC]
    + ["Max", "Min", "Piecewise", "Pow", "sqrt"]))

_RELATIONS = {sp.StrictLessThan: "<", sp.LessThan: "<=",
              sp.StrictGreaterThan: ">", sp.GreaterThan: ">=",
              sp.Equality: "==", sp.Unequality: "!="}


def _real(v):
    """A C++ literal of the real type R for a Python float."""
    return f"R({float(v)!r})"


class _CudaPrinter:
    """Prints sympy expressions as C++ over csrc/ilqr_jet.cuh: ``env`` maps a
    symbol's name to its C++ form, ``tables`` an ArraySymbol's name to its
    table index, ``consts`` a ConstArray's name to its (offset, shape) in
    the constant tables."""

    def __init__(self, env, tables, consts=None):
        self.env = env
        self.tables = tables
        self.consts = consts or {}

    def _table(self, f, a, two_d):
        """A lookup's table argument: a table param (``P.table``), one read
        as 2-D (``table2``, ``P.table2``) or a constant table (``P.ctab``,
        ``P.ctab2``)."""
        if isinstance(a, spx.ConstArray):
            off, shape = self.consts[a.name]
            if two_d and len(shape) == 2:
                return f"P.ctab2({off}, {shape[0]}, {shape[1]})"
            if not two_d and len(shape) == 1:
                return f"P.ctab({off}, {shape[0]})"
        elif isinstance(a, spx.ArraySymbol) and not two_d:
            return f"P.table({self.tables[a.name]})"
        elif (two_d and isinstance(a, spx.table2)
              and isinstance(a.args[0], spx.ArraySymbol)):
            return (f"P.table2({self.tables[a.args[0].name]}, "
                    f"{int(a.args[1])}, {int(a.args[2])})")
        raise Unprintable(f"{f.__name__} of a table that is not "
                          f"{'2-D' if two_d else 'one array'}")

    def __call__(self, e):
        if isinstance(e, sp.Symbol):
            if isinstance(e, spx.ArraySymbol):
                raise Unprintable(f"the array {e.name} outside a lookup")
            if e.name.startswith(spx.FIXED_PREFIX):
                return f"val({self.env[e.name[len(spx.FIXED_PREFIX):]]})"
            return self.env[e.name]
        if isinstance(e, sp.Rational) and not isinstance(e, sp.Integer):
            return f"R({float(e.p)!r} / {float(e.q)!r})"
        if isinstance(e, (sp.Number, sp.NumberSymbol)):
            return _real(e)
        if e is sp.true:
            return "true"
        if e is sp.false:
            return "false"
        if isinstance(e, sp.Add):
            return "(" + " + ".join(self(a) for a in e.as_ordered_terms()) \
                + ")"
        if isinstance(e, sp.Mul):
            return self._mul(e)
        if isinstance(e, sp.Pow):
            return self._pow(e.base, e.exp)
        if isinstance(e, (sp.Max, sp.Min)):
            name = "j_max" if isinstance(e, sp.Max) else "j_min"
            args = [self(a) for a in e.args]
            out = args[0]
            for a in args[1:]:
                out = f"{name}({out}, {a})"
            return out
        if isinstance(e, sp.Piecewise):
            out = None
            for expr, cond in reversed(e.args):
                if out is None:
                    out = self(expr)
                    if cond is not sp.true:
                        out = f"j_select({self(cond)}, {out}, R(NAN))"
                    continue
                out = f"j_select({self(cond)}, {self(expr)}, {out})"
            return out
        if type(e) in _RELATIONS:
            return (f"(val({self(e.lhs)}) {_RELATIONS[type(e)]} "
                    f"val({self(e.rhs)}))")
        if isinstance(e, sp.And):
            return "(" + " && ".join(self(a) for a in e.args) + ")"
        if isinstance(e, sp.Or):
            return "(" + " || ".join(self(a) for a in e.args) + ")"
        if isinstance(e, sp.Not):
            return f"(!{self(e.args[0])})"
        if isinstance(e, sp.ITE):   # sympy's form of a Piecewise compared
            c, a, b = (self(a) for a in e.args)
            return f"({c} ? {a} : {b})"
        if type(e) in _CUDA_FUNCS:
            return f"{_CUDA_FUNCS[type(e)]}(" + ", ".join(
                self(a) for a in e.args) + ")"
        if type(e) in _CUDA_VARIADIC:
            return f"{_CUDA_VARIADIC[type(e)]}(" + ", ".join(
                f"S({self(a)})" for a in e.args) + ")"
        if type(e) in _CUDA_LOOKUPS:
            name, tabs = _CUDA_LOOKUPS[type(e)]
            two_d = _TABLES_2D.get(type(e), ())
            args = [self._table(type(e), a, i in two_d) if i in tabs
                    else self(a) for i, a in enumerate(e.args)]
            return f"{name}(" + ", ".join(args) + ")"
        if isinstance(e, sp.Function):
            raise Unprintable(type(e).__name__)
        raise Unprintable(type(e).__name__)

    def _mul(self, e):
        coeff, factors = e.as_coeff_mul()
        num, den = [], []
        for f in factors:
            if (isinstance(f, sp.Pow) and f.exp.is_Integer and f.exp < 0):
                den.append(self(f.base) if f.exp == -1
                           else self._pow(f.base, -f.exp))
            else:
                num.append(self(f))
        if coeff == -1:
            head = "-"
        elif coeff != 1:
            num.insert(0, self(coeff))
            head = ""
        else:
            head = ""
        out = " * ".join(num) if num else "R(1.0)"
        if den:
            out = f"({out}) / ({' * '.join(den)})"
        return f"({head}{out})"

    def _pow(self, base, exp):
        if base is sp.E:
            return f"j_exp({self(exp)})"
        if exp.is_Integer:
            return f"j_ipow({self(base)}, {int(exp)})"
        if exp == sp.Rational(1, 2):
            return f"j_sqrt({self(base)})"
        if exp == sp.Rational(-1, 2):
            return f"(R(1.0) / j_sqrt({self(base)}))"
        if exp.is_Number:
            return f"j_pow({self(base)}, {self(exp)})"
        return f"j_pow({self(base)}, {self(exp)})"


# an operation's weight when the longest path through the dynamics is
# chosen (its count goes to the probe of its name)
_CHAIN_WEIGHT = {"add": 1, "mul": 1, "div": 4, "sin": 8, "cos": 8,
                 "atan": 8, "smem_load": 6}
_CHAIN_FUNC = {sp.sin: "sin", sp.cos: "cos", sp.atan: "atan",
               sp.atan2: "atan", sp.tan: "tan"}


def _chain(e):
    """(weight, ops) of the heaviest dependent path through ``e``."""
    if not e.args or isinstance(e, spx.ArraySymbol):
        return 0, {}
    sub = max((_chain(a) for a in e.args), key=lambda c: c[0])
    ops = dict(sub[1])
    add = {}
    if isinstance(e, sp.Add):
        add = {"add": len(e.args) - 1}
    elif isinstance(e, sp.Mul):
        add = {"mul": len(e.args) - 1}
    elif isinstance(e, sp.Pow):
        add = {"div": 1} if e.exp.is_negative else {"mul": 1}
    elif type(e) in _CUDA_LOOKUPS:
        add = {"div": 1, "add": 2, "mul": 1, "smem_load": 1}
    elif isinstance(e, sp.Function):
        add = {_CHAIN_FUNC.get(type(e), "sin"): 1}
    for k, v in add.items():
        ops[k] = ops.get(k, 0) + v
    return sub[0] + sum(_CHAIN_WEIGHT.get(k, 8) * v
                        for k, v in add.items()), ops


def _count_ops(exprs):
    """Operations of evaluating ``exprs`` once, a lookup counted as its 6."""
    n = 0
    for e in exprs:
        n += int(sp.count_ops(e))
        n += 5 * sum(1 for f in sp.preorder_traversal(e)
                     if type(f) in _CUDA_LOOKUPS)
    return n


def _c_name(name):
    return "".join(c if c.isalnum() else "_" for c in name)


def cuda_struct(name, states, actions, dyn, cost, cons, end, scalars, tables,
                consts=None):
    """The problem struct (C++ over csrc/ilqr_jet.cuh) of a problem's four
    lists of sympy expressions over its ``states`` and ``actions`` symbols,
    and its name: sympy's common subexpressions of each function as
    ``auto`` temporaries, a scalar param read from the scalar table, an
    ArraySymbol as a table of ``array_capacity``, a ConstArray as a
    constant table at the (offset, shape) ``consts`` gives it,
    ``fixed_<name>`` as ``val(<name>)``, ``t`` / ``dt`` the step index and
    the step.  Raises :class:`Unprintable` naming the function and what the
    printer has no form for."""
    struct = f"Gen_{_c_name(name)}"
    env = {"dt": "P.dt", "t": "R(t)"}
    env.update({n: f"P.s[{i}]" for i, n in enumerate(scalars)})
    tabs = {n: i for i, n in enumerate(tables)}

    def body(label, exprs, assign, with_actions):
        e2 = dict(env)
        e2.update({s.name: f"x[{i}]" for i, s in enumerate(states)})
        e2.update({a.name: (f"u[{i}]" if with_actions else "R(0.0)")
                   for i, a in enumerate(actions)})
        reps, red = sp.cse(exprs, symbols=sp.numbered_symbols("cse_"))
        lines = []
        pr = _CudaPrinter(e2, tabs, consts)
        try:
            for sym, val in reps:
                lines.append(f"    const auto {sym.name} = {pr(val)};")
                e2[sym.name] = sym.name
            lines += assign([pr(r) for r in red])
        except Unprintable as e:
            raise Unprintable(f"{label}: {e.args[0]}") from e
        return "\n".join(lines)

    sig = "const Prm<R>& P, int t, const S* x"
    dyn_body = body("dynamics", dyn, lambda r: [f"    f[{i}] = S({v});"
                                                for i, v in enumerate(r)],
                    True)
    cost_body = body("cost", cost, lambda r: ["    S c = S(" + r[0] + ");"]
                     + [f"    c = c + S({v});" for v in r[1:]]
                     + ["    return c;"], True)
    cons_body = (body("constraints", cons,
                      lambda r: [f"    g[{i}] = S({v});"
                                 for i, v in enumerate(r)], True)
                 if cons else "")
    end_cost = not all(e.is_zero for e in end)
    end_body = (body("end_cost", end,
                     lambda r: ["    S c = S(" + r[0] + ");"]
                     + [f"    c = c + S({v});" for v in r[1:]]
                     + ["    return c;"], False)
                if end_cost else "    return S(R(0.0));")
    text = f"""namespace ilqr_generic {{

// {name}: printed by tpl_tpu_torch/optim/genopt.py
template <typename R>
struct {struct} {{
  static constexpr int NX = {len(states)}, NU = {len(actions)}, NC = {len(cons)}, NS = {len(scalars)}, NT = {len(tables)};
  static constexpr bool END_COST = {"true" if end_cost else "false"};

  template <class S>
  __device__ static void dynamics({sig}, const S* u, S* f) {{
{dyn_body}
  }}

  template <class S>
  __device__ static S cost({sig}, const S* u) {{
{cost_body}
  }}

  template <class S>
  __device__ static void constraints({sig}, const S* u, S* g) {{
{cons_body}
  }}

  template <class S>
  __device__ static S end_cost({sig}) {{
{end_body}
  }}
}};

}}  // namespace ilqr_generic
"""
    return struct, text


def cuda_spec(name, states, actions, prob, dyn, cost, cons, end, param_syms,
              consts=()):
    """The generic kernel's :class:`~tpl_tpu_torch.optim.ilqr_generic.Spec`
    of a problem's four lists of sympy expressions (a config's, or a torch
    problem's traced by :mod:`.trace`): its struct (:func:`cuda_struct`),
    its params' order, its operation counts and its constant tables
    (``consts``: (name, array) pairs, laid one after another in the spec's
    ``consts``); ``prob`` is the plain version's Problem."""
    scalars = tuple(s.name for s in param_syms
                    if not isinstance(s, spx.ArraySymbol))
    tables = tuple(s.name for s in param_syms
                   if isinstance(s, spx.ArraySymbol))
    layout, flat, off = {}, [], 0
    for cname, arr in consts:
        arr = np.asarray(arr, np.float64)
        layout[cname] = (off, arr.shape)
        flat.append(arr.reshape(-1))
        off += arr.size
    struct_name, struct = cuda_struct(name, states, actions, dyn, cost, cons,
                                      end, scalars, tables, layout)
    chain = {}
    if dyn:
        chain = max((_chain(e) for e in dyn), key=lambda c: c[0])[1]
    ops = dict(dynamics=_count_ops(dyn), cost=_count_ops(cost),
               constraints=_count_ops(cons), end_cost=_count_ops(end))
    return ilqr_generic.Spec(
        name, prob.nx, prob.nu, prob.nc, scalars, tables, ops, chain,
        problem=prob, struct=struct, struct_name=struct_name,
        consts=np.concatenate(flat) if flat else None)


def make_problem(config):
    """Translate a :class:`Config` into ``(Problem, param_spec)`` for the
    iLQR engine — the analog of the reference's codegen step
    (reference: genopt.py:464-619)."""
    tr = _Translator(config)

    dyn_exprs = _as_expr_list(config.dynamics)
    if len(dyn_exprs) != len(config.states):
        raise ValueError("dynamics must provide one derivative per state")
    cost_exprs = _as_expr_list(config.costs)
    con_exprs = [sp.sympify(c) for c in config.constraints]
    end_exprs = _as_expr_list(config.end_costs)

    dyn_fn = tr.lambdify(dyn_exprs, label="dynamics")
    cost_fn = tr.lambdify(cost_exprs, label="costs")

    def dynamics(x, u, t, dt, p):
        return torch.stack(_terms(dyn_fn(x, u, t, dt, p), x, _lead(x, u, t)),
                           dim=-1)

    def cost(x, u, t, dt, p):
        return sum(_terms(cost_fn(x, u, t, dt, p), x, _lead(x, u, t)))

    constraints = None
    if con_exprs:
        con_fn = tr.lambdify(con_exprs, label="constraints")

        def constraints(x, u, t, dt, p):
            return torch.stack(
                _terms(con_fn(x, u, t, dt, p), x, _lead(x, u, t)), dim=-1)

    end_cost = None
    if not all(e.is_zero for e in end_exprs):
        end_fn = tr.lambdify(end_exprs, with_actions=False,
                             label="end_costs")

        def end_cost(x, t, dt, p):
            return sum(_terms(end_fn(x, None, t, dt, p), x,
                              _lead(x, None, t)))

    prob = Problem(config.name, nx=len(config.states),
                   nu=len(config.actions), nc=len(con_exprs),
                   dynamics=dynamics, cost=cost, end_cost=end_cost,
                   constraints=constraints)
    try:
        spec = cuda_spec(config.name, config.states, config.actions, prob,
                         dyn_exprs, cost_exprs, con_exprs, end_exprs,
                         tr.param_syms)
        prob = dataclasses.replace(prob, generated=spec)
        object.__setattr__(spec, "problem", prob)
    except Unprintable as e:
        warnings.warn(f"genopt: {config.name}: the CUDA printer has no form "
                      f"for {e.args[0]}; the problem solves with the plain "
                      "iLQR on the CPU and raises on a CUDA device",
                      stacklevel=3)

    spec = {}
    for s in tr.param_syms:
        if isinstance(s, spx.ArraySymbol):
            spec[s.name] = ArraySpec(config.array_capacity)
        else:
            spec[s.name] = 0.0
    return prob, spec


def build(config, device=None, dtype=None):
    """Build a solver class (a zero-argument factory) from a config, like the reference's
    ``genopt.build`` (reference: genopt.py:650-656). Returns a
    zero-argument callable producing a ready :class:`Solver` with the
    config's parameter defaults applied.  The solver runs on ``device``
    (``tpl_tpu_torch.device()`` unless given) in ``dtype`` (the
    ``Solver``'s float32 unless given), with the plain iLQR."""
    prob, spec = make_problem(config)
    defaults = _param_defaults(config.params)

    kwargs = {"horizon_max": config.horizon_max}
    if device is not None:
        kwargs["device"] = device
    if dtype is not None:
        kwargs["dtype"] = dtype

    def init_opt():
        opt = solver.Solver(prob, spec, **kwargs)
        for name, val in defaults.items():
            setattr(opt.params, name, val)
        return opt

    init_opt.problem = prob
    init_opt.param_spec = spec
    return init_opt


def build_parallel(configs, device=None, dtype=None):
    """Build several configs; translation is cheap, so a thread pool
    suffices (reference forks a process pool, genopt.py:658-665).  On a
    CUDA device the configs' generated kernel sources are compiled here,
    one ``nvcc`` each, all started together."""
    import tpl_tpu_torch

    with mp_dummy.Pool(min(len(configs), 8) or 1) as pool:
        out = pool.map(lambda c: build(c, device=device, dtype=dtype),
                       configs)
    dev = tpl_tpu_torch.device() if device is None else torch.device(device)
    if dev.type == "cuda":
        specs = [f.problem.generated for f in out
                 if f.problem.generated is not None]
        ilqr_generic.build_generated(specs, dtype or torch.float32)
    return out
