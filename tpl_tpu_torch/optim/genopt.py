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
``tpl_tpu_torch.device()`` (the card) unless a device is given, and always
solves with the plain iLQR: a hand-written kernel hard-codes its own
problem, so a translated problem never takes one, whatever its name.

Inside expressions, the symbol ``t`` is the step index and ``dt`` the
integration step, matching the generated solvers' routine signatures
(reference: optim.c:1091-1105 passes the loop index as ``t``).
"""

import multiprocessing.dummy as mp_dummy

import sympy as sp
import torch
from sympy.printing.codeprinter import CodePrinter
from sympy.printing.pytorch import TorchPrinter

from tpl_tpu_torch.optim import symext as spx
from tpl_tpu_torch.optim.ilqr import Problem
from tpl_tpu_torch.optim.problems import ArraySpec
from tpl_tpu_torch.optim.solver import Solver
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
        opt = Solver(prob, spec, **kwargs)
        for name, val in defaults.items():
            setattr(opt.params, name, val)
        return opt

    init_opt.problem = prob
    init_opt.param_spec = spec
    return init_opt


def build_parallel(configs, device=None, dtype=None):
    """Build several configs; translation is cheap (no C compiler), so a
    thread pool suffices (reference forks a process pool,
    genopt.py:658-665)."""
    with mp_dummy.Pool(min(len(configs), 8) or 1) as pool:
        return pool.map(lambda c: build(c, device=device, dtype=dtype),
                        configs)
