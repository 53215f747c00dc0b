"""
Ready-to-serve solver classes, mirroring the reference module surface.

The port of ``tpl_tpu/optim/optimizers.py``.  The reference's
``tpl.optim.optimizers`` compiles its sympy configs to C extension classes
and injects them into this module's globals via ``build_optimizers()``
(reference: library/tpl/optim/optimizers.py:560-582), after which drivers
write ``opts.trajectory_tracking_mpc()``.

Here the "build" is instantaneous: each name binds a factory over the
native torch problem definitions in :mod:`tpl_tpu_torch.optim.problems`,
returning a ready :class:`tpl_tpu_torch.optim.solver.Solver`.
``build_optimizers()`` is kept for call-site compatibility and populates
the globals the same way; the names are also built lazily on first
attribute access, so ``opts.trajectory_tracking_mpc()`` works without the
explicit build call.

All seven configs are provided — including ``velocity_profile_time``,
which the reference defines but leaves out of its build list
(reference: optimizers.py:562-568).

Where the solvers run, and in which dtype: the JAX package's factories make
a float32 solver pinned to the host CPU.  Here a factory's solver runs on
``tpl_tpu_torch.device()`` (the card) unless the call gives ``device=``,
and a problem with a hand-written kernel gets its kernel's dtype, since on
a CUDA device the ``Solver`` raises for a problem whose kernel exists only
for another dtype (``solver.KERNELS``): float64 for the two tracking MPCs,
float32 for ``lateral_profile`` and ``velocity_profile_space``; the other
three keep the JAX package's float32, which the generic kernel
(``csrc/ilqr_generic.cu``) takes as it takes float64.  ``dtype=`` overrides
either.

The factories hold the JAX package's horizon of 300 on every device.  A
kernel sizes its shared memory by the solver's ``horizon_max``: the
tracking MPCs' own float64 kernels hold at most 110 (spatial) and 132
(time-indexed) steps in the 227 KB a block can use at the problems' default
reference capacities, so at 300 their solvers take the generic kernel
(``csrc/ilqr_generic.cu``, ``solver.route``), which keeps in shared memory
what fits and the rest of a solve's arrays in a global workspace; a solver
made with a smaller ``horizon_max`` (the vendored controller's 60) keeps
the MPC's own kernel.  The RSTP profiles launch ``csrc/ilqr_rstp.cu`` at
300, ``velocity_profile_time``, ``ref_line_smoother_k`` and
``ref_line_smoother_dk`` the generic kernel.
"""

import torch

import tpl_tpu_torch
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.optim.solver import Solver

HORIZON_MAX = 300   # the JAX package's factories' horizon capacity

# (problem factory, dtype)
_FACTORIES = {
    "trajectory_tracking_mpc": (problems.trajectory_tracking_mpc,
                                torch.float64),
    "trajectory_tracking_mpc_time": (problems.trajectory_tracking_mpc_time,
                                     torch.float64),
    "lateral_profile": (problems.lateral_profile, torch.float32),
    "velocity_profile_space": (problems.velocity_profile_space,
                               torch.float32),
    "velocity_profile_time": (problems.velocity_profile_time, torch.float32),
    "ref_line_smoother_k": (problems.ref_line_smoother_k, torch.float32),
    "ref_line_smoother_dk": (problems.ref_line_smoother_dk, torch.float32),
}


def _make_factory(name):
    factory, dtype = _FACTORIES[name]
    prob, spec = factory()

    def init_opt(dtype=dtype, device=None):
        dev = (tpl_tpu_torch.device() if device is None
               else torch.device(device))
        return Solver(prob, spec, horizon_max=HORIZON_MAX, dtype=dtype,
                      device=dev)

    init_opt.__name__ = name
    init_opt.problem = prob
    init_opt.param_spec = spec
    init_opt.dtype = dtype
    return init_opt


def build_optimizers(force_rebuild=False):
    """Populate module globals with all solver factories
    (reference: optimizers.py:560-582)."""
    for name in _FACTORIES:
        if force_rebuild or name not in globals():
            globals()[name] = _make_factory(name)


def __getattr__(name):
    if name in _FACTORIES:
        factory = _make_factory(name)
        globals()[name] = factory
        return factory
    raise AttributeError(name)
