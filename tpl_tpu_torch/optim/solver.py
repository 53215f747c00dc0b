"""
Stateful solver wrapper around the iLQR core.

The port of ``tpl_tpu/optim/solver.py``.  It presents the working surface
of the reference's generated solver classes (optim.c:1654-1890: ``x``,
``u``, ``params``, ``u_min``/``u_max``, ``lagrange_multiplier``,
``barrier_weight``, ``lg_mult_limit``, ``horizon``, ``step``,
``max_iterations``, ``integrator_type``; ``update()``, ``shift(n)``,
``dynamics(x, u, t, dt)``), so planner and controller drivers read as in
the JAX package.

Host buffers are float64 numpy at fixed capacity; only the active horizon
slice is exposed.  Array params are edge-padded to capacity so the clamped
lerp lookups behave exactly like the reference's variable-length arrays.

The solve runs on the solver's device (``tpl_tpu_torch.device()`` unless
given).  Each :meth:`Solver.update` packs every input into one host buffer,
uploads it once and downloads one packed result.  A problem with a
hand-written kernel for the solver's dtype (``KERNELS``: the float64
spatial and time-indexed tracking MPCs, the float32 RSTP profiles) goes
through its wrapper, which launches the kernel on a CUDA device and runs
the plain :func:`~tpl_tpu_torch.optim.ilqr.make_update_fn` on a CPU device;
a problem whose kernel exists for another dtype raises on a CUDA device.
A problem without a kernel runs the plain version on its device, the card
included: on the card that is ``ref_line_smoother_k``, which
``path_smoothing``'s ``smooth_only`` path solves (off the vendored path);
``velocity_profile_time`` and ``ref_line_smoother_dk`` have no kernel
either, and no ported path solves them.
"""

import functools
import time

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch.optim import (ilqr, ilqr_rstp, ilqr_tracking_mpc,
                                 ilqr_tracking_mpc_time)
from tpl_tpu_torch.optim.ilqr import EULER, HEUN, RK4
from tpl_tpu_torch.optim.problems import ArraySpec  # noqa: F401 (re-export)

# (problem name, dtype) -> the solve of its hand-written kernel
KERNELS = {
    ("trajectory_tracking_mpc", torch.float64): ilqr_tracking_mpc.solve,
    ("trajectory_tracking_mpc_time", torch.float64):
        ilqr_tracking_mpc_time.solve,
    **{(name, torch.float32): functools.partial(ilqr_rstp.solve, name)
       for name in ilqr_rstp.PROBLEMS},
}

# limits outside this range travel as the sentinels (solver.py:348-355)
_BIG = 1e30


class SolverParams:
    """Attribute-style access to the parameter buffers."""

    def __init__(self, spec):
        object.__setattr__(self, "_spec", spec)
        object.__setattr__(self, "_values", {})
        for name, s in spec.items():
            if hasattr(s, "capacity"):
                self._values[name] = np.full(s.capacity, s.default,
                                             dtype=np.float64)
            else:
                self._values[name] = float(s)

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        values = object.__getattribute__(self, "_values")
        spec = object.__getattribute__(self, "_spec")
        if name not in values:
            raise AttributeError(f"unknown param {name!r}")
        s = spec[name]
        if hasattr(s, "capacity"):
            arr = np.asarray(value, dtype=np.float64).reshape(-1)
            n = min(len(arr), s.capacity)
            buf = values[name]
            buf[:n] = arr[:n]
            if n > 0:
                buf[n:] = arr[n - 1]   # edge padding preserves clamp semantics
        else:
            values[name] = float(value)

    def merge(self, obj):
        """Copy matching attributes from a plain params object."""
        src = obj if isinstance(obj, dict) else vars(obj)
        for k, v in src.items():
            if k in self._values:
                setattr(self, k, v)

    def as_dict(self, dtype, device):
        return {name: torch.as_tensor(v, dtype=dtype, device=device)
                for name, v in self._values.items()}


class Solver:
    """iLQR solver instance for one problem configuration."""

    EULER = EULER
    HEUN = HEUN
    RK4 = RK4

    def __init__(self, problem, param_spec, horizon_max,
                 integrator_type=EULER, dtype=torch.float32, device=None):
        self.problem = problem
        self.horizon_max = horizon_max
        self.dtype = dtype
        self.device = (tpl_tpu_torch.device() if device is None
                       else torch.device(device))
        self._integrator = integrator_type
        self._update_fns = {}

        nx, nu = problem.nx, problem.nu
        nc = max(problem.nc, 1)

        H = horizon_max
        self._x = np.zeros((H + 1, nx))
        self._u = np.zeros((H, nu))
        self._lam = np.zeros((H, nc))
        self._mu_step = 0
        self._u_min = np.full((H, nu), -np.inf)
        self._u_max = np.full((H, nu), np.inf)

        self.params = SolverParams(param_spec)

        self.horizon = min(20, H)       # optim.c default T=20
        self.step = 0.05                # optim.c default dt
        self.max_iterations = 5
        self.max_lg_iterations = 1
        self.min_rel_cost_change = 1e-6
        self.barrier_weight = np.ones(nc)
        self._lg_mult_limit = np.full(nc, np.inf)

        self.traj_costs = 0.0
        self.iterations = 0         # inner iterations of the last update
        self.updates = 0            # update() calls
        self.runtime = 0.0

    # --- genopt-style attribute surface -------------------------------

    @property
    def T(self):
        return self.horizon

    @property
    def dt(self):
        return self.step

    @property
    def integrator_type(self):
        return self._integrator

    @integrator_type.setter
    def integrator_type(self, v):
        self._integrator = int(v)

    @property
    def x(self):
        return self._x[:self.horizon + 1]

    @x.setter
    def x(self, v):
        self._x[:self.horizon + 1] = v

    @property
    def u(self):
        return self._u[:self.horizon]

    @u.setter
    def u(self, v):
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == 1:
            v = v[:, None]
        self._u[:self.horizon] = v

    @property
    def u_min(self):
        return self._u_min[:self.horizon]

    @u_min.setter
    def u_min(self, v):
        self._u_min[:self.horizon] = v

    @property
    def u_max(self):
        return self._u_max[:self.horizon]

    @u_max.setter
    def u_max(self, v):
        self._u_max[:self.horizon] = v

    @property
    def lagrange_multiplier(self):
        return self._lam[:self.horizon]

    @lagrange_multiplier.setter
    def lagrange_multiplier(self, v):
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == 1:
            v = v[:, None]
        self._lam[:self.horizon] = v

    @property
    def lg_mult_limit(self):
        return self._lg_mult_limit

    @lg_mult_limit.setter
    def lg_mult_limit(self, v):
        self._lg_mult_limit[:] = v

    # --- methods ------------------------------------------------------

    def load_state(self, x, u, lam, mu_step, params=None):
        """Carry a solver state across: full-capacity ``x`` (H+1, nx),
        ``u`` (H, nu), ``lam`` (H, nc) and ``mu_step`` (numpy, e.g. read off
        the JAX package's ``Solver``), and optionally a params dict."""
        self._x[:] = x
        self._u[:] = u
        self._lam[:] = lam
        self._mu_step = int(mu_step)
        if params is not None:
            for name, v in params.items():
                setattr(self.params, name, v)

    def shift(self, amount):
        """Warm-start shift (optim.c:1162-1177)."""
        amount = max(0, int(amount))
        T = self.horizon
        idx_x = np.minimum(np.arange(T + 1) + amount, T)
        self._x[:T + 1] = self._x[idx_x]
        idx_u = np.minimum(np.arange(T) + amount, T - 1)
        self._u[:T] = self._u[idx_u]
        self._lam[:T] = self._lam[idx_u]

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self.dtype).to(self.device)

    def dynamics(self, x, u, t, dt):
        """Single discrete integration step."""
        p = self.params.as_dict(self.dtype, self.device)
        res = ilqr._integrate(self.problem.dynamics, self._tensor(x),
                              self._tensor(u), t, self._tensor(dt), p,
                              self._integrator)
        return res.cpu().numpy().astype(np.float64)

    def rollforward_deadtime(self, x0, cmds, valid, idx_delta, idx_acc, dt):
        """Integrate ``x0`` through the command window ``cmds``
        ((n, 2) rows of (acc, steer); rows with ``valid`` False are
        pass-through padding at the front). Each step writes the issued
        command into the state's (acc, steer) slots and integrates one
        ``dt`` with the solver's own dynamics, so the compensation model
        matches the MPC prediction model exactly.

        Returns an (n+1, nx) float64 trace: row i = state after i steps.
        """
        p = self.params.as_dict(self.dtype, self.device)
        x = self._tensor(x0)
        cmds = self._tensor(cmds)
        dt = self._tensor(dt)
        u0 = torch.zeros(self.problem.nu, dtype=self.dtype,
                         device=self.device)
        slots = [idx_acc, idx_delta]
        trace = []
        for cmd, ok in zip(cmds, np.asarray(valid, bool)):
            trace.append(x)
            if ok:
                xs = x.clone()
                xs[slots] = cmd
                x = ilqr._integrate(self.problem.dynamics, xs, u0, 0, dt, p,
                                    self._integrator)
        trace.append(x)
        return torch.stack(trace).cpu().numpy().astype(np.float64)

    def _plain_update_fn(self, integrator):
        fn = self._update_fns.get(integrator)
        if fn is None:
            fn = ilqr.make_update_fn(self.problem, self.horizon_max,
                                     integrator=integrator, dtype=self.dtype)
            self._update_fns[integrator] = fn
        return fn

    def _inputs(self):
        """Every per-update input, by name, as float64 arrays."""
        u_lims = np.stack(
            [np.nan_to_num(self._u_min, neginf=-_BIG),
             np.nan_to_num(self._u_max, posinf=_BIG)], axis=-1)
        bw_lim = np.stack(
            [self.barrier_weight,
             np.nan_to_num(self._lg_mult_limit, posinf=_BIG)], axis=-1)
        cfg_f = np.array([self.step, self.min_rel_cost_change])
        return dict(x=self._x, u=self._u, lam=self._lam, u_lims=u_lims,
                    bw_lim=bw_lim, cfg_f=cfg_f)

    def update(self):
        start = time.perf_counter()
        name = self.problem.name
        kernel = KERNELS.get((name, self.dtype))
        run = (self.horizon, self.max_iterations, self.max_lg_iterations,
               self._mu_step, self._integrator)
        if kernel is not None:
            res = kernel(self._inputs(), self.params._values, *run,
                         self.device)
        elif self.device.type == "cuda" and any(n == name for n, _ in KERNELS):
            dtypes = [str(d) for n, d in KERNELS if n == name]
            raise ValueError(f"{name}: the CUDA solve takes {dtypes}, got "
                             f"{self.dtype}")
        else:
            res = self._plain_solve(*run)
        self._x[:] = res["x"]
        self._u[:] = res["u"]
        self._lam[:] = res["lam"]
        self._mu_step = int(res["mu_step"])
        self.traj_costs = float(res["traj_costs"])
        self.iterations = int(res["iterations"])
        self.updates += 1
        self.runtime = (time.perf_counter() - start) * 1000.0
        return self

    def _plain_solve(self, T, max_iterations, max_lg_iterations, mu_step,
                     integrator):
        """The plain iLQR solve on the solver's device: one upload of the
        packed inputs, one download of the packed results."""
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        arrays = list(self._inputs().items())
        arrays += [("param " + n, v) for n, v in self.params._values.items()]
        offsets, _ = ilqr.layout((n, np.shape(a)) for n, a in arrays)
        host = np.concatenate([np.asarray(a, np_dtype).reshape(-1)
                               for _, a in arrays])
        dev = ilqr.unpack(torch.from_numpy(host).to(self.device), offsets)

        params = {n: dev["param " + n] for n in self.params._values}
        cfg = ilqr.packed_cfg(dev["u_lims"], dev["bw_lim"], dev["cfg_f"], T,
                              max_iterations, max_lg_iterations)
        state = ilqr.SolverState(dev["x"], dev["u"], dev["lam"], mu_step)
        new, info = self._plain_update_fn(integrator)(
            state, dev["x"][0], params, cfg)
        out = torch.cat([new.x.reshape(-1), new.u.reshape(-1),
                         new.lam.reshape(-1), info["traj_costs"].reshape(1)])
        offsets, _ = ilqr.layout([("x", new.x.shape), ("u", new.u.shape),
                                  ("lam", new.lam.shape),
                                  ("traj_costs", ())])
        res = ilqr.unpack(out.cpu().numpy().astype(np.float64), offsets)
        res.update(mu_step=new.mu_step, iterations=info["iterations"])
        return res
