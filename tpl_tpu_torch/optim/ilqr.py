"""
Augmented-Lagrangian iLQR solver core, in plain PyTorch.

The port of ``tpl_tpu/optim/ilqr.py``.  The user supplies ``dynamics`` /
``cost`` / ``constraints`` as torch functions; autograd differentiates
them for all steps of the horizon in one pass (:func:`derivatives`), and
``torch.func`` differentiates the end cost.  The scans and while loops of
the JAX program are Python loops.

Problem functions broadcast over leading dimensions (``x[..., i]``,
``stack(..., -1)``): the same function evaluates all H steps of a
trajectory at once (derivatives, cost, multiplier update), the 8
line-search candidates of a rollout step at once, and one step.

Algorithmic parity notes (optim.c semantics, as the JAX package keeps them):

- AL penalty: cost += lam*c + (0 if c<0 and |lam|<1e-4 else w*c^2)
  (genopt.py:73-90 augment_costs).
- Multiplier update before each inner solve: lam <- clip(lam + w*c, 0,
  lam_max) (optim.c:1113-1131).  The stored trajectory cost is *not*
  recomputed with the new multipliers: the initial cost uses the OLD ones
  (stale-cost comparison).
- Backward pass: Euler jacobians fx = I + dt*df/dx whatever the rollout
  integrator (genopt.py computes the jacobian of x + dt*f), mu added to
  Quu's diagonal.  1-D action solve: zero gain when Quu <= 0; 2-D: the
  closed-form inverse with no Quu > 0 check (optim.c:243-291).
- Control limits: clamped feedforward k with row-zeroed feedback K
  (optim.c:950-963), plus clamping in the forward rollout (optim.c:747-760).
- Line search: alpha = 10^-i, i = 0..7; the first (largest) alpha whose
  cost is finite, non-negative and below the current one wins
  (optim.c:836-873).
- mu schedule: success -> mu_step-1 (min 0), failure -> mu_step+1 (max 7);
  mu = 0 if mu_step == 0 else 10^(mu_step-1) (optim.c:989-999).
- Termination: |dcost| / cost < min_rel_cost_change, with a zero cost
  replaced by 1 in the denominator (optim.c:1001-1006); a failed line search
  therefore also terminates.
- Steps beyond the active horizon T are frozen: state held, zero cost, zero
  gains.  T is a host integer, so the loops simply stop at T.
"""

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import grad, jacfwd

import tpl_tpu_torch

EULER = 0
HEUN = 1
RK4 = 2

# "how many mathematicians could you take in a fight?" (genopt.py:81)
_AL_ZERO = 1e-4

# the phases of one solve that the kernels' profiling instantiations clock,
# in the order of enum Phase in csrc/ilqr_common.cuh
PHASES = ("load", "init_rollout", "multipliers", "derivatives", "riccati",
          "rollouts", "step_costs", "cost_sums", "pick_copy", "store")
# phases that run once per iteration (the others once per solve or round)
ITERATION_PHASES = PHASES[3:9]

# line-search step sizes, as the JAX package computes them (numpy's power:
# 10.0 ** -5 here is not the double nearest 1e-5)
ALPHAS = 10.0 ** -np.arange(8)


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static optimal-control problem definition.

    dynamics(x, u, t, dt, params) -> dx/dt           (continuous time)
    cost(x, u, t, dt, params) -> scalar              (per-step, unscaled)
    end_cost(x, t, dt, params) -> scalar
    constraints(x, u, t, dt, params) -> (nc,)        (feasible iff <= 0)

    ``kernel`` names the definition the port's hand-written kernels were
    written for (the key of ``solver.KERNELS``): only the native problems
    of :mod:`.problems` carry it, so no problem defined elsewhere reaches a
    kernel, whatever its name.  ``generated`` is the problem struct the
    sympy front end printed for its own config
    (:class:`tpl_tpu_torch.optim.ilqr_generic.Spec`), which the generic
    kernel solves; None for every other problem.
    """

    name: str
    nx: int
    nu: int
    nc: int
    dynamics: Callable
    cost: Callable = None
    end_cost: Callable = None
    constraints: Callable = None
    kernel: str = None
    generated: object = None


@dataclasses.dataclass
class SolverState:
    """Per-instance solver state: x (H+1, nx), u (H, nu), lam (H, nc)
    tensors and the host integer mu_step."""

    x: torch.Tensor
    u: torch.Tensor
    lam: torch.Tensor
    mu_step: int = 0


def init_state(prob, horizon, dtype=torch.float32, device=None):
    dev = tpl_tpu_torch.device() if device is None else torch.device(device)
    return SolverState(
        x=torch.zeros((horizon + 1, prob.nx), dtype=dtype, device=dev),
        u=torch.zeros((horizon, prob.nu), dtype=dtype, device=dev),
        lam=torch.zeros((horizon, max(prob.nc, 1)), dtype=dtype, device=dev),
        mu_step=0)


def _integrate(dynamics, x, u, t, dt, params, integrator):
    """Discrete step, matching optim.c:657-731 EULER/HEUN/RK4."""
    if integrator == EULER:
        return x + dt * dynamics(x, u, t, dt, params)
    if integrator == HEUN:
        k1 = dynamics(x, u, t, dt, params)
        k2 = dynamics(x + dt * k1, u, t, dt, params)
        return x + dt / 2.0 * (k1 + k2)
    if integrator == RK4:
        k1 = dynamics(x, u, t, dt, params)
        k2 = dynamics(x + dt / 2.0 * k1, u, t, dt, params)
        k3 = dynamics(x + dt / 2.0 * k2, u, t, dt, params)
        k4 = dynamics(x + dt * k3, u, t, dt, params)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(f"unknown integrator {integrator}")


def constraints(prob, x, u, t, dt, params):
    """The problem's constraints, or one zero column if it has none."""
    if prob.constraints is not None and prob.nc > 0:
        return prob.constraints(x, u, t, dt, params)
    return torch.zeros(x.shape[:-1] + (max(prob.nc, 1),), dtype=x.dtype,
                       device=x.device)


def augmented_cost(prob, x, u, t, dt, params, lam, w):
    """Step cost plus the AL terms (genopt.py:73-90 augment_costs)."""
    c = prob.cost(x, u, t, dt, params)
    if prob.constraints is not None and prob.nc > 0:
        g = prob.constraints(x, u, t, dt, params)
        inactive = (g < 0.0) & (torch.abs(lam) < _AL_ZERO)
        c = c + torch.sum(g * lam, -1)
        c = c + torch.sum(torch.where(inactive, 0.0, w * g * g), -1)
    return c


def derivatives(prob, xs, us, ts, dt, params, lam, w):
    """Backward-pass derivatives of n steps at once: fx = I + dt*df/dx
    (Euler jacobians whatever the rollout integrator), fu = dt*df/du, and
    the augmented cost's lx, lu, lxx, luu, lux; shapes (n, ...), or
    (B, n, ...) for a batch of trajectories ``xs`` (B, n, nx).

    Step t's dynamics and cost depend on (x_t, u_t) alone, so
    differentiating their sums over the steps (and the batch) gives every
    step's derivative exactly; the rows of each jacobian come from one
    batched backward pass (``vmap`` over the basis vectors).  On the CPU
    this is ~7x faster than ``vmap(hessian(...))`` over the horizon.
    """
    nx, nu = prob.nx, prob.nu
    nz, lead = nx + nu, xs.shape[:-1]
    with torch.enable_grad():
        z = torch.cat([xs, us], -1).detach().requires_grad_()
        x, u = z[..., :nx], z[..., nx:]
        f = prob.dynamics(x, u, ts, dt, params)
        c = augmented_cost(prob, x, u, ts, dt, params, lam, w)
        g, = torch.autograd.grad(c.sum(), z, create_graph=True)
        basis = torch.eye(nz, dtype=z.dtype, device=z.device).reshape(
            (nz,) + (1,) * len(lead) + (nz,))
        jf, = torch.autograd.grad(
            f, z, basis[:nx, ..., :nx].expand((nx,) + lead + (nx,)),
            retain_graph=True, is_grads_batched=True)
        hc, = torch.autograd.grad(
            g, z, basis.expand((nz,) + lead + (nz,)), is_grads_batched=True)
    jf = jf.detach().movedim(0, -2)             # (..., nx, nz)
    hc = hc.detach().movedim(0, -2)             # (..., nz, nz)
    g = g.detach()
    eye = torch.eye(nx, dtype=xs.dtype, device=xs.device)
    fx = eye + dt * jf[..., :nx]
    fu = dt * jf[..., nx:]
    return (fx, fu, g[..., :nx], g[..., nx:], hc[..., :nx, :nx],
            hc[..., nx:, nx:], hc[..., nx:, :nx])


def layout(shapes):
    """Offsets of ``(name, shape)`` pairs packed one after another in a
    flat buffer: ({name: (offset, shape)}, total size)."""
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = (off, tuple(shape))
        off += int(np.prod(shape, dtype=np.int64))
    return out, off


def unpack(buf, offsets):
    """Views of a packed flat buffer (numpy or torch) by name."""
    return {name: buf[off:off + int(np.prod(shape, dtype=np.int64))]
            .reshape(shape) for name, (off, shape) in offsets.items()}


def packed_cfg(u_lims, bw_lim, cfg_f, T, max_iterations, max_lg_iterations):
    """The ``cfg`` of :func:`make_update_fn` from the packed limits
    ``u_lims`` (H, nu, 2) = (min, max), ``bw_lim`` (nc, 2) = (barrier
    weight, multiplier limit) and ``cfg_f`` = (dt, min_rel_cost_change)."""
    return dict(u_min=u_lims[..., 0], u_max=u_lims[..., 1],
                barrier_weight=bw_lim[:, 0], lg_mult_limit=bw_lim[:, 1],
                dt=cfg_f[0], min_rel_cost_change=cfg_f[1], T=int(T),
                max_iterations=int(max_iterations),
                max_lg_iterations=int(max_lg_iterations))


def make_update_fn(prob: Problem, horizon: int, integrator: int = EULER,
                   dtype=torch.float32):
    """Build ``update(state, x0, params, cfg) -> (state, info)``.

    ``params`` maps names to 0-d / 1-d tensors; ``cfg`` holds u_min, u_max
    (H, nu), barrier_weight, lg_mult_limit (nc,) and the 0-d dt and
    min_rel_cost_change tensors of ``dtype``, plus the host integers T,
    max_iterations and max_lg_iterations.  ``info`` has ``traj_costs`` (0-d
    tensor) and ``iterations`` (inner iterations run, all AL rounds).
    """

    H = horizon
    nx, nu = prob.nx, prob.nu

    def aug_cost(x, u, t, dt, params, lam, w):
        return augmented_cost(prob, x, u, t, dt, params, lam, w)

    def end_cost(x, t, dt, params):
        if prob.end_cost is None:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return prob.end_cost(x, t, dt, params)

    def step(x, u, t, dt, params):
        return _integrate(prob.dynamics, x, u, t, dt, params, integrator)

    # ---- action solve (optim.c:243-291) ----

    def solve_action(Quu, Qu, Qux, mu):
        if nu == 1:
            quu = Quu[0, 0]
            inv = torch.where(quu > 0.0, -1.0 / (quu + mu),
                              torch.zeros_like(quu))
            return inv * Qu, inv * Qux
        if nu == 2:
            a = Quu[0, 0] + mu
            b = Quu[0, 1]
            d = Quu[1, 1] + mu
            det = a * d - b * b
            inv_det = -1.0 / det
            inv = torch.stack([torch.stack([d, -b]),
                               torch.stack([-b, a])]) * inv_det
            return inv @ Qu, inv @ Qux
        reg = Quu + mu * torch.eye(nu, dtype=Quu.dtype, device=Quu.device)
        sol = torch.linalg.solve(reg, torch.cat([Qu[:, None], Qux], dim=1))
        return -sol[:, 0], -sol[:, 1:]

    # ---- rollouts ----

    def rollout(x0, us, dt, T, params):
        """Open-loop rollout with the current controls; frozen beyond T."""
        xs = [x0]
        for t in range(H):
            xs.append(step(xs[-1], us[t], t, dt, params) if t < T else xs[-1])
        return torch.stack(xs)

    def traj_cost(xs, us, ts, dt, T, params, lam, w):
        """Trajectory cost of one or a batch (leading dims) of rollouts."""
        cs = aug_cost(xs[..., :-1, :], us, ts, dt, params, lam, w)
        c = torch.sum(torch.where(ts < T, cs, 0.0), -1)
        xT = xs[..., min(max(T, 0), H), :]
        return c + end_cost(xT, T, dt, params)

    def fb_rollouts(alphas, xs_ref, us_ref, ks, Ks, u_min, u_max, dt, T,
                    params):
        """The closed-loop rollouts of all alphas at once (optim.c:733-793)."""
        x = xs_ref[0].expand(len(alphas), nx)
        xs, us = [x], []
        for t in range(H):
            if t < T:
                u = (us_ref[t] + alphas[:, None] * ks[t]
                     + (x - xs_ref[t]) @ Ks[t].T)
                u = torch.minimum(torch.maximum(u, u_min[t]), u_max[t])
                x = step(x, u, t, dt, params)
            else:
                u = us_ref[t].expand(len(alphas), nu)
            xs.append(x)
            us.append(u)
        return torch.stack(xs, 1), torch.stack(us, 1)

    # ---- backward pass ----

    def backward(xs, us, lam, w, u_min, u_max, dt, T, params, mu, ts):
        ks = torch.zeros((H, nu), dtype=xs.dtype, device=xs.device)
        Ks = torch.zeros((H, nu, nx), dtype=xs.dtype, device=xs.device)
        n = min(T, H)
        if n <= 0:
            return ks, Ks
        fx, fu, lx, lu, lxx, luu, lux = derivatives(
            prob, xs[:n], us[:n], ts[:n], dt, params, lam[:n], w)

        Vx = torch.zeros(nx, dtype=xs.dtype, device=xs.device)
        Vxx = torch.zeros((nx, nx), dtype=xs.dtype, device=xs.device)
        if T <= H and prob.end_cost is not None:
            ec = lambda x_: end_cost(x_, T, dt, params)
            Vx = grad(ec)(xs[T])
            Vxx = jacfwd(grad(ec))(xs[T]).reshape(nx, nx)
        for t in range(n - 1, -1, -1):
            fx_t, fu_t = fx[t], fu[t]
            Qx = lx[t] + fx_t.T @ Vx
            Qu = lu[t] + fu_t.T @ Vx
            Qxx = lxx[t] + fx_t.T @ Vxx @ fx_t
            Quu = luu[t] + fu_t.T @ Vxx @ fu_t
            Qux = lux[t] + fu_t.T @ Vxx @ fx_t

            k, K = solve_action(Quu, Qu, Qux, mu)

            c = us[t] + k
            over = c > u_max[t]
            under = c < u_min[t]
            k = torch.where(over, u_max[t] - us[t], k)
            k = torch.where(under, u_min[t] - us[t], k)
            K = torch.where((over | under)[:, None], 0.0, K)

            KQux = K.T @ Qux
            Vxx = Qxx + KQux + KQux.T + K.T @ Quu @ K
            Vx = K.T @ Quu @ k + K.T @ Qu + Qux.T @ k + Qx
            ks[t] = k
            Ks[t] = K
        return ks, Ks

    # ---- inner iLQR (optim.c:875-1008) ----

    def ilqr(x, u, lam, mu_step, traj_costs, cfg, params, ts, alphas):
        u_min, u_max = cfg["u_min"], cfg["u_max"]
        w = cfg["barrier_weight"]
        dt, T = cfg["dt"], cfg["T"]
        it = 0
        while it < cfg["max_iterations"]:
            mu = 0.0 if mu_step == 0 else 10.0 ** (mu_step - 1)
            ks, Ks = backward(x, u, lam, w, u_min, u_max, dt, T, params, mu,
                              ts)
            xs8, us8 = fb_rollouts(alphas, x, u, ks, Ks, u_min, u_max, dt,
                                   T, params)
            costs8 = traj_cost(xs8, us8, ts, dt, T, params, lam, w)

            improving = ((costs8 < traj_costs) & torch.isfinite(costs8)
                         & (costs8 >= 0.0))
            hits = torch.nonzero(improving).flatten().tolist()
            if hits:
                i = hits[0]
                x, u, costs_new = xs8[i], us8[i], costs8[i]
                mu_step = max(0, mu_step - 1)
            else:
                costs_new = traj_costs
                mu_step = min(mu_step + 1, 7)
            denom = torch.where(costs_new == 0.0, 1.0, costs_new)
            rel = torch.abs(costs_new - traj_costs) / denom
            traj_costs = costs_new
            it += 1
            if bool(rel < cfg["min_rel_cost_change"]):
                break
        return x, u, traj_costs, mu_step, it

    # ---- full update (optim.c:1091-1160) ----

    def update(state: SolverState, x0, params, cfg):
        x0 = torch.as_tensor(x0, dtype=dtype)
        dev = x0.device
        u = state.u.to(dtype)
        lam = state.lam.to(dtype)
        mu_step = int(state.mu_step)
        w = cfg["barrier_weight"]
        dt, T = cfg["dt"], int(cfg["T"])
        ts = torch.arange(H, device=dev)
        alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=dev)

        # initial rollout with the current controls and the OLD multipliers
        xs = rollout(x0, u, dt, T, params)
        traj_costs = traj_cost(xs, u, ts, dt, T, params, lam, w)

        iterations = 0
        for _ in range(int(cfg["max_lg_iterations"])):
            # clipped multiplier update (optim.c:1113-1131)
            cs = constraints(prob, xs[:-1], u, ts, dt, params)
            lam_new = torch.minimum(torch.clamp(lam + w * cs, min=0.0),
                                    cfg["lg_mult_limit"])
            lam = torch.where((ts < T)[:, None], lam_new, lam)
            xs, u, traj_costs, mu_step, it = ilqr(
                xs, u, lam, mu_step, traj_costs, cfg, params, ts, alphas)
            iterations += it

        new_state = SolverState(xs, u, lam, mu_step)
        return new_state, {"traj_costs": traj_costs,
                           "iterations": iterations}

    return update
