"""
The plain AL-iLQR of upstream ``optim.c``, batched over scenarios, in plain
PyTorch: the yardstick the benchmark holds the port's solves against.

A frozen copy of the port's plain batched update (the algorithm of
``tpl_tpu_torch/optim/batched.py``'s ``plain`` with the derivatives of
``optim/ilqr.py``), kept here so that a later change to the program cannot
move it.  It imports nothing of the program.

Semantics, per scenario (optim.c, as the port keeps them):

- AL penalty: cost += lam*c + (0 if c < 0 and |lam| < 1e-4 else w*c^2).
- One multiplier round: lam <- min(max(lam + w*c, 0), lam_max) on the
  active steps, after the initial rollout; the stored cost keeps the OLD
  multipliers.
- Backward pass with Euler jacobians (fx = I + dt df/dx whatever the
  integrator), mu on Quu's diagonal; the nu = 1 solve gives a zero gain
  where Quu <= 0, the nu = 2 solve is the closed-form inverse.
- Clamped feedforward with row-zeroed feedback, clamped rollouts.
- Line search over alpha = 10^-i, i = 0..7: the first finite,
  non-negative cost below the current one wins.
- mu schedule: success mu_step - 1 (min 0), failure + 1 (max 7);
  mu = 0 at mu_step 0, else 10^(mu_step - 1).
- A scenario is done when |dcost| / cost < min_rel_cost_change (a zero
  cost counts as 1); a done scenario is frozen while the others iterate.

:func:`solve_scenarios` solves a cell's scenarios at a configuration's
settings; :func:`gaps` gives the numbers the check compares.

Every problem function broadcasts over leading dimensions, the scenario
first: ``(B, ..., n)``.  A table is shared ``(n_ref,)`` or one a scenario
``(B, n_ref)`` (see :mod:`.interp`).
"""

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from benchmark import common

EULER, HEUN, RK4 = 0, 1, 2
AL_ZERO = 1e-4
# as numpy computes them: 10.0 ** -5 is not the double nearest 1e-5
ALPHAS = 10.0 ** -np.arange(8)


@dataclasses.dataclass(frozen=True)
class Problem:
    """dynamics(x, u, t, dt, p) -> dx/dt; cost(x, u, t, dt, p) -> step
    cost; constraints(x, u, t, dt, p) -> (..., nc), feasible where <= 0."""

    name: str
    nx: int
    nu: int
    nc: int
    dynamics: Callable
    cost: Callable
    constraints: Callable = None


def integrate(prob, x, u, t, dt, p, integrator):
    if integrator == EULER:
        return x + dt * prob.dynamics(x, u, t, dt, p)
    if integrator == HEUN:
        k1 = prob.dynamics(x, u, t, dt, p)
        k2 = prob.dynamics(x + dt * k1, u, t, dt, p)
        return x + dt / 2.0 * (k1 + k2)
    if integrator == RK4:
        k1 = prob.dynamics(x, u, t, dt, p)
        k2 = prob.dynamics(x + dt / 2.0 * k1, u, t, dt, p)
        k3 = prob.dynamics(x + dt / 2.0 * k2, u, t, dt, p)
        k4 = prob.dynamics(x + dt * k3, u, t, dt, p)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(f"unknown integrator {integrator}")


def constraints(prob, x, u, t, dt, p):
    if prob.constraints is not None and prob.nc > 0:
        return prob.constraints(x, u, t, dt, p)
    return torch.zeros(x.shape[:-1] + (max(prob.nc, 1),), dtype=x.dtype,
                       device=x.device)


def augmented_cost(prob, x, u, t, dt, p, lam, w):
    c = prob.cost(x, u, t, dt, p)
    if prob.constraints is not None and prob.nc > 0:
        g = prob.constraints(x, u, t, dt, p)
        inactive = (g < 0.0) & (torch.abs(lam) < AL_ZERO)
        c = c + torch.sum(g * lam, -1)
        c = c + torch.sum(torch.where(inactive, 0.0, w * g * g), -1)
    return c


def derivatives(prob, xs, us, ts, dt, p, lam, w):
    """fx = I + dt df/dx, fu = dt df/du and the augmented cost's lx, lu,
    lxx, luu, lux of every step of ``xs`` (B, n, nx) at once: a step's
    dynamics and cost depend on its own (x, u) alone, so the derivatives of
    their sums over the steps are every step's."""
    nx, nu = prob.nx, prob.nu
    nz, lead = nx + nu, xs.shape[:-1]
    with torch.enable_grad():
        z = torch.cat([xs, us], -1).detach().requires_grad_()
        x, u = z[..., :nx], z[..., nx:]
        f = prob.dynamics(x, u, ts, dt, p)
        c = augmented_cost(prob, x, u, ts, dt, p, lam, w)
        g, = torch.autograd.grad(c.sum(), z, create_graph=True)
        basis = torch.eye(nz, dtype=z.dtype, device=z.device).reshape(
            (nz,) + (1,) * len(lead) + (nz,))
        jf, = torch.autograd.grad(
            f, z, basis[:nx, ..., :nx].expand((nx,) + lead + (nx,)),
            retain_graph=True, is_grads_batched=True)
        hc, = torch.autograd.grad(
            g, z, basis.expand((nz,) + lead + (nz,)), is_grads_batched=True)
    jf = jf.detach().movedim(0, -2)
    hc = hc.detach().movedim(0, -2)
    g = g.detach()
    eye = torch.eye(nx, dtype=xs.dtype, device=xs.device)
    return (eye + dt * jf[..., :nx], dt * jf[..., nx:], g[..., :nx],
            g[..., nx:], hc[..., :nx, :nx], hc[..., nx:, nx:],
            hc[..., nx:, :nx])


def _solve_action(Quu, Qu, Qux, mu, nu):
    if nu == 1:
        quu = Quu[:, 0, 0]
        inv = torch.where(quu > 0.0, -1.0 / (quu + mu), torch.zeros_like(quu))
        return inv[:, None] * Qu, inv[:, None, None] * Qux
    if nu == 2:
        a = Quu[:, 0, 0] + mu
        b = Quu[:, 0, 1]
        d = Quu[:, 1, 1] + mu
        inv_det = -1.0 / (a * d - b * b)
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-b, a], -1)], -2) \
            * inv_det[:, None, None]
        return (inv @ Qu[..., None])[..., 0], inv @ Qux
    reg = Quu + mu[:, None, None] * torch.eye(nu, dtype=Quu.dtype,
                                              device=Quu.device)
    sol = torch.linalg.solve(reg, torch.cat([Qu[..., None], Qux], -1))
    return -sol[..., 0], -sol[..., 1:]


def solve(prob, x0, u, lam, mu_step, p, cfg, integrator, dtype):
    """One update of B scenarios: ``x0`` (B, nx), ``u`` (B, H, nu), ``lam``
    (B, H, nc), ``mu_step`` (B,) integers, ``p`` the params (scalars 0-d,
    tables (n_ref,) or (B, n_ref)), ``cfg`` the limits (``u_min`` /
    ``u_max`` (H, nu), ``barrier_weight`` / ``lg_mult_limit`` (nc,)) and
    the floats ``dt``, ``min_rel_cost_change`` and integers ``T``,
    ``max_iterations``.  Returns a dict of ``x`` (B, H+1, nx), ``u``,
    ``lam``, ``mu_step``, ``traj_costs`` (B,), and the statistics
    ``iterations`` (B,) and ``rolled`` (B,): the candidates a line search
    that rolls them in order and stops at its pick rolls in all."""
    B, H = u.shape[0], u.shape[1]
    nx, nu = prob.nx, prob.nu
    dev = x0.device
    x0, u, lam = (a.to(dtype) for a in (x0, u, lam))
    p = {k: v.to(dtype) for k, v in p.items()}
    u_min, u_max = cfg["u_min"].to(dtype), cfg["u_max"].to(dtype)
    w = cfg["barrier_weight"].to(dtype)
    dt = torch.as_tensor(cfg["dt"], dtype=dtype, device=dev)
    T = int(cfg["T"])
    n = min(T, H)
    ts = torch.arange(H, device=dev)
    alphas = torch.as_tensor(ALPHAS, dtype=dtype, device=dev)
    mu_step = mu_step.to(torch.int64).clamp(0, 7)

    def step(x, uu, t):
        return integrate(prob, x, uu, t, dt, p, integrator)

    def traj_cost(xs, us, lam_):
        cs = augmented_cost(prob, xs[..., :-1, :], us, ts, dt, p, lam_, w)
        return torch.sum(torch.where(ts < T, cs, 0.0), -1)

    def rollout(us):
        xs = [x0[:, None]]
        for t in range(H):
            xs.append(step(xs[-1], us[:, t, None], t) if t < T else xs[-1])
        return torch.cat(xs, 1)

    def fb_rollouts(xs_ref, us_ref, ks, Ks):
        A = len(alphas)
        x = xs_ref[:, 0, None].expand(B, A, nx)
        xs, us = [x], []
        for t in range(H):
            if t < T:
                uu = (us_ref[:, t, None] + alphas[:, None] * ks[:, t, None]
                      + (x - xs_ref[:, t, None]) @ Ks[:, t].mT)
                uu = torch.minimum(torch.maximum(uu, u_min[t]), u_max[t])
                x = step(x, uu, t)
            else:
                uu = us_ref[:, t, None].expand(B, A, nu)
            xs.append(x)
            us.append(uu)
        return torch.stack(xs, 2), torch.stack(us, 2)

    def backward(xs, us, lam_, mu):
        ks = torch.zeros((B, H, nu), dtype=dtype, device=dev)
        Ks = torch.zeros((B, H, nu, nx), dtype=dtype, device=dev)
        if n <= 0:
            return ks, Ks
        fx, fu, lx, lu, lxx, luu, lux = derivatives(
            prob, xs[:, :n], us[:, :n], ts[:n], dt, p, lam_[:, :n], w)
        Vx = torch.zeros((B, nx), dtype=dtype, device=dev)
        Vxx = torch.zeros((B, nx, nx), dtype=dtype, device=dev)
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        for t in range(n - 1, -1, -1):
            fx_t, fu_t = fx[:, t], fu[:, t]
            Qx = lx[:, t] + mv(fx_t.mT, Vx)
            Qu = lu[:, t] + mv(fu_t.mT, Vx)
            Qxx = lxx[:, t] + fx_t.mT @ Vxx @ fx_t
            Quu = luu[:, t] + fu_t.mT @ Vxx @ fu_t
            Qux = lux[:, t] + fu_t.mT @ Vxx @ fx_t
            k, K = _solve_action(Quu, Qu, Qux, mu, nu)
            c = us[:, t] + k
            over = c > u_max[t]
            under = c < u_min[t]
            k = torch.where(over, u_max[t] - us[:, t], k)
            k = torch.where(under, u_min[t] - us[:, t], k)
            K = torch.where((over | under)[..., None], 0.0, K)
            KQux = K.mT @ Qux
            Vxx = Qxx + KQux + KQux.mT + K.mT @ Quu @ K
            Vx = mv(K.mT @ Quu, k) + mv(K.mT, Qu) + mv(Qux.mT, k) + Qx
            ks[:, t] = k
            Ks[:, t] = K
        return ks, Ks

    xs = rollout(u)
    traj_costs = traj_cost(xs, u, lam)
    cs = constraints(prob, xs[:, :-1], u, ts, dt, p)
    lam_new = torch.minimum(torch.clamp(lam + w * cs, min=0.0),
                            cfg["lg_mult_limit"].to(dtype))
    lam = torch.where((ts < T)[:, None], lam_new, lam)

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iterations = torch.zeros(B, dtype=torch.int64, device=dev)
    rolled = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    min_rel = float(cfg["min_rel_cost_change"])
    it = 0
    while it < int(cfg["max_iterations"]) and not bool(done.all()):
        mu = torch.where(mu_step == 0, 0.0,
                         10.0 ** (mu_step.to(dtype) - 1.0)).to(dtype)
        ks, Ks = backward(xs, u, lam, mu)
        xs8, us8 = fb_rollouts(xs, u, ks, Ks)
        costs8 = traj_cost(xs8, us8, lam[:, None])
        improving = ((costs8 < traj_costs[:, None]) & torch.isfinite(costs8)
                     & (costs8 >= 0.0))
        found = improving.any(1)
        idx = improving.to(torch.int8).argmax(1)
        rolled += torch.where(done, 0, torch.where(found, idx + 1,
                                                   len(alphas)))
        sel = found & ~done
        xs = torch.where(sel[:, None, None], xs8[rows, idx], xs)
        u = torch.where(sel[:, None, None], us8[rows, idx], u)
        costs_new = torch.where(sel, costs8[rows, idx], traj_costs)
        mu_step = torch.where(done, mu_step, torch.where(
            found, torch.clamp(mu_step - 1, min=0),
            torch.clamp(mu_step + 1, max=7)))
        denom = torch.where(costs_new == 0.0, 1.0, costs_new)
        rel = torch.abs(costs_new - traj_costs) / denom
        iterations += (~done).to(torch.int64)
        done = done | (rel < min_rel)
        traj_costs = costs_new
        it += 1
    return dict(x=xs, u=u, lam=lam, mu_step=mu_step, traj_costs=traj_costs,
                iterations=iterations, rolled=rolled)


def solve_scenarios(prob, cfg, scen, rows, dtype):
    """The solve of the scenarios ``rows`` of ``scen`` (a dict of ``x0``,
    ``u``, ``lam``, ``mu_step``, each scenario first, the ``scalars`` and
    the ``tables``, shared ``(n_ref,)`` or one a scenario) at the settings
    of the configuration ``cfg``, computed in ``dtype``."""
    dev = scen["x0"].device
    p = {k: torch.tensor(v, dtype=torch.float64, device=dev)
         for k, v in scen["scalars"].items()}
    p.update({k: v if v.dim() == 1 else v[rows]
              for k, v in scen["tables"].items()})
    return solve(prob, scen["x0"][rows], scen["u"][rows], scen["lam"][rows],
                 scen["mu_step"][rows], p,
                 common.limits(cfg, dev, torch.float64),
                 common.INTEGRATORS[cfg["integrator"]], dtype)


def _widest(a):
    v = float(a.max()) if a.numel() else 0.0
    return math.inf if math.isnan(v) else v


def gaps(program, reference):
    """The numbers the check holds an AL-iLQR solve to, for two dicts of
    ``x``, ``u``, ``lam``, ``mu_step``, ``traj_costs``, scenario first
    (a NaN or infinite output reads as an infinite gap):

    - ``solution_gap``: the widest gap of the solution, over every compared
      scenario and every entry of its states, controls and multipliers,
      each quantity's gap over its own scale (the largest magnitude the
      reference gives it over the compared scenarios, at least 1);
    - ``cost_gap``: the widest relative gap of a scenario's trajectory
      cost;
    - ``mu_step_differ``: the share of compared scenarios whose mu_step
      (the regularisation the next update starts from) differs.
    """
    sol = 0.0
    for name in ("x", "u", "lam"):
        p, r = program[name], reference[name].to(torch.float64)
        scale = max(float(r.abs().max()) if r.numel() else 0.0, 1.0)
        d = torch.nan_to_num((p - r).abs(), nan=math.inf) / scale
        sol = max(sol, _widest(d))
    c_p = program["traj_costs"]
    c_r = reference["traj_costs"].to(torch.float64)
    rel = (c_p - c_r).abs() / torch.clamp(c_r.abs(), min=1e-300)
    differ = program["mu_step"].to(torch.int64) != reference["mu_step"]
    return dict(solution_gap=sol,
                cost_gap=_widest(torch.nan_to_num(rel, nan=math.inf)),
                mu_step_differ=float(differ.to(torch.float64).mean()))
