"""
Batched AL-iLQR: B scenarios of one problem solved side by side.

The port of ``tpl_tpu/optim/batched.py``.  The call keeps that module's
public layout, the batch in the LAST dimension (x ``(H+1, nx, B)``, u
``(H, nu, B)``, lam ``(H, nc, B)``, mu_step ``(B,)``, x0 ``(nx, B)``), so
the two packages' tensors compare directly; inside, the batch leads
(``(B, H, nx)``), which is what the problem functions of
:mod:`tpl_tpu_torch.optim.problems` broadcast over.

On CUDA tensors ``trajectory_tracking_mpc`` launches the hand-written
kernel ``csrc/ilqr_tracking_mpc.cu``'s batched entry, a warp per scenario
(:func:`tpl_tpu_torch.optim.ilqr_tracking_mpc.update_batched`), in float64
and in float32.  The native problems of the generic kernel
(``trajectory_tracking_mpc_time``, ``ref_line_smoother_k``,
``ref_line_smoother_dk``, ``velocity_profile_time``, ``lateral_profile``,
``velocity_profile_space``), every sympy problem with a printed struct and
every other torch problem, traced at the first call
(:mod:`tpl_tpu_torch.optim.trace`, the params' kinds from their shapes: a
0-d value, or a ``(B,)`` one named in ``per_instance``, is a scalar, one of
1-D or more a table), launch ``csrc/ilqr_generic_body.cuh``
(:func:`tpl_tpu_torch.optim.ilqr_generic.update_batched`), float32 and
float64, EULER / HEUN / RK4: a block a scenario while the card holds every
scenario's block at once, else resident warps, a scenario a warp.  A
problem the tracer refuses raises on CUDA tensors
(:func:`no_batched_kernel_message` says why).
On CPU tensors the plain version below runs: generic in the problem,
float32 and float64, EULER / HEUN / RK4.

Algorithm semantics match :mod:`tpl_tpu_torch.optim.ilqr` (same AL update,
line search, mu schedule, termination), per scenario: each scenario has its
own ``mu_step`` and its own ``done`` flag, a finished scenario is frozen
while the others iterate, and the loop ends when all are done or at
``max_iterations``.  One AL round per update, as in the JAX module.

The line search rolls all candidates and takes the first improving one.
The kernel rolls them in order and stops at that one; the plain version
reports, as a statistic, how many candidates that order rolls
(``rolled=True``).
"""

import torch

import tpl_tpu_torch
from tpl_tpu_torch.optim import (ilqr, ilqr_generic, ilqr_tracking_mpc,
                                 trace)
from tpl_tpu_torch.optim.ilqr import EULER, HEUN, RK4  # noqa: F401


def no_batched_kernel_message(name, why):
    """Why a problem raises on CUDA tensors: what the tracer refused
    (``why``), and the problems that have a batched kernel."""
    have = ["trajectory_tracking_mpc"] + [
        n for n in ilqr_generic.NATIVE if n != "trajectory_tracking_mpc"]
    return (f"no batched kernel for problem {name!r}: the tracer refuses "
            f"it ({why}); on CUDA tensors the batch solves {', '.join(have)}"
            ", every sympy (genopt) problem with a generated struct and "
            "every torch problem the tracer takes")


def make_batched_update_fn(prob, horizon, batch, integrator=EULER,
                           dtype=torch.float32, per_instance=()):
    """Build ``update(x, u, lam, mu_step, x0, params, cfg)`` for a batch of
    ``batch`` scenarios; returns ``(xs, u, lam, mu_step, traj_costs)`` in
    the layout of the arguments (``traj_costs`` is ``(B,)``), and with
    ``iterations=True`` also the ``(B,)`` iteration counts.

    ``params`` maps names to tensors shared across the batch; a name listed
    in ``per_instance`` is a per-scenario scalar, passed as ``(B,)``.
    ``cfg`` is the base engine's (``ilqr.make_update_fn``) with ``u_min`` /
    ``u_max`` ``(H, nu)`` shared; ``T`` and ``max_iterations`` are host
    integers.  The tensors' device decides the route: CPU tensors take the
    plain version, CUDA tensors the kernel (or raise).
    ``update.reference`` is the plain version on any device; with
    ``rolled=True`` it also returns the ``(B,)`` candidates a line search
    that rolls them in order and stops at its pick rolls over the update,
    or with ``group=g`` the rounds of g candidates side by side it takes.
    """
    H, B = horizon, batch
    nx, nu = prob.nx, prob.nu
    nc = max(prob.nc, 1)
    per_instance = tuple(per_instance)
    if integrator not in (EULER, HEUN, RK4):
        raise ValueError(f"unknown integrator {integrator}")

    def step(x, u, t, dt, params):
        return ilqr._integrate(prob.dynamics, x, u, t, dt, params, integrator)

    def aug_cost(x, u, t, dt, params, lam, w):
        return ilqr.augmented_cost(prob, x, u, t, dt, params, lam, w)

    def end_cost(x, t, dt, params):
        if prob.end_cost is None:
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return prob.end_cost(x, t, dt, params)

    # Every evaluation below is shaped (B, K, n): K the steps of a
    # trajectory, the line-search candidates of a rollout step, or 1.

    def solve_action(Quu, Qu, Qux, mu):
        """Quu (B, nu, nu), Qu (B, nu), Qux (B, nu, nx), mu (B,)."""
        if nu == 1:
            quu = Quu[:, 0, 0]
            inv = torch.where(quu > 0.0, -1.0 / (quu + mu),
                              torch.zeros_like(quu))
            return inv[:, None] * Qu, inv[:, None, None] * Qux
        if nu == 2:
            a = Quu[:, 0, 0] + mu
            b = Quu[:, 0, 1]
            d = Quu[:, 1, 1] + mu
            det = a * d - b * b
            inv_det = -1.0 / det
            inv = torch.stack([torch.stack([d, -b], -1),
                               torch.stack([-b, a], -1)], -2) \
                * inv_det[:, None, None]
            return (inv @ Qu[..., None])[..., 0], inv @ Qux
        reg = Quu + mu[:, None, None] * torch.eye(nu, dtype=Quu.dtype,
                                                  device=Quu.device)
        sol = torch.linalg.solve(reg, torch.cat([Qu[..., None], Qux], -1))
        return -sol[..., 0], -sol[..., 1:]

    def rollout(x0, us, dt, T, params):
        """Open-loop rollout of (B, nx) starts; frozen beyond T."""
        xs = [x0[:, None]]
        for t in range(H):
            xs.append(step(xs[-1], us[:, t, None], t, dt, params)
                      if t < T else xs[-1])
        return torch.cat(xs, 1)

    def traj_cost(xs, us, ts, dt, T, params, lam, w):
        """(B, ..., H+1, nx) trajectories -> (B, ...) costs."""
        cs = aug_cost(xs[..., :-1, :], us, ts, dt, params, lam, w)
        c = torch.sum(torch.where(ts < T, cs, 0.0), -1)
        return c + end_cost(xs[..., min(max(T, 0), H), :], T, dt, params)

    def fb_rollouts(alphas, xs_ref, us_ref, ks, Ks, u_min, u_max, dt, T,
                    params):
        """The closed-loop rollouts of every scenario at every alpha:
        (B, A, H+1, nx) and (B, A, H, nu)."""
        A = len(alphas)
        x = xs_ref[:, 0, None].expand(B, A, nx)
        xs, us = [x], []
        for t in range(H):
            if t < T:
                u = (us_ref[:, t, None] + alphas[:, None] * ks[:, t, None]
                     + (x - xs_ref[:, t, None]) @ Ks[:, t].mT)
                u = torch.minimum(torch.maximum(u, u_min[t]), u_max[t])
                x = step(x, u, t, dt, params)
            else:
                u = us_ref[:, t, None].expand(B, A, nu)
            xs.append(x)
            us.append(u)
        return torch.stack(xs, 2), torch.stack(us, 2)

    def end_derivatives(xT, T, dt, params):
        """Vx (B, nx) and Vxx (B, nx, nx) of the end cost at xT (B, nx)."""
        with torch.enable_grad():
            z = xT[:, None].detach().requires_grad_()
            e = end_cost(z, T, dt, params)
            g, = torch.autograd.grad(e.sum(), z, create_graph=True)
            basis = torch.eye(nx, dtype=z.dtype, device=z.device)
            hess, = torch.autograd.grad(
                g, z, basis[:, None, None].expand(nx, B, 1, nx),
                is_grads_batched=True)
        return g.detach()[:, 0], hess.detach().movedim(0, -2)[:, 0]

    def backward(xs, us, lam, w, u_min, u_max, dt, T, params, mu, ts):
        ks = torch.zeros((B, H, nu), dtype=xs.dtype, device=xs.device)
        Ks = torch.zeros((B, H, nu, nx), dtype=xs.dtype, device=xs.device)
        n = min(T, H)
        if n <= 0:
            return ks, Ks
        fx, fu, lx, lu, lxx, luu, lux = ilqr.derivatives(
            prob, xs[:, :n], us[:, :n], ts[:n], dt, params, lam[:, :n], w)

        Vx = torch.zeros((B, nx), dtype=xs.dtype, device=xs.device)
        Vxx = torch.zeros((B, nx, nx), dtype=xs.dtype, device=xs.device)
        if T <= H and prob.end_cost is not None:
            Vx, Vxx = end_derivatives(xs[:, T], T, dt, params)
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        for t in range(n - 1, -1, -1):
            fx_t, fu_t = fx[:, t], fu[:, t]
            Qx = lx[:, t] + mv(fx_t.mT, Vx)
            Qu = lu[:, t] + mv(fu_t.mT, Vx)
            Qxx = lxx[:, t] + fx_t.mT @ Vxx @ fx_t
            Quu = luu[:, t] + fu_t.mT @ Vxx @ fu_t
            Qux = lux[:, t] + fu_t.mT @ Vxx @ fx_t

            k, K = solve_action(Quu, Qu, Qux, mu)

            c = us[:, t] + k
            over = c > u_max[t]
            under = c < u_min[t]
            k = torch.where(over, u_max[t] - us[:, t], k)
            k = torch.where(under, u_min[t] - us[:, t], k)
            K = torch.where((over | under)[..., None], 0.0, K)

            KQux = K.mT @ Qux
            Vxx = Qxx + KQux + KQux.mT + K.mT @ Quu @ K
            Vx = (mv(K.mT @ Quu, k) + mv(K.mT, Qu) + mv(Qux.mT, k) + Qx)
            ks[:, t] = k
            Ks[:, t] = K
        return ks, Ks

    def plain(x, u, lam, mu_step, x0, params, params8, cfg, group=1):
        """The update on batch-leading tensors; ``params8`` are the params
        for the (B, A, H) evaluation of the line search's costs; ``group``
        the candidates a round of the counted search rolls."""
        u_min, u_max = cfg["u_min"], cfg["u_max"]
        w = cfg["barrier_weight"]
        dt, T = cfg["dt"], int(cfg["T"])
        dev = x0.device
        ts = torch.arange(H, device=dev)
        alphas = torch.as_tensor(ilqr.ALPHAS, dtype=dtype, device=dev)

        # initial rollout with the current controls and the OLD multipliers
        xs = rollout(x0, u, dt, T, params)
        traj_costs = traj_cost(xs, u, ts, dt, T, params, lam, w)

        # clipped multiplier update on the active steps
        cs = ilqr.constraints(prob, xs[:, :-1], u, ts, dt, params)
        lam_new = torch.minimum(torch.clamp(lam + w * cs, min=0.0),
                                cfg["lg_mult_limit"])
        lam = torch.where((ts < T)[:, None], lam_new, lam)

        done = torch.zeros(B, dtype=torch.bool, device=dev)
        iterations = torch.zeros(B, dtype=torch.int64, device=dev)
        rolled = torch.zeros(B, dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)
        it = 0
        while it < int(cfg["max_iterations"]) and not bool(done.all()):
            mu = torch.where(mu_step == 0, 0.0,
                             10.0 ** (mu_step.to(dtype) - 1.0)).to(dtype)
            ks, Ks = backward(xs, u, lam, w, u_min, u_max, dt, T, params, mu,
                              ts)
            xs8, us8 = fb_rollouts(alphas, xs, u, ks, Ks, u_min, u_max, dt,
                                   T, params)
            costs8 = traj_cost(xs8, us8, ts, dt, T, params8, lam[:, None], w)

            improving = ((costs8 < traj_costs[:, None])
                         & torch.isfinite(costs8) & (costs8 >= 0.0))
            found = improving.any(1)
            idx = improving.to(torch.int8).argmax(1)   # the first that does
            rolled += torch.where(done, 0, torch.where(
                found, idx // group + 1, -(-len(alphas) // group)))

            sel = found & ~done
            xs = torch.where(sel[:, None, None], xs8[rows, idx], xs)
            u = torch.where(sel[:, None, None], us8[rows, idx], u)
            costs_new = torch.where(sel, costs8[rows, idx], traj_costs)
            mu_step = torch.where(done, mu_step, torch.where(
                found, torch.clamp(mu_step - 1, min=0),
                torch.clamp(mu_step + 1, max=7)))

            denom = torch.where(costs_new == 0.0, 1.0, costs_new)
            rel = torch.abs(costs_new - traj_costs) / denom
            iterations = iterations + (~done).to(torch.int64)
            done = done | (rel < cfg["min_rel_cost_change"])
            traj_costs = costs_new
            it += 1
        return xs, u, lam, mu_step, traj_costs, iterations, rolled

    def check(x, u, lam, mu_step, x0, cfg):
        if int(cfg.get("max_lg_iterations", 1)) != 1:
            raise ValueError("the batched update runs one multiplier round")
        for name, a, shape in (("x", x, (H + 1, nx, B)), ("u", u, (H, nu, B)),
                               ("lam", lam, (H, nc, B)),
                               ("mu_step", mu_step, (B,)),
                               ("x0", x0, (nx, B))):
            if tuple(a.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(a.shape)}")
        devices = {a.device.type for a in (x, u, lam, mu_step, x0)}
        if len(devices) != 1:
            raise ValueError(f"the state lies on several devices: {devices}")
        return devices.pop()

    def reference(x, u, lam, mu_step, x0, params, cfg, iterations=False,
                  rolled=False, group=1):
        """The plain version, on whatever device the tensors lie."""
        check(x, u, lam, mu_step, x0, cfg)
        lead = lambda a: a.to(dtype).movedim(-1, 0)
        p = {k: (v.to(dtype).reshape(B, 1) if k in per_instance else v)
             for k, v in params.items()}
        p8 = {k: (v[..., None] if k in per_instance else v)
              for k, v in p.items()}
        xs, un, ln, ms, costs, its, n_rolled = plain(
            lead(x), lead(u), lead(lam), mu_step.to(torch.int64),
            x0.to(dtype).T, p, p8, cfg, group)
        out = (xs.movedim(0, -1), un.movedim(0, -1), ln.movedim(0, -1),
               ms.to(mu_step.dtype), costs)
        return (out + ((its,) if iterations else ())
                + ((n_rolled,) if rolled else ()))

    def update(x, u, lam, mu_step, x0, params, cfg, iterations=False):
        kind = check(x, u, lam, mu_step, x0, cfg)
        if kind == "cpu":
            return reference(x, u, lam, mu_step, x0, params, cfg, iterations)
        if kind != "cuda":
            raise ValueError(f"unsupported device {kind}")
        if prob.kernel == "trajectory_tracking_mpc":
            out = ilqr_tracking_mpc.update_batched(
                x, u, lam, mu_step, x0, params, cfg, integrator, dtype)
        else:
            try:
                spec = ilqr_generic.spec_of(
                    prob, trace.kinds_of_params(params, per_instance))
            except trace.Untraceable as e:
                raise NotImplementedError(no_batched_kernel_message(
                    prob.name, e)) from e
            out = ilqr_generic.update_batched(
                spec, x, u, lam, mu_step, x0, params, cfg, integrator, dtype,
                per_instance)
        return out if iterations else out[:5]

    update.reference = reference
    return update


def init_batch(prob, horizon, batch, dtype=torch.float32, device=None):
    """Zero ``(x, u, lam, mu_step)`` of a batch in the public layout, on
    ``tpl_tpu_torch.device()`` unless a device is given."""
    dev = tpl_tpu_torch.device() if device is None else torch.device(device)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    return (z(horizon + 1, prob.nx, batch), z(horizon, prob.nu, batch),
            z(horizon, max(prob.nc, 1), batch),
            torch.zeros(batch, dtype=torch.int32, device=dev))
