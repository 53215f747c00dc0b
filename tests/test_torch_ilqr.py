"""The iLQR core of the port against the JAX package, float64, on the CPU.

- the torch table lookups and their genopt-parity slopes;
- every problem factory: dynamics, cost, constraints and the seven
  backward-pass derivative blocks at seeded random points, including
  progress queries exactly on a grid point and beyond the table's ends;
- ``make_update_fn`` on the ``__graft_entry__._mpc_setup`` inputs (H=60,
  8 and 20 iterations), also through the tracking-MPC kernel wrapper's
  plain path;
- ports of tests/test_ilqr.py's checks (LQR oracle, control limits,
  horizon masking, ``shift``), the ``Solver`` on the two RSTP problems, and
  ``rollforward_deadtime`` with a nonzero dead time.

Tolerances (float64 on both sides, rounding-level differences only):
values and derivatives rtol=1e-9 with atol 1e-9 scaled by the block's
magnitude; one solve x, u atol=1e-6, traj_costs rtol=1e-9, mu_step equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpl_tpu.ops import interp as j_interp
from tpl_tpu.optim import problems as j_problems
from tpl_tpu.optim import solver as j_solver
from tpl_tpu.optim.ilqr import _AL_ZERO

import tpl_tpu_torch
from tpl_tpu_torch.ops import interp as t_interp
from tpl_tpu_torch.optim import ilqr, ilqr_tracking_mpc, problems, solver

X_ATOL = 1e-6
COST_RTOL = 1e-9
DERIV_RTOL = 1e-9

FACTORIES = ("trajectory_tracking_mpc", "trajectory_tracking_mpc_time",
             "lateral_profile", "velocity_profile_space",
             "velocity_profile_time", "ref_line_smoother_k",
             "ref_line_smoother_dk")


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# ---------------------------------------------------------------------
# lookups


LOOKUPS = ("lerp", "lerp_angle", "lerp_multi", "box_interp")


@pytest.mark.parametrize("name", LOOKUPS)
def test_lookup_values_and_slopes(name):
    """Values and query slopes against the JAX package's custom JVPs:
    slope v1 - v0 inside a cell, zero exactly on a grid point and beyond
    the ends, zero curvature; box_interp has a zero slope.  Both torch
    autograd and torch.func give these slopes."""
    rng = np.random.default_rng(3)
    n, dx = 9, 0.5
    table = rng.uniform(-3.0, 3.0, n)
    if name == "lerp_multi":
        table = rng.uniform(-3.0, 3.0, (n, 3))
    qs = np.array([-1.3, -0.5, 0.0, 0.2, 1.0, 1.75, 2.5, 3.0, 3.9, 4.0,
                   4.2, 6.0])

    def j_fn(q):
        if name == "box_interp":
            return j_interp.box_interp(dx, q, jnp.asarray(table))
        return getattr(j_interp, name)(0.0, dx, q, jnp.asarray(table))

    def t_fn(q):
        if name == "box_interp":
            return t_interp.box_interp(_t(dx), q, _t(table))
        return getattr(t_interp, name)(0.0, _t(dx), q, _t(table))

    for q in qs:
        j_val = np.asarray(j_fn(jnp.float64(q)))
        j_slope = np.asarray(jax.jacfwd(j_fn)(jnp.float64(q)))
        qt = _t(q)
        np.testing.assert_allclose(t_fn(qt).numpy(), j_val, rtol=1e-14,
                                   atol=1e-14, err_msg=f"value at {q}")
        slope_func = torch.func.jacfwd(t_fn)(qt).numpy()
        np.testing.assert_allclose(slope_func, j_slope, rtol=1e-14,
                                   atol=1e-14, err_msg=f"slope at {q}")
        qa = _t(q).requires_grad_()
        out = t_fn(qa).sum()
        if out.requires_grad:
            slope_ag, = torch.autograd.grad(out, qa, create_graph=True)
            np.testing.assert_allclose(slope_ag.detach().numpy(),
                                       np.sum(j_slope), rtol=1e-14,
                                       atol=1e-14)
            if slope_ag.requires_grad:
                curv, = torch.autograd.grad(slope_ag, qa, allow_unused=True)
                assert curv is None or float(curv) == 0.0
        else:                 # box_interp: the query carries no gradient
            assert name == "box_interp"
        curv_func = torch.func.jacfwd(torch.func.jacfwd(t_fn))(qt)
        assert torch.all(curv_func == 0.0)
        if name == "box_interp" or q in (-1.3, -0.5, 0.0, 1.0, 3.0, 4.0,
                                         4.2, 6.0):
            # on a grid point (q / dx integral), below 0 or beyond the end
            assert np.all(j_slope == 0.0) and np.all(slope_func == 0.0), q


# ---------------------------------------------------------------------
# problems


def _params(name, spec, rng):
    """Seeded params by spec: scalars in [0.5, 2], tables smooth-ish."""
    p = {}
    for k, s in spec.items():
        if hasattr(s, "capacity"):
            n = s.capacity
            base = np.cumsum(rng.normal(0.0, 0.2, n))
            if k in ("ref_phi",):
                base = np.mod(base * 3.0 + np.pi, 2 * np.pi) - np.pi
            elif k in ("ref_v", "ref_t_offset", "ref_v_weight"):
                base = 5.0 + np.abs(base)
            elif k in ("ref_k", "k_ref"):
                base = 0.05 * np.sin(base)
            p[k] = base
        else:
            p[k] = float(rng.uniform(0.5, 2.0))
    for k in ("ref_step", "ref_dt"):
        if k in p:
            p[k] = 0.5
    if "min_acc" in p:
        p["min_acc"] = -p["min_acc"]
    return p


def _points(name, prob, spec, rng, n=24):
    x = rng.normal(0.0, 0.5, (n, prob.nx))
    u = rng.normal(0.0, 0.5, (n, prob.nu))
    t = rng.integers(0, 40, n)
    if name == "trajectory_tracking_mpc":
        cap = spec["ref_x"].capacity
        x[:, 4] = rng.uniform(2.0, 12.0, n)              # v
        # progress s_r: on grid points, inside cells, beyond both ends
        x[:, 5] = np.concatenate([
            np.arange(8) * 0.5, rng.uniform(0.0, 60.0, 8),
            [-3.0, -0.2, (cap - 1) * 0.5, cap * 0.5 + 4.0,
             (cap - 1) * 0.5 + 0.25, 10.0, 20.5, 31.0]])[:n]
    elif name == "trajectory_tracking_mpc_time":
        x[:, 4] = rng.uniform(2.0, 12.0, n)
    elif name == "velocity_profile_space":
        x[:, 0] = np.concatenate([rng.uniform(0.2, 0.99, 6),
                                  rng.uniform(1.1, 12.0, n - 6)])
    elif name == "velocity_profile_time":
        x[:, 0] = np.concatenate([np.arange(6) * 0.5,
                                  rng.uniform(-2.0, 200.0, n - 6)])
    nc = max(prob.nc, 1)
    lam = rng.uniform(0.0, 2.0, (n, nc)) * (rng.uniform(size=(n, nc)) < 0.5)
    w = rng.uniform(10.0, 100.0, nc)
    return x, u, t, lam, w


def _jax_derivs(prob, x, u, t, dt, p, lam, w):
    """The JAX package's derivs_one (ilqr.py:165-180), vmapped."""
    nx = prob.nx
    has_con = prob.constraints is not None and prob.nc > 0

    def aug(x_, u_, t_, l_):
        c = prob.cost(x_, u_, t_, dt, p)
        if has_con:
            g = prob.constraints(x_, u_, t_, dt, p)
            inactive = (g < 0.0) & (jnp.abs(l_) < _AL_ZERO)
            c = c + jnp.sum(g * l_)
            c = c + jnp.sum(jnp.where(inactive, 0.0, w * g * g))
        return c

    def one(x_, u_, t_, l_):
        jx = jax.jacfwd(lambda a: prob.dynamics(a, u_, t_, dt, p))(x_)
        ju = jax.jacfwd(lambda b: prob.dynamics(x_, b, t_, dt, p))(u_)
        fx = jnp.eye(nx) + dt * jx
        fu = dt * ju
        ca = lambda a, b: aug(a, b, t_, l_)
        return (fx, fu, jax.grad(ca, 0)(x_, u_), jax.grad(ca, 1)(x_, u_),
                jax.jacfwd(jax.grad(ca, 0), 0)(x_, u_),
                jax.jacfwd(jax.grad(ca, 1), 1)(x_, u_),
                jax.jacfwd(jax.grad(ca, 1), 0)(x_, u_), aug(x_, u_, t_, l_))

    return jax.jit(jax.vmap(one))(x, u, t, lam)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=DERIV_RTOL,
                               atol=DERIV_RTOL * scale, err_msg=what)


@pytest.mark.parametrize("name", FACTORIES)
def test_problem_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    jprob, jspec = getattr(j_problems, name)()
    tprob, tspec = getattr(problems, name)()
    assert (tprob.nx, tprob.nu, tprob.nc) == (jprob.nx, jprob.nu, jprob.nc)
    assert list(tspec) == list(jspec)
    p = _params(name, jspec, rng)
    x, u, t, lam, w = _points(name, jprob, jspec, rng)
    dt = 0.05
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}

    jf = jax.jit(jax.vmap(lambda a, b, c: jprob.dynamics(a, b, c, dt, jp)))(
        x, u, t)
    tf = tprob.dynamics(_t(x), _t(u), torch.as_tensor(t), _t(dt), tp)
    _close(tf.numpy(), jf, "dynamics")
    jc = jax.jit(jax.vmap(lambda a, b, c: jprob.cost(a, b, c, dt, jp)))(
        x, u, t)
    tc = tprob.cost(_t(x), _t(u), torch.as_tensor(t), _t(dt), tp)
    _close(tc.numpy(), jc, "cost")
    if jprob.constraints is not None:
        jg = jax.jit(jax.vmap(
            lambda a, b, c: jprob.constraints(a, b, c, dt, jp)))(x, u, t)
        tg = tprob.constraints(_t(x), _t(u), torch.as_tensor(t), _t(dt), tp)
        _close(tg.numpy(), jg, "constraints")
    if jprob.end_cost is not None:
        je = jax.jit(jax.vmap(lambda a, c: jprob.end_cost(a, c, dt, jp)))(
            x, t)
        te = tprob.end_cost(_t(x), torch.as_tensor(t), _t(dt), tp)
        _close(te.numpy(), je, "end_cost")

    want = _jax_derivs(jprob, jnp.asarray(x), jnp.asarray(u), jnp.asarray(t),
                       jnp.float64(dt), jp, jnp.asarray(lam), jnp.asarray(w))
    got = ilqr.derivatives(tprob, _t(x), _t(u), torch.as_tensor(t), _t(dt),
                           tp, _t(lam), _t(w))
    got += (ilqr.augmented_cost(tprob, _t(x), _t(u), torch.as_tensor(t),
                                _t(dt), tp, _t(lam), _t(w)),)
    for what, g, wv in zip(("fx", "fu", "lx", "lu", "lxx", "luu", "lux",
                            "aug_cost"), got, want):
        _close(g.numpy(), wv, what)


# ---------------------------------------------------------------------
# one solve


def _port_inputs(params, cfg):
    tp = {k: _t(np.asarray(v)) for k, v in params.items()}
    tc = {k: (int(v) if k in ("T", "max_iterations", "max_lg_iterations")
              else _t(np.asarray(v))) for k, v in cfg.items()}
    return tp, tc


@pytest.mark.parametrize("iterations", [8, 20])
def test_mpc_update_matches_jax(iterations):
    import __graft_entry__ as ge

    upd, st, x0, params, cfg = ge._mpc_setup(dtype=jnp.float64,
                                             max_iterations=iterations)
    j_state, j_info = jax.jit(upd)(st, x0, params, cfg)
    want = dict(x=np.asarray(j_state.x), u=np.asarray(j_state.u),
                lam=np.asarray(j_state.lam), mu=int(j_state.mu_step),
                cost=float(j_info["traj_costs"]))

    prob, _ = problems.trajectory_tracking_mpc(ref_capacity=128)
    update = ilqr.make_update_fn(prob, 60, ilqr.HEUN, torch.float64)
    tp, tc = _port_inputs(params, cfg)
    state = ilqr.init_state(prob, 60, torch.float64)
    new, info = update(state, _t(np.asarray(x0)), tp, tc)

    # the kernel wrapper's plain path, on the packed buffer
    x = np.zeros((61, 7))
    x[0] = np.asarray(x0)
    u_lims = np.stack([np.asarray(cfg["u_min"]), np.asarray(cfg["u_max"])],
                      -1)
    bw_lim = np.stack([np.asarray(cfg["barrier_weight"]),
                       np.asarray(cfg["lg_mult_limit"])], -1)
    host = ilqr_tracking_mpc.pack_inputs(
        dict(x=x, u=np.zeros((60, 2)), lam=np.zeros((60, 4)), u_lims=u_lims,
             bw_lim=bw_lim, cfg_f=np.array([0.05, 1e-6])),
        {k: np.asarray(v) for k, v in params.items()})
    before = ilqr_tracking_mpc.launches
    packed = ilqr_tracking_mpc.unpack_outputs(ilqr_tracking_mpc.update(
        torch.from_numpy(host), 60, 128, 60, iterations, 1, 0).numpy(), 60)
    assert ilqr_tracking_mpc.launches == before      # CPU: plain version

    for got in (dict(x=new.x.numpy(), u=new.u.numpy(), lam=new.lam.numpy(),
                     mu=new.mu_step, cost=float(info["traj_costs"])),
                dict(x=packed["x"], u=packed["u"], lam=packed["lam"],
                     mu=packed["mu_step"], cost=packed["traj_costs"])):
        np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(got["lam"], want["lam"], rtol=0,
                                   atol=X_ATOL)
        np.testing.assert_allclose(got["cost"], want["cost"],
                                   rtol=COST_RTOL)
        assert got["mu"] == want["mu"]
    assert packed["iterations"] == info["iterations"] <= iterations


# ---------------------------------------------------------------------
# ports of tests/test_ilqr.py

DT = 0.1
H = 40


def lqr_oracle(A, B, Q, R, x0, T):
    """Finite-horizon discrete LQR via plain Riccati recursion (numpy)."""
    P = Q.copy()
    Ks = []
    for _ in range(T):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ (A - B @ K)
        Ks.append(K)
    Ks = Ks[::-1]
    xs = [x0]
    us = []
    for t in range(T):
        u = -Ks[t] @ xs[-1]
        us.append(u)
        xs.append(A @ xs[-1] + B @ u)
    return np.array(xs), np.array(us)


def _double_integrator():
    def dynamics(x, u, t, dt, p):
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)

    def cost(x, u, t, dt, p):
        return (1.0 * x[..., 0] ** 2 + 0.1 * x[..., 1] ** 2
                + 0.01 * u[..., 0] ** 2)

    return ilqr.Problem("di", nx=2, nu=1, nc=0, dynamics=dynamics, cost=cost)


def _cfg(T=H, max_iter=50, u_lim=1e30):
    return dict(u_min=torch.full((H, 1), -u_lim, dtype=torch.float64),
                u_max=torch.full((H, 1), u_lim, dtype=torch.float64),
                barrier_weight=torch.ones(1, dtype=torch.float64),
                lg_mult_limit=torch.full((1,), 1e30, dtype=torch.float64),
                dt=_t(DT), T=T, max_iterations=max_iter,
                max_lg_iterations=1, min_rel_cost_change=_t(1e-12))


def _solve(x0, **cfg):
    prob = _double_integrator()
    update = ilqr.make_update_fn(prob, H, dtype=torch.float64)
    state, _ = update(ilqr.init_state(prob, H, torch.float64), _t(x0), {},
                      _cfg(**cfg))
    return state


def test_matches_lqr_oracle():
    state = _solve([2.0, -1.0])
    A = np.array([[1.0, DT], [0.0, 1.0]])
    B = np.array([[0.0], [DT]])
    xs_gt, us_gt = lqr_oracle(A, B, np.diag([1.0, 0.1]), np.array([[0.01]]),
                              np.array([2.0, -1.0]), H)
    np.testing.assert_allclose(state.u.numpy()[:20, 0], us_gt[:20, 0],
                               rtol=0.05, atol=0.05)
    assert abs(state.x.numpy()[-1, 0]) < 0.05


def test_control_limits_respected():
    state = _solve([5.0, 0.0], u_lim=0.5)
    assert np.max(np.abs(state.u.numpy())) <= 0.5 + 1e-9


def test_active_horizon_masking():
    T = 25
    state = _solve([1.0, 0.0], T=T)
    u = state.u.numpy()
    np.testing.assert_array_equal(u[T:], 0.0)
    assert np.any(u[:T] != 0.0)
    x = state.x.numpy()
    np.testing.assert_array_equal(x[T + 1:], np.repeat(x[T:T + 1], H - T, 0))


def test_solver_shift():
    prob, spec = problems.ref_line_smoother_k()
    s = solver.Solver(prob, spec, horizon_max=10)
    s.horizon = 10
    s.x = np.arange(11 * 3).reshape(11, 3).astype(float)
    s.u = np.arange(10).reshape(10, 1).astype(float)
    s.lagrange_multiplier = np.arange(10).astype(float)
    s.shift(3)
    assert s.x[0, 0] == 9.0       # x[3]
    assert s.x[8, 0] == 30.0      # x[10] (clamped at T)
    assert s.u[0, 0] == 3.0
    assert s.u[9, 0] == 9.0       # clamped at T-1
    assert s.lagrange_multiplier[9, 0] == 9.0


# ---------------------------------------------------------------------
# the Solver, port vs JAX


def _rstp_setup(name, s):
    """tests/test_ilqr.py's lateral / velocity profile configurations."""
    s.horizon = 100
    s.step = 0.5
    s.barrier_weight[:] = 1000.0
    s.u_min[:] = -2.5
    s.u_max[:] = 2.5
    s.params.ref_step = 0.5
    if name == "lateral_profile":
        s.max_iterations = 30
        # one AL round: with lg_mult_limit 0 the multipliers stay 0, and a
        # second round re-solves a converged problem, where a line-search
        # acceptance (and so mu_step) is decided by the last bit of rounding
        s.max_lg_iterations = 1
        s.lg_mult_limit = 0.0
        s.params.k_ref = 0.01 * np.sin(np.arange(100) * 0.1)
        s.params.d_offset = np.zeros(100)
        lower = np.full(100, -2.0)
        lower[40:60] = 1.0
        s.params.d_lower_constr = lower
        s.params.d_upper_constr = np.full(100, 2.0)
        s.x[0] = [0.0, 0.0]
    else:
        s.max_iterations = 20
        s.lg_mult_limit = 0.1
        v_ref = np.full(100, 10.0)
        v_ref[60:] = 3.0
        s.params.ref_v = v_ref
        s.params.ref_k = np.zeros(100)
        s.params.ref_t_max = np.full(100, 1e10)
        s.params.ref_t_min = np.zeros(100)
        s.params.ref_t_offset = np.ones(100)
        s.params.ref_v_weight = np.ones(100)
        s.x[0] = [5.0, 0.0]


@pytest.mark.parametrize("name", ["lateral_profile", "velocity_profile_space"])
def test_solver_matches_jax(name):
    jprob, jspec = getattr(j_problems, name)(ref_capacity=128)
    tprob, tspec = getattr(problems, name)(ref_capacity=128)
    js = j_solver.Solver(jprob, jspec, horizon_max=100, dtype=jnp.float64)
    ts = solver.Solver(tprob, tspec, horizon_max=100, dtype=torch.float64)
    for s in (js, ts):
        _rstp_setup(name, s)
    for tick in range(2):       # a cold and a warm-started update
        js.update()
        ts.update()
        np.testing.assert_allclose(ts.x, js.x, rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=X_ATOL)
        np.testing.assert_allclose(ts.lagrange_multiplier,
                                   js.lagrange_multiplier, rtol=0,
                                   atol=X_ATOL)
        np.testing.assert_allclose(ts.traj_costs, js.traj_costs,
                                   rtol=COST_RTOL)
        assert ts._mu_step == js._mu_step
        js.shift(1)
        ts.shift(1)


def _demo_mpc_solver(pkg_solver, pkg_problems, dtype):
    prob, spec = pkg_problems.trajectory_tracking_mpc(ref_capacity=128)
    s = pkg_solver.Solver(prob, spec, horizon_max=60, dtype=dtype)
    s.integrator_type = s.HEUN
    s.params.l = 3.165
    s.params.v_ch = 32.0
    s.params.a_offset = 0.3
    return s


def test_rollforward_deadtime_matches_jax():
    js = _demo_mpc_solver(j_solver, j_problems, jnp.float64)
    ts = _demo_mpc_solver(solver, problems, torch.float64)
    rng = np.random.default_rng(7)
    x0 = np.array([1.0, -0.5, 0.2, 0.05, 8.0, 0.0, 0.4])
    cmds = rng.normal(0.0, 0.3, (12, 2))
    valid = np.arange(12) >= 3           # front-padded window
    want = js.rollforward_deadtime(x0, cmds, valid, 3, 6, 0.01)
    got = ts.rollforward_deadtime(x0, cmds, valid, 3, 6, 0.01)
    assert got.shape == (13, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[:4], np.repeat(x0[None], 4, 0))
    np.testing.assert_allclose(ts.dynamics(x0, cmds[0], 0, 0.05),
                               js.dynamics(x0, cmds[0], 0, 0.05),
                               rtol=0, atol=1e-12)


def test_load_state_carries_a_warm_start():
    """A JAX solver's state and params, loaded into the port's Solver,
    give the same next update."""
    js = _demo_mpc_solver(j_solver, j_problems, jnp.float64)
    ts = _demo_mpc_solver(solver, problems, torch.float64)
    ss = np.arange(128) * 0.5
    for s in (js, ts):
        s.horizon = 60
        s.max_iterations = 20
        s.barrier_weight[:] = 1e4
        s.lg_mult_limit = 0.0
        s.u_min[:] = [-3.0, -1.0]
        s.u_max[:] = [1.5, 1.0]
        s.params.ref_x = ss
        s.params.ref_y = 0.5 * np.sin(ss * 0.15)
        s.params.ref_phi = np.arctan(0.075 * np.cos(ss * 0.15))
        s.params.ref_v = np.full(128, 9.0)
        s.params.pd, s.params.pv, s.params.pj = 10.0, 5.0, 0.5
    js.x[0] = [0.0, 0.3, 0.0, 0.0, 7.0, 0.0, 0.0]
    js.update()
    js.shift(1)
    js.x[0] = js.x[0] + np.array([0.01, -0.02, 0.0, 0.0, 0.05, 0.0, 0.0])
    ts.load_state(js._x, js._u, js._lam, js._mu_step,
                  params=dict(js.params._values))
    js.update()
    ts.update()
    np.testing.assert_allclose(ts.x, js.x, rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(ts.traj_costs, js.traj_costs, rtol=COST_RTOL)
    assert ts._mu_step == js._mu_step


def test_kernel_wrapper_rejects_bad_inputs():
    """The tracking-MPC wrapper checks what it hands the kernel (on the
    CPU the same checks run before the plain version)."""
    H, n_ref = 60, 128
    _, n = ilqr.layout(ilqr_tracking_mpc.input_layout(H, n_ref))
    good = torch.zeros(n, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64 vector"):
        ilqr_tracking_mpc.update(good[:-1], H, n_ref, H, 1, 1, 0)
    with pytest.raises(ValueError, match="float64 vector"):
        ilqr_tracking_mpc.update(good.float(), H, n_ref, H, 1, 1, 0)
    with pytest.raises(ValueError, match="mu_step"):
        ilqr_tracking_mpc.update(good, H, n_ref, H, 1, 1, 8)
    with pytest.raises(ValueError, match="integrator"):
        ilqr_tracking_mpc.update(good, H, n_ref, H, 1, 1, 0, integrator=3)
