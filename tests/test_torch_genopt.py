"""The port's sympy front end (``tpl_tpu_torch.optim.genopt``, ``symext``,
``optimizers`` and ``ops.interp.blerp``) against the JAX package's, float64,
on the CPU: the counterparts of tests/test_genopt.py, and the torch
printer's faults.

- the sympy tracking-MPC config's dynamics, cost, constraints and cost
  gradient against JAX ``genopt.make_problem`` on the same inputs, and
  against the port's native problem (rtol = atol = 1e-12; the gradient
  through ``fixed(s_r)`` included);
- ``genopt.build(mpc_config())()`` solved beside the port's native
  tracking MPC, float32 solvers on the CPU (rtol 1e-4, x atol 1e-6, u atol
  1e-5: the JAX test's own tolerance; the two programs order their lookups
  differently);
- ``lerp_wrap`` against the JAX oracle and the numpy oracle (1e-12),
  ``get_array_value`` and ``blerp`` against the JAX ones (1e-12);
- ``fixed`` blocking a gradient, an unknown symbol rejected, duplicate and
  reserved names rejected;
- ``Max`` / ``Min`` with a constant, ``atan2`` of a constant, ``Piecewise``
  and a constant cost and constraint term, which the torch printer turns
  into calls that take no Python number or into Python numbers, against the
  JAX translation (1e-12), with the backward-pass derivatives formed;
- the ``optimizers`` surface: the seven names, each kernel's dtype, the
  device keyword, and ``genopt.build`` never routing to a kernel by name.
"""

import numpy as np
import pytest
import sympy as sp
import torch
import jax
import jax.numpy as jnp

from tpl_tpu.ops import interp as j_interp
from tpl_tpu.optim import genopt as j_genopt
from tpl_tpu.optim import symext as j_spx

import tpl_tpu_torch
from tpl_tpu_torch import scenes
from tpl_tpu_torch.ops import interp as t_interp
from tpl_tpu_torch.optim import genopt, ilqr, problems, solver
from tpl_tpu_torch.optim import symext as spx
from tpl_tpu_torch.optim.solver import Solver

TOL = 1e-12
SOLVE_RTOL, SOLVE_X_ATOL, SOLVE_U_ATOL = 1e-4, 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


def mpc_config(sx=spx, go=genopt):
    """tests/test_genopt.py's sympy tracking MPC with the symext and
    genopt modules of either package."""
    return scenes.genopt_mpc_config(sx, go)


def _rand_params(spec, rng):
    p = {}
    for name, s in spec.items():
        if hasattr(s, "capacity"):
            p[name] = rng.uniform(-1.0, 1.0, s.capacity)
        else:
            p[name] = rng.uniform(0.1, 2.0)
    return p


def _torch(p):
    return {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in p.items()}


def _jax(p):
    return {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in p.items()}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def test_mpc_config_matches_jax_and_native():
    prob, spec = genopt.make_problem(mpc_config())
    j_prob, j_spec = j_genopt.make_problem(mpc_config(j_spx, j_genopt))
    prob_n, spec_n = problems.trajectory_tracking_mpc(ref_capacity=128)

    assert set(spec) == set(j_spec) == set(spec_n)
    assert {k for k, s in spec.items() if hasattr(s, "capacity")} == {
        "ref_x", "ref_y", "ref_phi", "ref_k", "ref_v"}
    assert (prob.nx, prob.nu, prob.nc) == (j_prob.nx, j_prob.nu,
                                           j_prob.nc) == (7, 2, 4)

    rng = np.random.default_rng(0)
    p = _rand_params(spec_n, rng)
    p["ref_step"] = 0.5
    tp, jp = _torch(p), _jax(p)
    dt = torch.tensor(0.05, dtype=torch.float64)

    for _ in range(5):
        x = rng.uniform(-2, 2, prob.nx)
        u = rng.uniform(-1, 1, prob.nu)
        tx, tu = torch.from_numpy(x), torch.from_numpy(u)
        jx, ju = jnp.asarray(x), jnp.asarray(u)
        for fn in ("dynamics", "cost", "constraints"):
            got = getattr(prob, fn)(tx, tu, 3, dt, tp)
            _close(got, getattr(j_prob, fn)(jx, ju, 3, 0.05, jp), fn)
            _close(got, getattr(prob_n, fn)(tx, tu, 3, dt, tp),
                   fn + " (native)")

    # the gradient of the cost in x, through the detached fixed(s_r) of the
    # velocity target too
    xg = tx.clone().requires_grad_()
    g, = torch.autograd.grad(prob.cost(xg, tu, 3, dt, tp), xg)
    _close(g, jax.grad(lambda v: j_prob.cost(v, ju, 3, 0.05, jp))(jx),
           "cost gradient")
    xg = tx.clone().requires_grad_()
    g_n, = torch.autograd.grad(prob_n.cost(xg, tu, 3, dt, tp), xg)
    _close(g, g_n, "cost gradient (native)")


def test_mpc_config_broadcasts_like_the_native_problem():
    """The translated functions over a (B, n) batch of steps with a step
    tensor, as the backward pass and the line search evaluate them, and
    the backward-pass derivative blocks of the two problems."""
    prob, _ = genopt.make_problem(mpc_config())
    prob_n, spec_n = problems.trajectory_tracking_mpc(ref_capacity=128)
    rng = np.random.default_rng(1)
    p = _torch(_rand_params(spec_n, rng))
    p["ref_step"] = torch.tensor(0.5, dtype=torch.float64)
    x = torch.from_numpy(rng.uniform(-2, 2, (3, 6, 7)))
    u = torch.from_numpy(rng.uniform(-1, 1, (3, 6, 2)))
    ts = torch.arange(6)
    dt = torch.tensor(0.05, dtype=torch.float64)
    for fn in ("dynamics", "cost", "constraints"):
        _close(getattr(prob, fn)(x, u, ts, dt, p),
               getattr(prob_n, fn)(x, u, ts, dt, p), fn)
    lam = torch.from_numpy(rng.uniform(0, 1, (6, 4)))
    w = torch.full((4,), 10.0, dtype=torch.float64)
    for got, want in zip(
            ilqr.derivatives(prob, x[0], u[0], ts, dt, p, lam, w),
            ilqr.derivatives(prob_n, x[0], u[0], ts, dt, p, lam, w)):
        _close(got, want, "derivatives")


def test_full_solve_matches_native():
    make = genopt.build(mpc_config(), device="cpu")
    opt_s = make()
    assert opt_s.problem.kernel is None

    prob_n, spec_n = problems.trajectory_tracking_mpc(ref_capacity=128)
    opt_n = Solver(prob_n, spec_n, horizon_max=300, device="cpu")

    inputs, x0 = scenes.genopt_mpc_solve_inputs()

    assert opt_s.params.l == 2.7  # dict default applied by the factory
    for opt in (opt_s, opt_n):
        for k, v in inputs.items():
            setattr(opt.params, k, v)
        opt.horizon = 60
        opt.step = 0.05
        opt.max_iterations = 8
        opt.x[0] = x0
        opt.update()

    np.testing.assert_allclose(opt_s.x, opt_n.x, rtol=SOLVE_RTOL,
                               atol=SOLVE_X_ATOL)
    np.testing.assert_allclose(opt_s.u, opt_n.u, rtol=SOLVE_RTOL,
                               atol=SOLVE_U_ATOL)
    # solver actually moved (not a trivial zero solution)
    assert float(np.abs(opt_n.u).max()) > 1e-3


def test_lerp_wrap_matches_jax_and_oracle():
    rng = np.random.default_rng(1)
    arr = rng.uniform(-1, 1, 9)
    xs = 2.0 + np.arange(9) * 0.5   # table over [2.0, 6.0]
    length = 5.5                     # gap of 1.5 after the last sample

    def oracle(x):
        first, dx, n = xs[0], 0.5, len(arr)
        last = first + (n - 1) * dx
        gap = length - (last - first)
        xm = np.mod(x - first, length) + first
        if xm >= last and gap > 0:
            a = (xm - last) / gap
            return (1 - a) * arr[-1] + a * arr[0]
        q = (xm - first) / dx
        lo = int(np.floor(q))
        return (1 - (q - lo)) * arr[lo] + (q - lo) * arr[min(lo + 1, n - 1)]

    pts = [2.0, 2.3, 5.9, 6.2, 7.49, 7.5001, 13.2, -1.7, 0.0]
    got = genopt._lerp_wrap(length, 0.5, torch.tensor(pts, dtype=torch.float64),
                            torch.from_numpy(xs), torch.from_numpy(arr))
    for x, g in zip(pts, got):
        want = j_genopt._lerp_wrap(length, 0.5, jnp.asarray(x, jnp.float64),
                                   jnp.asarray(xs), jnp.asarray(arr))
        _close(g, want, f"x={x}")
        np.testing.assert_allclose(float(g), oracle(x), rtol=1e-9,
                                   atol=TOL, err_msg=f"x={x}")


def test_get_array_value_and_blerp_match_jax():
    rng = np.random.default_rng(2)
    arr = rng.uniform(-1, 1, 7)
    idx = np.array([-3.0, 0.0, 2.7, 6.0, 9.5])
    _close(genopt._get_array_value(torch.from_numpy(arr),
                                   torch.from_numpy(idx)),
           j_genopt._get_array_value(jnp.asarray(arr), jnp.asarray(idx)),
           "get_array_value")
    grid = rng.uniform(-2, 2, (6, 9))
    xq = rng.uniform(-1.0, 6.0, 40)
    yq = rng.uniform(-1.0, 4.0, 40)
    xq[:3] = [0.5, 1.0, 4.5]            # on grid points and past the end
    got = t_interp.blerp(0.5, -0.25, 0.5, 0.75, torch.from_numpy(xq),
                         torch.from_numpy(yq), torch.from_numpy(grid))
    want = j_interp.blerp(0.5, -0.25, 0.5, 0.75, jnp.asarray(xq),
                          jnp.asarray(yq), jnp.asarray(grid))
    _close(got, want, "blerp")


def test_fixed_blocks_gradients():
    x = sp.Symbol("x")
    cfg = genopt.Config(states=[x], actions=[sp.Symbol("u0")], params=[],
                        dynamics=[sp.Symbol("u0")],
                        costs=[x * spx.fixed(x)], name="frozen")
    prob, _ = genopt.make_problem(cfg)
    xv = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(
        prob.cost(xv, torch.zeros(1, dtype=torch.float64), 0, 0.1, {}), xv)
    # d/dx [x * detach(x)] = detach(x) = 2, not 2x = 4
    np.testing.assert_allclose(g.numpy(), [2.0])
    assert spx.unfixed(spx.fixed(x * sp.Symbol("y"))) == x * sp.Symbol("y")


def test_unknown_symbol_rejected():
    x, u = sp.Symbol("x"), sp.Symbol("u0")
    cfg = genopt.Config(states=[x], actions=[u], params=[],
                        dynamics=[u], costs=[x * sp.Symbol("mystery")])
    with pytest.raises(ValueError, match="mystery"):
        genopt.make_problem(cfg)
    with pytest.raises(ValueError, match="duplicate"):
        genopt.make_problem(genopt.Config(states=[x], actions=[x], params=[],
                                          dynamics=[u], costs=[x]))
    with pytest.raises(ValueError, match="collide"):
        genopt.make_problem(genopt.Config(
            states=[x], actions=[u], params=[sp.Symbol("dt")],
            dynamics=[u], costs=[x]))


def _printer_config(sx, go):
    """Expressions the torch printer turns into calls that take no Python
    number (``Max`` / ``Min`` with a constant, ``atan2`` of a constant) or
    into Python numbers (a constant cost and constraint term)."""
    x, v, u = sp.symbols("x v u0")
    c = sp.Symbol("c")
    return go.Config(
        states=[x, v], actions=[u], params={c: 0.5},
        dynamics=[v, sp.Max(u, 1) + sp.Min(-1, x, c)],
        costs=[x ** 2 + sp.atan2(1, v), sp.Integer(3),
               sp.Piecewise((v, v > 0), (-v, True)) * sp.Rational(1, 3),
               sp.sqrt(sp.Abs(x) + 1) * sp.tan(u)],
        end_costs=[sp.Max(x, 2) ** 2, sp.Integer(1)],
        constraints=[u - c, sp.Integer(-1), sp.Max(x, 0) - 5])


def test_printer_max_min_and_constants_match_jax():
    prob, spec = genopt.make_problem(_printer_config(spx, genopt))
    j_prob, _ = j_genopt.make_problem(_printer_config(j_spx, j_genopt))
    assert prob.nc == 3 and prob.end_cost is not None
    rng = np.random.default_rng(4)
    tp = {"c": torch.tensor(0.5, dtype=torch.float64)}
    jp = {"c": jnp.asarray(0.5, jnp.float64)}
    dt = torch.tensor(0.1, dtype=torch.float64)
    for _ in range(6):
        x = rng.uniform(-3, 3, 2)
        u = rng.uniform(-2, 2, 1)
        tx, tu = torch.from_numpy(x), torch.from_numpy(u)
        for fn in ("dynamics", "cost", "constraints"):
            got = getattr(prob, fn)(tx, tu, 2, dt, tp)
            assert got.dtype == torch.float64, fn
            _close(got, getattr(j_prob, fn)(jnp.asarray(x), jnp.asarray(u),
                                            2, 0.1, jp), fn)
        _close(prob.end_cost(tx, 2, dt, tp),
               j_prob.end_cost(jnp.asarray(x), 2, 0.1, jp), "end_cost")
    # over a batch of steps: every term broadcast to the steps
    xs = torch.from_numpy(rng.uniform(-3, 3, (5, 2)))
    us = torch.from_numpy(rng.uniform(-2, 2, (5, 1)))
    ts = torch.arange(5)
    assert prob.cost(xs, us, ts, dt, tp).shape == (5,)
    assert prob.constraints(xs, us, ts, dt, tp).shape == (5, 3)
    blocks = ilqr.derivatives(prob, xs, us, ts, dt, tp,
                              torch.zeros((5, 3), dtype=torch.float64),
                              torch.ones(3, dtype=torch.float64))
    assert all(bool(torch.isfinite(b).all()) for b in blocks)


def test_build_parallel_and_solver_defaults():
    factories = genopt.build_parallel([mpc_config(), _printer_config(
        spx, genopt)], device="cpu", dtype=torch.float64)
    opts = [b() for b in factories]
    assert [o.problem.name for o in opts] == ["mpc_sympy", "genopt_problem"]
    assert all(o.dtype == torch.float64 and o.device.type == "cpu"
               for o in opts)
    assert opts[1].params.c == 0.5 and opts[0].horizon_max == 300


def test_build_never_routes_to_a_kernel_by_name(monkeypatch):
    """A translated problem named like a kernel's problem takes the plain
    iLQR: the kernel hard-codes its own problem."""
    cfg = mpc_config()
    cfg.name = "trajectory_tracking_mpc"
    opt = genopt.build(cfg, device="cpu", dtype=torch.float64)()
    called = []
    monkeypatch.setitem(solver.KERNELS,
                        ("trajectory_tracking_mpc", torch.float64),
                        lambda *a: called.append(a))
    n = 100
    s = np.arange(n) * 0.5
    opt.params.ref_x = s
    opt.params.ref_v = np.full(n, 5.0)
    opt.params.ref_step = 0.5
    opt.params.v_ch = 30.0
    opt.horizon = 10
    opt.x[0] = [0.0, 0.0, 0.0, 0.0, 4.0, 0.0, 0.0]
    opt.update()
    assert not called and opt.iterations > 0


def test_optimizers_module_surface():
    from tpl_tpu_torch.optim import optimizers as opts
    opts.build_optimizers()
    names = ["trajectory_tracking_mpc", "trajectory_tracking_mpc_time",
             "lateral_profile", "velocity_profile_space",
             "velocity_profile_time", "ref_line_smoother_k",
             "ref_line_smoother_dk"]
    for name in names:
        assert name in vars(opts)
    opt = opts.ref_line_smoother_k()
    assert opt.horizon > 0 and hasattr(opt.params, "_spec")
    assert opt.device.type == "cpu"
    # each name with its kernel's dtype, where the port has a kernel
    kernels = {n for n, _ in solver.KERNELS}
    for name in names:
        b = getattr(opts, name)
        want = (torch.float64 if name.startswith("trajectory_tracking")
                else torch.float32)
        assert b.dtype == want, name
        if name in kernels:
            assert (name, b.dtype) in solver.KERNELS, name
        # JAX's 300 on every device; the tracking MPCs' solvers at 300
        # take the generic kernel (their own kernels hold fewer steps)
        assert b().horizon_max == 300, name
        assert b().route == ("ilqr_rstp" if name in ("lateral_profile",
                                                     "velocity_profile_space")
                             else "ilqr_generic"), name
    o = opts.trajectory_tracking_mpc(dtype=torch.float32, device="cpu")
    assert o.dtype == torch.float32 and o.device.type == "cpu"
    # the solve of a factory's solver on the CPU: the plain version
    o = opts.trajectory_tracking_mpc(device="cpu")
    o.params.ref_x = np.arange(128) * 0.5
    o.params.ref_v = np.full(128, 5.0)
    o.params.ref_step = 0.5
    o.params.pv = 1.0
    o.horizon = 20
    o.x[0] = [0.0, 0.0, 0.0, 0.0, 4.0, 0.0, 0.0]
    o.update()
    assert o.iterations > 0 and np.isfinite(o.traj_costs)
    with pytest.raises(AttributeError):
        opts.no_such_optimizer
