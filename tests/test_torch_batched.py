"""The port's batched AL-iLQR (``tpl_tpu_torch/optim/batched.py``, its plain
version) against the JAX package's ``tpl_tpu/optim/batched.py`` and against
the port's own per-instance ``make_update_fn``, on the CPU at a small size
(B = 4-6, H = 20).

The same seeded numpy inputs go through both packages in the shared public
layout (x ``(H+1, nx, B)``, u ``(H, nu, B)``, lam ``(H, nc, B)``).  Cases:
``trajectory_tracking_mpc`` (nu = 2, the closed-form solve; HEUN as the
bench runs it, EULER and RK4 besides), ``lateral_profile`` (nu = 1, an end
cost, constraints), the nu = 3 problem of tests/test_ilqr.py (the general
``linalg.solve``), and a per-instance scalar param.

Tolerances.  float64: x, u, lam atol = rtol = 1e-9 against the JAX module
(the two keep the same operations and differ in how sums of 2-7 terms are
ordered), equal ``mu_step``, traj_costs rtol 1e-9; against B per-instance
solves of the port rtol 1e-6, atol 1e-8 as tests/test_ilqr.py holds the
JAX module to its vmap.  float32: x, u, lam atol 2e-2 and traj_costs rtol
1e-5, the float32 tolerance tests/test_torch_kernel_cuda.py states for a
float32 solve: where a solve stops is decided by float32 rounding of a
relative cost change of 1e-6, so two implementations may part by an
iteration near convergence.

    python -m pytest tests/test_torch_batched.py -q
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpl_tpu.optim import batched as j_batched
from tpl_tpu.optim import ilqr as j_ilqr
from tpl_tpu.optim import problems as j_problems

import tpl_tpu_torch
from tpl_tpu_torch.optim import batched, ilqr, problems

H = 20
F64 = dict(atol=1e-9, rtol=1e-9, cost_rtol=1e-9)
F32 = dict(atol=2e-2, rtol=0.0, cost_rtol=1e-5)
NP = {"float64": np.float64, "float32": np.float32}


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


# ---------------------------------------------------------------------
# the cases: (problem pair, numpy params, numpy cfg, x0 (nx, B), warm start)

def _tri(pkg):
    """The nu = 3 problem of tests/test_ilqr.py for either package."""
    if pkg is jnp:
        dyn = lambda x, u, t, dt, p: jnp.stack(
            [u[0] + 0.3 * x[2], u[1] - 0.1 * x[0], u[2]])
        at = lambda a, i: a[i]
    else:
        dyn = lambda x, u, t, dt, p: torch.stack(
            [u[..., 0] + 0.3 * x[..., 2], u[..., 1] - 0.1 * x[..., 0],
             u[..., 2]], -1)
        at = lambda a, i: a[..., i]

    def cost(x, u, t, dt, p):
        return (at(x, 0) ** 2 + 0.5 * at(x, 1) ** 2 + 0.2 * at(x, 2) ** 2
                + 0.01 * (at(u, 0) ** 2 + at(u, 1) ** 2 + at(u, 2) ** 2)
                + 0.004 * at(u, 0) * at(u, 1) + 0.002 * at(u, 1) * at(u, 2))

    cls = j_ilqr.Problem if pkg is jnp else ilqr.Problem
    return cls("tri", nx=3, nu=3, nc=0, dynamics=dyn, cost=cost)


def _cfg(nu, nc, u_lo, u_hi, dt, weight, lam_limit, iterations, T=H):
    return dict(u_min=np.tile(np.asarray(u_lo, float), (H, 1)),
                u_max=np.tile(np.asarray(u_hi, float), (H, 1)),
                barrier_weight=np.full(nc, weight),
                lg_mult_limit=np.full(nc, lam_limit), dt=dt, T=T,
                max_iterations=iterations, max_lg_iterations=1,
                min_rel_cost_change=1e-6)


def mpc_inputs(B, rng, iterations=8, T=H):
    """The ``__graft_entry__._mpc_setup`` course, weights and limits, with
    the bench's spread of starts (``x0 + 0.01 * b``) widened by a seeded
    offset so that the scenarios stop after different iteration counts."""
    ss = np.arange(128) * 0.5
    ref_y = 2.0 * np.sin(ss * 0.1)
    phi = np.arctan(np.gradient(ref_y, ss))
    params = {"pd": 10.0, "pv": 5.0, "pdelta": 0.0, "min_pdelta_dot": 0.1,
              "pdelta_dot": 0.0, "min_p_phi_dot": 0.0, "p_phi_dot": 0.0,
              "p_phi": 0.01, "p_phi_ref_dot_diff": 0.01, "pa": 2.0,
              "pj": 0.5, "l": 3.165, "v_ch": 32.0, "ref_x": ss,
              "ref_y": ref_y, "ref_phi": phi, "ref_k": np.gradient(phi, ss),
              "ref_v": np.full(128, 8.0), "ref_step": 0.5, "max_delta": 0.7,
              "max_acc": 3.0, "min_acc": -3.0, "a_offset": 0.0}
    x0 = (np.array([0.0, 1.0, 0.0, 0.0, 5.0, 0.0, 0.0])[:, None]
          + 0.01 * np.arange(B)[None, :]
          + rng.normal(0.0, 0.3, (7, B)) * np.array(
              [1, 1, 0.2, 0.1, 3, 0, 0.5])[:, None])
    cfg = _cfg(2, 4, [-3.0, -1.0], [1.5, 1.0], 0.05, 1e4, 1e30, iterations,
               T)
    return params, cfg, x0


def lateral_inputs(B, rng):
    n = 128
    lower = np.full(n, -2.0)
    lower[8:14] = 0.4
    params = dict(k_ref=0.01 * np.sin(np.arange(n) * 0.1),
                  d_offset=np.zeros(n), d_lower_constr=lower,
                  d_upper_constr=np.full(n, 2.0), ref_step=0.5, w_d=0.5,
                  w_v_d=0.5, w_a_d=0.5, w_k=0.5)
    x0 = np.stack([rng.normal(0.0, 0.5, B), rng.normal(0.0, 0.05, B)])
    return params, _cfg(1, 2, [-2.5], [2.5], 0.5, 1000.0, 0.1, 12), x0


def tri_inputs(B, rng):
    x0 = np.array([[1.0, 0.0, -0.5], [2.0, -1.0, 0.2], [-3.0, 0.5, 1.0],
                   [0.5, 2.0, -1.5]]).T[:, :B]
    cfg = _cfg(3, 1, [-1.0] * 3, [1.0] * 3, 0.1, 1.0, 1e30, 15)
    cfg["min_rel_cost_change"] = 1e-12
    return {}, cfg, x0


CASES = {
    # name: (factory name or "tri", inputs, B, integrator, dtype, warm)
    "mpc_heun_f64": ("trajectory_tracking_mpc", mpc_inputs, 6, "HEUN",
                     "float64", False),
    "mpc_heun_f64_warm": ("trajectory_tracking_mpc", mpc_inputs, 4, "HEUN",
                          "float64", True),
    "mpc_heun_f32": ("trajectory_tracking_mpc", mpc_inputs, 6, "HEUN",
                     "float32", False),
    "mpc_euler_f64": ("trajectory_tracking_mpc", mpc_inputs, 4, "EULER",
                      "float64", False),
    "mpc_rk4_f64": ("trajectory_tracking_mpc", mpc_inputs, 4, "RK4",
                    "float64", False),
    "lateral_nu1_f64": ("lateral_profile", lateral_inputs, 5, "EULER",
                        "float64", False),
    "lateral_nu1_f32": ("lateral_profile", lateral_inputs, 5, "EULER",
                        "float32", False),
    "tri_nu3_f64": ("tri", tri_inputs, 4, "EULER", "float64", False),
    "tri_nu3_f32": ("tri", tri_inputs, 4, "EULER", "float32", False),
}


def build(case):
    """Both packages' problems and the case's numpy inputs: params, cfg,
    and the state (x, u, lam, mu_step, x0) in the public layout."""
    name, inputs, B, integ, dtype, warm = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    if name == "tri":
        jprob, tprob = _tri(jnp), _tri(torch)
    else:
        jprob = getattr(j_problems, name)(ref_capacity=128)[0]
        tprob = getattr(problems, name)(ref_capacity=128)[0]
    params, cfg, x0 = inputs(B, rng)
    nc = max(jprob.nc, 1)
    u = np.zeros((H, jprob.nu, B))
    lam = np.zeros((H, nc, B))
    mu = np.zeros(B, np.int32)
    if warm:
        u = rng.normal(0.0, 0.3, u.shape)
        lam = rng.uniform(0.0, 1e-3, lam.shape)
        mu = rng.integers(0, 4, B).astype(np.int32)
    x = np.zeros((H + 1, jprob.nx, B))
    x[0] = x0
    return jprob, tprob, params, cfg, (x, u, lam, mu, x0), B, integ, dtype


def jax_inputs(params, cfg, state, dtype):
    """The numpy inputs as the JAX module takes them."""
    f = getattr(jnp, dtype)
    jp = {k: jnp.asarray(v, f) for k, v in params.items()}
    jc = {k: (jnp.asarray(v, jnp.int32)
              if k in ("T", "max_iterations", "max_lg_iterations")
              else jnp.asarray(v, f)) for k, v in cfg.items()}
    x, u, lam, mu, x0 = state
    return (jnp.asarray(x, f), jnp.asarray(u, f), jnp.asarray(lam, f),
            jnp.asarray(mu), jnp.asarray(x0, f), jp, jc)


def port_inputs(params, cfg, state, dtype):
    """The same numpy inputs as the port takes them (CPU tensors; T and the
    iteration limits stay host integers)."""
    f = getattr(torch, dtype)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(f)
    tp = {k: t(v) for k, v in params.items()}
    tc = {k: (int(v) if k in ("T", "max_iterations", "max_lg_iterations")
              else t(v)) for k, v in cfg.items()}
    x, u, lam, mu, x0 = state
    return t(x), t(u), t(lam), torch.as_tensor(mu), t(x0), tp, tc


def run_port(case, per_instance=(), **override):
    _, tprob, params, cfg, state, B, integ, dtype = build(case)
    cfg = dict(cfg, **override)
    upd = batched.make_batched_update_fn(
        tprob, H, B, getattr(ilqr, integ), getattr(torch, dtype),
        per_instance=per_instance)
    args = port_inputs(params, cfg, state, dtype)
    return upd(*args, iterations=True), args, tprob


# ---------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_matches_jax(case):
    jprob, _, params, cfg, state, B, integ, dtype = build(case)
    jupd = j_batched.make_batched_update_fn(
        jprob, H, B, integrator=getattr(j_ilqr, integ),
        dtype=getattr(jnp, dtype))
    want = [np.asarray(a) for a in jupd(*jax_inputs(params, cfg, state,
                                                    dtype))]
    got, _, _ = run_port(case)
    tol = F64 if dtype == "float64" else F32
    for name, g, w in zip(("x", "u", "lam"), got, want):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=tol["rtol"],
                                   atol=tol["atol"], err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), want[4],
                               rtol=tol["cost_rtol"])
    if dtype == "float64":
        np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert got[3].dtype == torch.int32
    its = got[5].numpy()
    assert its.shape == (B,) and np.all(its >= 1)
    assert np.all(its <= cfg["max_iterations"])
    assert np.all(np.isfinite(got[0].numpy()))
    # the control limits hold on every path
    u = got[1].numpy()
    assert np.all(u <= cfg["u_max"][:, :, None] + 1e-9)
    assert np.all(u >= cfg["u_min"][:, :, None] - 1e-9)


@pytest.mark.parametrize("case", ["mpc_heun_f64", "mpc_heun_f64_warm",
                                  "mpc_rk4_f64", "lateral_nu1_f64",
                                  "tri_nu3_f64"])
def test_batched_matches_per_instance(case):
    """B runs of the port's per-instance ``make_update_fn`` give the batch's
    columns, mu_step, cost and iteration count."""
    (xs, u, lam, mu, costs, its), args, tprob = run_port(case)
    x_in, u_in, lam_in, mu_in, x0, tp, tc = args
    integ = getattr(ilqr, CASES[case][3])
    one = ilqr.make_update_fn(tprob, H, integ, torch.float64)
    for b in range(x0.shape[1]):
        st = ilqr.SolverState(x_in[..., b], u_in[..., b], lam_in[..., b],
                              int(mu_in[b]))
        new, info = one(st, x0[:, b], tp, tc)
        for g, w in ((xs, new.x), (u, new.u), (lam, new.lam)):
            np.testing.assert_allclose(g[..., b].numpy(), w.numpy(),
                                       rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(float(costs[b]),
                                   float(info["traj_costs"]), rtol=1e-9)
        assert int(mu[b]) == new.mu_step
        assert int(its[b]) == info["iterations"]


def test_finished_scenario_stays_frozen():
    """The scenarios of the MPC case stop after different iteration counts;
    what an early one holds when it stops is what the batch returns for it
    at the end, while the others go on."""
    full, _, _ = run_port("mpc_heun_f64")
    its = full[5].numpy()
    assert its.min() < its.max(), its
    early = int(np.argmin(its))
    cut, _, _ = run_port("mpc_heun_f64", max_iterations=int(its[early]))
    for g, w in zip(full[:5], cut[:5]):
        g, w = g.numpy(), w.numpy()
        np.testing.assert_array_equal(g[..., early], w[..., early])
    assert int(cut[5][early]) == its[early]
    late = int(np.argmax(its))
    assert not np.array_equal(full[1].numpy()[..., late],
                              cut[1].numpy()[..., late])


def test_per_instance_scalar_param():
    """A per-scenario scalar passed as (B,): every column equals the solve
    of that scenario alone with its own value."""
    case = "mpc_heun_f64"
    _, tprob, params, cfg, state, B, _, dtype = build(case)
    pv = np.linspace(2.0, 9.0, B)
    args = port_inputs(dict(params, pv=pv), cfg, state, dtype)
    upd = batched.make_batched_update_fn(tprob, H, B, ilqr.HEUN,
                                         torch.float64, per_instance=("pv",))
    xs, u, _, mu, costs = upd(*args)
    one = ilqr.make_update_fn(tprob, H, ilqr.HEUN, torch.float64)
    x_in, u_in, lam_in, mu_in, x0, tp, tc = args
    differ = 0
    for b in range(B):
        st = ilqr.SolverState(x_in[..., b], u_in[..., b], lam_in[..., b], 0)
        new, info = one(st, x0[:, b], dict(tp, pv=tp["pv"][b]), tc)
        np.testing.assert_allclose(u[..., b].numpy(), new.u.numpy(),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(float(costs[b]),
                                   float(info["traj_costs"]), rtol=1e-9)
        shared, _ = one(st, x0[:, b], dict(tp, pv=tp["pv"][0]), tc)
        differ += not np.allclose(shared.u.numpy(), new.u.numpy(), atol=1e-6)
    assert differ >= B - 2          # the value matters


def test_active_horizon_is_masked():
    (xs, u, lam, _, _, _), _, _ = run_port("mpc_heun_f64", T=12)
    x, u = xs.numpy(), u.numpy()
    np.testing.assert_array_equal(u[12:], 0.0)
    assert np.any(u[:12] != 0.0)
    np.testing.assert_array_equal(x[13:], np.repeat(x[12:13], H - 12, 0))
    np.testing.assert_array_equal(lam.numpy()[12:], 0.0)


@pytest.mark.parametrize("fault", ["x_shape", "mu_shape", "two_rounds",
                                   "integrator"])
def test_rejects_bad_calls(fault):
    _, tprob, params, cfg, state, B, _, dtype = build("mpc_heun_f64")
    x, u, lam, mu, x0, tp, tc = port_inputs(params, cfg, state, dtype)
    make = lambda integ=ilqr.HEUN: batched.make_batched_update_fn(
        tprob, H, B, integ, torch.float64)
    with pytest.raises(ValueError):
        if fault == "x_shape":
            make()(x.movedim(-1, 0), u, lam, mu, x0, tp, tc)
        elif fault == "mu_shape":
            make()(x, u, lam, mu[:-1], x0, tp, tc)
        elif fault == "two_rounds":
            make()(x, u, lam, mu, x0, tp, dict(tc, max_lg_iterations=2))
        else:
            make(7)


def test_init_batch_takes_the_device_given():
    prob, _ = problems.trajectory_tracking_mpc(128)
    x, u, lam, mu = batched.init_batch(prob, H, 3, torch.float64)
    assert x.shape == (H + 1, 7, 3) and u.shape == (H, 2, 3)
    assert lam.shape == (H, 4, 3) and mu.dtype == torch.int32
    assert {a.device.type for a in (x, u, lam, mu)} == {"cpu"}


# ---------------------------------------------------------------------
# the batched kernel's line-search rule

def sequential_pick(costs, traj_costs):
    """The line search's pick as the batched kernel takes it: candidate c
    of a scenario is rolled while no candidate before it improved on
    ``traj_costs`` (finite, non-negative and lower), and the first that
    does is taken.  ``costs`` (B, A); returns ``(found, idx, rolled)``, each
    (B,): whether one improved, which (0 where none did) and how many
    candidates were rolled."""
    B, A = costs.shape
    found = torch.zeros(B, dtype=torch.bool)
    idx = torch.zeros(B, dtype=torch.int64)
    rolled = torch.zeros(B, dtype=torch.int64)
    for c in range(A):
        rolled += (~found).to(torch.int64)
        cc = costs[:, c]
        ok = ~found & (cc < traj_costs) & torch.isfinite(cc) & (cc >= 0.0)
        idx = torch.where(ok, c, idx)
        found |= ok
    return found, idx, rolled


def _argmax_pick(costs, cur):
    """The plain update's pick: the first improving candidate by argmax,
    and the candidates a search in order rolls to reach it."""
    improving = (costs < cur[:, None]) & torch.isfinite(costs) & (costs >= 0.0)
    found = improving.any(1)
    idx = improving.to(torch.int8).argmax(1)
    rolled = torch.where(found, idx + 1, costs.shape[1])
    return found, torch.where(found, idx, 0), rolled


@pytest.mark.parametrize("kind", ["mixed", "nan", "negative", "none"])
def test_sequential_pick_matches_the_argmax_pick(kind):
    """The kernel's rule (roll the candidates in order, stop at the first
    improving one) takes the plain version's pick, and rolls as many as
    that pick's index + 1 (all 8 where none improves), on seeded batches
    of candidate costs with NaN, infinite, negative and no improving
    costs."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    B, A = 256, 8
    cur = torch.as_tensor(rng.uniform(1.0, 2.0, B))
    costs = torch.as_tensor(rng.uniform(0.5, 3.0, (B, A)))
    if kind == "nan":
        costs[torch.as_tensor(rng.uniform(size=(B, A)) < 0.4)] = np.nan
        costs[torch.as_tensor(rng.uniform(size=(B, A)) < 0.1)] = -np.inf
    elif kind == "negative":
        costs = costs - 2.0        # below zero is never taken
    elif kind == "none":
        costs = cur[:, None] + torch.as_tensor(rng.uniform(0.0, 1.0, (B, A)))
        costs[:, 3] = cur          # equal is no improvement
    found, idx, rolled = sequential_pick(costs, cur)
    w_found, w_idx, w_rolled = _argmax_pick(costs, cur)
    assert torch.equal(found, w_found)
    assert torch.equal(torch.where(found, idx, 0), w_idx)
    assert torch.equal(rolled, w_rolled)
    if kind == "none":
        assert not bool(found.any()) and bool((rolled == A).all())
    else:
        assert 0 < int(found.sum()) < B
        assert len(set(rolled.tolist())) > 2


def test_plain_reports_the_candidates_rolled():
    """``rolled=True`` adds the candidates the sequential search rolls over
    the update, one count a scenario, and changes no result: at least one
    and at most 8 a search."""
    (xs, u, lam, mu, costs, its), args, tprob = run_port("mpc_heun_f64_warm")
    B = xs.shape[-1]
    upd = batched.make_batched_update_fn(tprob, H, B, ilqr.HEUN,
                                         torch.float64)
    got = upd.reference(*args, iterations=True, rolled=True)
    assert len(got) == 7
    for g, w in zip(got[:6], (xs, u, lam, mu, costs, its)):
        assert torch.equal(g, w)
    rolled = got[6]
    assert rolled.dtype == torch.int64 and rolled.shape == (B,)
    assert bool((rolled >= its).all()) and bool((rolled <= 8 * its).all())
    assert int(rolled.sum()) > int(its.sum())


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_plain_reports_the_rounds_of_a_group(group):
    """``group=g`` counts the rounds of g candidates side by side that the
    ordered search takes, ceil(rolled / g) a search: between the
    candidates over g and the candidates, one a search with all 8 side by
    side, and no result changes."""
    (xs, u, lam, mu, costs, its), args, tprob = run_port("mpc_heun_f64_warm")
    B = xs.shape[-1]
    upd = batched.make_batched_update_fn(tprob, H, B, ilqr.HEUN,
                                         torch.float64)
    rolled = upd.reference(*args, rolled=True)[5]
    got = upd.reference(*args, iterations=True, rolled=True, group=group)
    for g, w in zip(got[:6], (xs, u, lam, mu, costs, its)):
        assert torch.equal(g, w)
    rounds = got[6]
    assert bool((rounds >= its).all()) and bool((rounds <= rolled).all())
    assert bool((rounds * group >= rolled).all())
    if group == 1:
        assert torch.equal(rounds, rolled)
    if group == 8:
        assert torch.equal(rounds, its)
