"""The RSTP planner (path_vel_decomp) of the port against the JAX package,
on the CPU, on the same seeded or recorded inputs.

- ``rampify_corridor``: the port's numpy passes against the JAX package's
  (its native C++ where built), float64, atol=1e-9;
- ``ResetGate`` and ``ArcShift``: host float64 bookkeeping, exactly;
- the fused step's helpers, float32 on both sides: index outputs exactly,
  values atol=1e-4 (positions of up to ~125 m, where a float32 ulp is
  ~8e-6, through cumulative sums that the two packages order differently;
  XLA on the CPU also contracts multiply-adds into FMAs);
- ``ilqr_rstp.update`` on CPU tensors (the plain ``make_update_fn``)
  against the JAX ``make_update_fn``, float32, a cold and a warm update:
  iteration counts and mu_step equal, x, u, lam atol=1e-3 and traj_costs
  rtol=1e-4 (float32 solves of H=100..250 steps); the wrappers' input
  checks;
- the whole fused step against the JAX one from one carry, on inputs
  recorded from the JAX package's closed loop on ``demo/country_follow``
  and ``demo/country_overtake`` at the vendored H=250: opt_path and
  s_leader / v_leader atol=1e-3, the velocity profiles atol=1e-2 m/s and
  the stop mask exactly (measured: the paths within 2e-5 m, the leader
  exactly, v_opt within 4e-3 m/s; the velocity solve's last line-search
  decision, and so its mu_step, may part by float32 rounding);
- ``PathVelDecompPlanner`` against the JAX planner on one open-loop world
  (``tpl_tpu_torch.scenario_world``, 5 ticks of 0.1 s, the leader seen
  from the third), fused and host pipeline, horizon cut to 100 on both
  sides: the published trajectory (time, x, y, yaw, velocity) atol=1e-3
  and the collision screen's emergency flag exactly (measured: within
  3e-4).
"""

import types
import uuid

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpl_tpu import util as j_util
from tpl_tpu.application import EnvironmentApp as JEnvironmentApp
from tpl_tpu.application import PlanningApp as JPlanningApp
from tpl_tpu.application.environment_app import (
    load_env_params as j_load_env_params)
from tpl_tpu.environment import DynamicObject as JDynamicObject
from tpl_tpu.environment import load_map_store as j_load_map_store
from tpl_tpu.optim import ilqr as j_ilqr
from tpl_tpu.optim import problems as j_problems
from tpl_tpu.planning.path_vel_decomp import fused_replan as j_fr
from tpl_tpu.planning.path_vel_decomp import path_optim as j_po
from tpl_tpu.planning.path_vel_decomp import warm_start as j_ws
from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch import util as t_util
from tpl_tpu_torch.application import EnvironmentApp, PlanningApp
from tpl_tpu_torch.application.environment_app import load_env_params
from tpl_tpu_torch.environment import DynamicObject, load_map_store
from tpl_tpu_torch.optim import ilqr_rstp
from tpl_tpu_torch.planning.path_vel_decomp import fused_replan as t_fr
from tpl_tpu_torch.planning.path_vel_decomp import path_optim as t_po
from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify
from tpl_tpu_torch.planning.path_vel_decomp import warm_start as t_ws
from tpl_tpu_torch.scenario_world import ScenarioWorld, SliceStack

from tests.test_torch_kernel_cuda import RSTP_N_REF, rstp_solver

CORRIDOR_ATOL = 1e-9
HELPER_ATOL = 1e-4
SOLVE_ATOL = 1e-3
SOLVE_COST_RTOL = 1e-4
PATH_ATOL = 1e-3
LEADER_ATOL = 1e-3
PROFILE_ATOL = 1e-2
PLAN_ATOL = 1e-3

F32 = np.float32
RSTP_H = 250


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, F32))


def _j(a):
    return jnp.asarray(np.asarray(a, F32))


# ---------------------------------------------------------------------
# host modules


def _corridor(rng, n):
    """A window path (n, 6) with its speeds and a corridor with a carved
    slice, as PathOptim.prepare builds them."""
    path = np.zeros((n, 6))
    path[:, 0] = np.arange(n) * 0.5
    path[:, 5] = np.clip(10.0 + np.cumsum(rng.normal(0.0, 0.3, n)), 0.0, 15)
    path[n // 2:n // 2 + 5, 5] = 0.05 * rng.uniform(size=5)
    lower = np.full(n, -1.75 + 1.0) + rng.normal(0.0, 0.05, n)
    upper = np.full(n, -1.75 + 1.0) + rng.normal(0.0, 0.05, n)
    lo = int(rng.integers(10, n // 3))
    lower[lo:lo + 30] = rng.uniform(0.5, 2.5)
    return path, lower, upper


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rampify_corridor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 120
    path, lower, upper = _corridor(rng, n)
    for args in [(0.5, n, 20.0, rng.normal(0.0, 0.5), path, 2.0, lower,
                  -upper),
                 (0.5, n - 7, 5.0, rng.normal(0.0, 0.5), path, 2.0, upper,
                  -lower)]:
        want = j_po.rampify_corridor(*args)
        got = t_po.rampify_corridor(*args)
        np.testing.assert_allclose(got, want, rtol=0, atol=CORRIDOR_ATOL)


@pytest.mark.parametrize("watch_time", [False, True])
def test_reset_gate_matches_jax(watch_time):
    rng = np.random.default_rng(int(watch_time))
    gates = (j_ws.ResetGate(watch_time), t_ws.ResetGate(watch_time))
    t, counter = 0.0, 0
    for k in range(40):
        t += 0.1 if rng.uniform() > 0.15 else -0.3
        counter += int(rng.uniform() < 0.1)
        env = types.SimpleNamespace(t=t, reset_counter=counter)
        shift, n = int(rng.integers(-2, 12)), int(rng.integers(1, 10))
        op = "poll" if k % 3 == 0 else "fire"
        if op == "poll":
            got = [g.poll(env) for g in gates]
        else:
            got = [g.fire(env, shift=shift, n=n) for g in gates]
        assert got[0] == got[1], k
        assert vars(gates[0]) == vars(gates[1]), k


def test_arc_shift_matches_jax():
    rng = np.random.default_rng(5)
    shifts = (j_ws.ArcShift(), t_ws.ArcShift())
    projects = (j_util.project, t_util.project)
    x0 = 0.0
    for tick in range(4):
        x0 += rng.uniform(0.0, 3.0)
        n = 80
        path = np.zeros((n, 6))
        path[:, 0] = x0 + np.arange(n) * 0.5
        path[:, 1] = 2.0 * np.sin(path[:, 0] * 0.05)
        for sh, proj in zip(shifts, projects):
            sh.advance(path, 0.5, n, proj)
        np.testing.assert_array_equal(shifts[1].query, shifts[0].query)
        arr = rng.normal(size=(n, 3))
        for a, hold in [(arr[:, 0], False), (arr, False), (arr, True)]:
            np.testing.assert_array_equal(shifts[1].resample(a, hold=hold),
                                          shifts[0].resample(a, hold=hold))


# ---------------------------------------------------------------------
# the fused step's helpers, float32


def _polyline(rng, n, T):
    s = np.cumsum(rng.uniform(0.3, 0.7, n))
    xy = np.stack([s, 3.0 * np.sin(s * 0.04) + rng.normal(0, 0.02, n)], -1)
    xy[T:] = xy[T - 1]
    return xy.astype(F32)


def _close(got, want, k, atol=HELPER_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=k)


def test_project_matches_jax():
    rng = np.random.default_rng(0)
    for n, T in [(120, 120), (120, 70)]:
        pts = _polyline(rng, n, T)
        pos = np.concatenate([
            pts[rng.integers(0, T, 40)] + rng.normal(0, 2.0, (40, 2)),
            [[-5.0, 1.0], [pts[T - 1, 0] + 5.0, 0.0]]]).astype(F32)
        want = j_fr._project(_j(pts), T, _j(pos))
        got = t_fr._project(_t(pts), T, _t(pos))
        for k in ("start", "index", "in_bounds"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        for k in ("sdist", "arc", "angle", "alpha"):
            _close(got[k].numpy(), want[k], k)


@pytest.mark.parametrize("T", [120, 83])
def test_resample_by_arc_matches_jax(T):
    rng = np.random.default_rng(T)
    H = 120
    bent = np.zeros((H, 6), F32)
    bent[:, :2] = _polyline(rng, H, H)
    bent[:, 2] = np.arctan2(np.gradient(bent[:, 1]), np.gradient(bent[:, 0]))
    bent[:, 3] = np.arange(H) * 0.5
    bent[:, 4] = rng.normal(0, 0.01, H)
    bent[:, 5] = rng.uniform(5, 15, H)
    want = j_fr._resample_by_arc(_j(bent), F32(0.5), T)
    got = t_fr._resample_by_arc(_t(bent), _t(0.5), T)
    _close(got.numpy(), want, "resampled path")


@pytest.mark.parametrize("H,T", [(RSTP_H, RSTP_H), (RSTP_H, 180), (2, 1)])
def test_rampify_scan_matches_jax(H, T):
    rng = np.random.default_rng(H + T)
    lim = np.maximum(1.0, 10.0 + np.cumsum(rng.normal(0.0, 1.0, H)))
    lim[H // 6:H // 6 + 5] = 2.0
    sc = dict(v0=rng.uniform(0.0, 12.0), a0=rng.normal(0.0, 0.5),
              a_min=-2.5, a_max=2.5, j_min=-1.5, j_max=1.5, v_min=1.0,
              step=0.5)
    order = ("a_min", "a_max", "j_min", "j_max", "v_min", "step")
    want = j_fr._rampify_scan(_j(sc["v0"]), _j(sc["a0"]), _j(lim), T,
                              *(_j(sc[k]) for k in order))
    got = rstp_rampify.scan(_t(sc["v0"]), _t(sc["a0"]), _t(lim), T,
                            *(_t(sc[k]) for k in order))
    assert got.shape == (H, 2)
    _close(got.numpy(), want, "profile")


def test_add_vel_constraint_matches_jax():
    rng = np.random.default_rng(3)
    H, T = 100, 90
    lim = rng.uniform(5.0, 15.0, H).astype(F32)
    idx = np.array([-5, 0, 10, 85, 95, 40], np.int32)
    length = np.array([10, 3, 20, 20, 5, 0], np.int32)
    vmax = rng.uniform(0.0, 12.0, len(idx)).astype(F32)
    got = t_fr._add_vel_constraint(_t(lim), T, torch.as_tensor(idx),
                                   _t(vmax), torch.as_tensor(length))
    for k in range(len(idx)):
        want = j_fr._add_vel_constraint(_j(lim), T, jnp.asarray(idx[k]),
                                        _j(vmax[k]), jnp.asarray(length[k]))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("si,T", [(0, 100), (7, 100), (3, 60), (120, 100)])
def test_shift_solver_state_matches_jax(si, T):
    rng = np.random.default_rng(si)
    H = 100
    x, u, lam = (rng.normal(size=s).astype(F32)
                 for s in ((H + 1, 2), (H, 1), (H, 5)))
    want = j_fr._shift_solver_state(
        j_ilqr.SolverState(_j(x), _j(u), _j(lam), jnp.asarray(0)),
        jnp.asarray(si), jnp.asarray(T))
    got = t_fr._shift_solver_state(_t(x), _t(u), _t(lam), si, T)
    for g, w in zip(got, (want.x, want.u, want.lam)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------
# the RSTP solves: ilqr_rstp.update (plain, CPU) against JAX, float32


def _flat(result):
    """One float64 vector of a JAX update's state, mu_step and cost."""
    state, info = result
    return np.concatenate([np.asarray(a, np.float64).reshape(-1) for a in (
        state.x, state.u, state.lam, state.mu_step, info["traj_costs"])])


@pytest.mark.parametrize("name", ["lateral_profile",
                                  "velocity_profile_space"])
@pytest.mark.parametrize("H", [100, RSTP_H])
def test_ilqr_rstp_plain_matches_jax(name, H):
    """One cold and one warm update of the same packed inputs: the port's
    ``ilqr_rstp.update`` on CPU tensors against the JAX make_update_fn."""
    n_ref = RSTP_N_REF
    s = rstp_solver(name, H, H, "cpu", np.random.default_rng(H), False)
    if name == "lateral_profile":
        # from the 4th iteration on the cost change is a few float32
        # roundings, where a line-search acceptance (and so mu_step) is
        # decided by the last bit; 3 iterations keep each decision clear
        s.max_iterations = 3
    p = ilqr_rstp.PROBLEMS[name]
    j_fn = j_ilqr.make_update_fn(getattr(j_problems, name)(
        ref_capacity=n_ref)[0], H, integrator=j_ilqr.EULER, dtype=jnp.float32)
    inputs = {k: np.asarray(v, F32) for k, v in s._inputs().items()}
    params = {k: np.asarray(s.params._values[k], F32)
              for k in p["scalars"] + p["tables"]}
    mu_step = s._mu_step
    before = ilqr_rstp.launches
    for tick in range(2):
        buf = torch.from_numpy(ilqr_rstp.pack_inputs(name, inputs, params,
                                                     mu_step))
        got = ilqr_rstp.unpack_outputs(name, ilqr_rstp.update(
            name, buf, H, n_ref, H, s.max_iterations, 1).numpy(), H)
        cfg = dict(u_min=_j(inputs["u_lims"][..., 0]),
                   u_max=_j(inputs["u_lims"][..., 1]),
                   barrier_weight=_j(inputs["bw_lim"][:, 0]),
                   lg_mult_limit=_j(inputs["bw_lim"][:, 1]),
                   dt=_j(inputs["cfg_f"][0]),
                   min_rel_cost_change=_j(inputs["cfg_f"][1]), T=H,
                   max_iterations=s.max_iterations, max_lg_iterations=1)
        state = j_ilqr.SolverState(_j(inputs["x"]), _j(inputs["u"]),
                                   _j(inputs["lam"]), jnp.asarray(mu_step))
        jparams = {k: _j(v) for k, v in params.items()}
        new, info = j_fn(state, state.x[0], jparams, cfg)
        msg = f"tick {tick}"
        assert got["mu_step"] == int(new.mu_step), msg
        # the JAX update reports no iteration count: capped at the port's
        # count n it ends where it ends uncapped, capped at n - 1 it does not
        n = got["iterations"]
        capped = [_flat(j_fn(state, state.x[0], jparams,
                             dict(cfg, max_iterations=c)))
                  for c in (n, n - 1)]
        full = _flat((new, info))
        assert np.array_equal(capped[0], full), msg
        assert n == 0 or not np.array_equal(capped[1], full), msg
        for k, w in (("x", new.x), ("u", new.u), ("lam", new.lam)):
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=0,
                                       atol=SOLVE_ATOL, err_msg=msg)
        np.testing.assert_allclose(got["traj_costs"],
                                   float(info["traj_costs"]),
                                   rtol=SOLVE_COST_RTOL, err_msg=msg)
        # warm start: the JAX result, shifted by one step, a new start
        x = np.asarray(new.x)
        inputs.update(x=np.concatenate([x[1:], x[-1:]]),
                      u=np.concatenate([np.asarray(new.u)[1:],
                                        np.asarray(new.u)[-1:]]),
                      lam=np.concatenate([np.asarray(new.lam)[1:],
                                          np.asarray(new.lam)[-1:]]))
        inputs["x"][0] += F32(0.05)
        mu_step = int(new.mu_step)
    assert ilqr_rstp.launches == before      # CPU tensors: no kernel


def test_rstp_wrappers_reject_bad_inputs():
    """The kernel wrappers check what they would hand a kernel, on every
    device: Euler only, the packed float32 layout, known problems, a
    mu_step of the schedule, an active length inside the horizon."""
    name, H = "velocity_profile_space", 20
    s = rstp_solver(name, H, H, "cpu", np.random.default_rng(0), False)
    buf = torch.from_numpy(ilqr_rstp.pack_inputs(
        name, s._inputs(), s.params._values, 0))
    run = (H, RSTP_N_REF, H, 2, 1)
    with pytest.raises(ValueError, match="EULER"):
        ilqr_rstp.update(name, buf, *run, integrator=1)
    with pytest.raises(ValueError, match="float32 vector"):
        ilqr_rstp.update(name, buf.double(), *run)
    with pytest.raises(ValueError, match="float32 vector"):
        ilqr_rstp.update(name, buf[:-1], *run)
    with pytest.raises(ValueError, match="no kernel"):
        ilqr_rstp.update("trajectory_tracking_mpc", buf, *run)
    with pytest.raises(ValueError, match="mu_step"):
        ilqr_rstp.pack_inputs(name, s._inputs(), s.params._values, 8)
    lim = torch.ones(H)
    one = torch.ones(())
    with pytest.raises(ValueError, match="active length"):
        rstp_rampify.scan(one, one, lim, H + 1, *([one] * 6))
    with pytest.raises(ValueError, match="float32"):
        rstp_rampify.scan(one, one, lim.double(), H, *([one] * 6))


# ---------------------------------------------------------------------
# the whole fused step, from a common carry


RECORD_TICKS = 30
RECORD_STEPS = (0, 1, 12, 28)


def _record_jax_loop(scenario):
    """The JAX package's closed loop with the scenario's own param sets
    (fused RSTP, H=250); per fused step, the carry it started from, its
    packed inputs and its outputs, as numpy."""
    np.random.seed(0)
    sim = JSimStandalone(app_id=uuid.uuid4().hex[:8], scenario_path=scenario)
    controllers = sim.control_app.sh_controllers
    with controllers.lock():
        controllers.model_predictive_controller.params.horizon = 20
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    planner = sim.planning_app.planners["path_vel_decomp_planner"]
    rec = []

    def recording(step):
        def run(carry, inp):
            c = jax.tree.map(np.array, carry)
            new, out = step(carry, inp)
            rec.append((c, {k: np.array(v) for k, v in inp.items()},
                        jax.tree.map(np.array, out)))
            return new, out
        return run

    # the planner's own fused step, built ahead of the first tick so that
    # the cold step is recorded too
    planner.fused = j_fr.FusedRstpReplan(horizon_max=RSTP_H)
    planner.fused._step = recording(planner.fused._step)
    for _ in range(RECORD_TICKS):
        sim.update()
    # the first tick builds the local map and plans from the second on
    assert planner.fused.H == RSTP_H and len(rec) == RECORD_TICKS - 1
    return rec


@pytest.mark.parametrize("scenario", ["demo/country_follow",
                                      "demo/country_overtake"])
def test_fused_step_matches_jax(scenario):
    rec = _record_jax_loop(scenario)
    tf = t_fr.FusedRstpReplan(horizon_max=RSTP_H)
    step = t_fr.make_fused_step(RSTP_H)
    leaders = 0
    for k in RECORD_STEPS:
        carry, inp, want = rec[k]
        tf.load_carry(carry, np.zeros(2))
        _, out = step(tf._carry, inp)
        got = t_fr.unpack_outputs(out.numpy().astype(np.float64), RSTP_H)
        T = int(inp["scal_i"][0])
        msg = f"{scenario} step {k}"
        np.testing.assert_allclose(got["opt_path"][:T], want["opt_path"][:T],
                                   rtol=0, atol=PATH_ATOL, err_msg=msg)
        np.testing.assert_allclose(got["scals"][:2], want["scals"][:2],
                                   rtol=0, atol=LEADER_ATOL, err_msg=msg)
        # v_opt, v_lim, the reference profile
        for col in (0, 1, 4):
            np.testing.assert_allclose(got["prof"][:T, col],
                                       want["prof"][:T, col], rtol=0,
                                       atol=PROFILE_ATOL, err_msg=msg)
        np.testing.assert_array_equal(got["prof"][:T, 2],
                                      want["prof"][:T, 2], err_msg=msg)
        leaders += want["scals"][0] < 1e5
    assert leaders >= 2             # the leader branch was compared


# ---------------------------------------------------------------------
# the planner on one open-loop world

JAX_APPS = dict(EnvironmentApp=JEnvironmentApp, PlanningApp=JPlanningApp,
                DynamicObject=JDynamicObject,
                load_env_params=j_load_env_params,
                load_map_store=j_load_map_store)
TORCH_APPS = dict(EnvironmentApp=EnvironmentApp, PlanningApp=PlanningApp,
                  DynamicObject=DynamicObject,
                  load_env_params=load_env_params,
                  load_map_store=load_map_store)
PLAN_H = 100
PLAN_TICKS = 5


@pytest.mark.parametrize("use_fused,smooth_only", [
    pytest.param(True, False, id="True"),
    pytest.param(False, False, id="False"),
    pytest.param(False, True, id="smooth_only")])
def test_planner_matches_jax(use_fused, smooth_only):
    world = ScenarioWorld("demo/country_follow")
    tag = uuid.uuid4().hex[:8]
    stacks = [SliceStack(apps, world, p + tag,
                         planner="path_vel_decomp_planner")
              for apps, p in ((JAX_APPS, "j"), (TORCH_APPS, "t"))]
    for st in stacks:
        store = st.planning_app.sh_planners
        with store.lock():
            store.path_vel_decomp_planner.params.horizon = PLAN_H
            store.path_vel_decomp_planner.params.use_fused = use_fused
            store.path_vel_decomp_planner.params.smooth_only = smooth_only
            # the smoother's own horizon too (the velocity solve takes its
            # path)
            store.path_vel_decomp_planner.params.path_smoothing.horizon = \
                PLAN_H
    if smooth_only:
        # Both packages' smoothing and velocity solves in float64: in
        # float32 the two smoothing solves part by a rounding of the
        # curvature (~1e-5 after 5 iterations), and the velocity solve of
        # either package turns a 1e-5 change of its curvature table into
        # m/s (JAX's own smoothed path with 1e-5 of noise moves the port's
        # profile by 5.7 m/s; without the noise the two agree to 8e-4).
        for st, f64 in zip(stacks, (jnp.float64, torch.float64)):
            for opt in (st.planner.path_smoothing.opt,
                        st.planner.velocity_optim.opt):
                opt.dtype = f64
    for k in range(PLAN_TICKS):
        t = round(0.1 * k, 5)
        jt, tt = (st.step(t) for st in stacks)
        assert tt.emergency == jt.emergency, k
        assert len(tt.x) == len(jt.x) > 0, k
        for f in ("time", "x", "y", "orientation", "velocity"):
            np.testing.assert_allclose(np.asarray(getattr(tt, f)),
                                       np.asarray(getattr(jt, f)), rtol=0,
                                       atol=PLAN_ATOL, err_msg=f"{f} {k}")
    planners = [st.planner for st in stacks]
    assert (planners[1].fused is not None) == use_fused
    leaders = [p.velocity_optim.s_leader for p in planners]
    assert leaders[1] == pytest.approx(leaders[0], abs=LEADER_ATOL)
    assert leaders[1] < 1e5         # the leader was seen and followed
