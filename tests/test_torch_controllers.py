"""The four controllers the port gained beside the spatial MPC, held against
the JAX package's: the time-indexed MPC, the feedforward, the flat and the
direct controller.

- The control stage in isolation: the JAX package's ``ControlApp`` and the
  port's, each with one of the four controllers active, fed the same
  recorded ``ControlInput`` sequence tick by tick (as
  tests/test_torch_mpc.py does for the spatial MPC).  The inputs are
  recorded from the JAX package's closed loop on ``demo/country_follow``
  (dp_lat_lon_planner, DP grid cut to T=6, S=61, DS=9, L=11).  Each runs
  once as recorded and once with a steering dead time of 0.05 s added to the
  recorded vehicle states, so that ``compensate_dead_time`` (feedforward,
  flat) and the solver's dead-time rollforward (time MPC) run.  The time
  MPC's carried state is re-synchronised from the JAX controller after each
  tick (``load_state``: the solver's warm start through
  ``Solver.load_state``, the command log, the last controls), since its
  line search's acceptance at convergence is decided by rounding; each
  tick is then a solve from the same state on both sides.
- Carrying a host controller's state across (``load_state``): a fresh
  port controller takes the JAX one's state in the middle of the sequence
  and continues it exactly.
- ``control/openloop.py``'s four functions against the JAX ones on seeded
  inputs, with an empty log and an empty window among them.
- The port's time MPC at UTM magnitude (tests/test_mpc_tracking.py:86).

Tolerances: the time MPC (float64 solves on both sides) controls atol
1e-8, its predicted trajectory atol 1e-6; the direct and flat controllers
exactly; the feedforward controller atol 1e-9 (its projections take the
port's C route, the JAX package's its own).
"""

import contextlib
import copy
import uuid

import numpy as np
import pytest

from tpl_tpu.application import ControlApp as JControlApp
from tpl_tpu.control import openloop as jol
from tpl_tpu.environment import VehicleState as JVehicleState
from tpl_tpu.planning import Trajectory as JTrajectory
from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.application import ControlApp
from tpl_tpu_torch.control import (
    DirectController, FeedforwardController, FlatController,
    ModelPredictiveControllerTime)
from tpl_tpu_torch.control import openloop as tol
from tpl_tpu_torch.environment import VehicleState
from tpl_tpu_torch.planning import Trajectory
from tpl_tpu_torch.util import Bundle

GRID = dict(t_steps=6, s_steps=61, s_max=60.0, ds_steps=9, ds_max=16.0,
            l_steps=11)
TICKS = 20
DEAD_TIME = 0.05
TIME_MPC = "model_predictive_controller_time"
# controller -> (controls atol, predicted trajectory atol)
TOL = {TIME_MPC: (1e-8, 1e-6), "feedforward_controller": (1e-9, 1e-9),
       "flat_controller": (0.0, 0.0), "direct_controller": (0.0, 0.0)}
HOST = ("feedforward_controller", "flat_controller", "direct_controller")


@pytest.fixture(scope="module")
def recorded():
    """(t, vehicle, trajectory) of each tick of the JAX closed loop."""
    np.random.seed(0)
    sim = JSimStandalone(app_id=uuid.uuid4().hex[:8],
                         scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = "dp_lat_lon_planner"
        params = store.dp_lat_lon_planner.params
        for cpp in (params.planner.cpp, params.env.cpp):
            for k, v in GRID.items():
                if hasattr(cpp, k):
                    setattr(cpp, k, v)
    with sim.core.sh_state.lock():
        sim.core.sh_state.sim.settings.running = True
        sim.core.sh_state.sim.settings.use_real_time = False
    out = []
    for _ in range(TICKS):
        sim.update()
        ci = sim.control_app.sh_input
        with ci.lock():
            out.append((ci.t, copy.deepcopy(vars(ci.vehicle)),
                        copy.deepcopy(vars(ci.trajectory))))
    assert sum(len(tr["time"]) >= 2 for _, _, tr in out) >= TICKS - 2
    return out


def _apps(name):
    tpl_tpu_torch.use_device("cpu")
    tag = uuid.uuid4().hex[:8]
    sides = ((JControlApp("j" + tag, "demo"), JVehicleState, JTrajectory),
             (ControlApp("t" + tag, "demo"), VehicleState, Trajectory))
    for app, _, _ in sides:
        with app.sh_controllers.lock():
            app.sh_controllers.active_controller = name
    return sides


def _feed(side, t, veh, traj):
    app, veh_cls, traj_cls = side
    v = veh_cls()
    v.__dict__.update(copy.deepcopy(veh))
    tr = traj_cls()
    tr.__dict__.update(copy.deepcopy(traj))
    with app.sh_input.lock():
        app.sh_input.t, app.sh_input.vehicle, app.sh_input.trajectory = \
            t, v, tr
    app.update()
    with app.sh_controllers.lock():
        return (np.array(app.sh_controllers.controls),
                app.sh_controllers.control_trajectory)


def _check_tick(name, k, jc, jtr, tc, ttr):
    ctrl_tol, traj_tol = TOL[name]
    assert np.all(np.isfinite(tc))
    np.testing.assert_allclose(tc, jc, rtol=0, atol=ctrl_tol,
                               err_msg=f"{name} tick {k}")
    for field in ("time", "x", "y", "orientation", "velocity",
                  "acceleration"):
        a = getattr(jtr, field, None)
        if a is None or (field != "x" and name in HOST):
            continue
        np.testing.assert_allclose(
            np.asarray(getattr(ttr, field)), np.asarray(a), rtol=0,
            atol=traj_tol, err_msg=f"{name} tick {k} {field}")


@pytest.mark.parametrize("dead_time", [0.0, DEAD_TIME])
@pytest.mark.parametrize("name", [TIME_MPC, "feedforward_controller",
                                  "flat_controller", "direct_controller"])
def test_control_app_matches_jax(recorded, name, dead_time):
    jside, tside = _apps(name)
    assert tside[0].registry.active_name() == name
    jctrl = jside[0].controllers[name]
    tctrl = tside[0].controllers[name]
    solved = 0
    for k, (t, veh, traj) in enumerate(recorded):
        veh = dict(veh, dead_time_steer=dead_time)
        jc, jtr = _feed(jside, t, veh, traj)
        tc, ttr = _feed(tside, t, veh, traj)
        _check_tick(name, k, jc, jtr, tc, ttr)
        solved += len(traj["time"]) >= 2
        if name == TIME_MPC:
            assert tctrl.opt._mu_step == jctrl.opt._mu_step, f"tick {k}"
            np.testing.assert_allclose(tctrl.opt.traj_costs,
                                       jctrl.opt.traj_costs, rtol=1e-12,
                                       err_msg=f"tick {k}")
            if dead_time:
                np.testing.assert_allclose(
                    tctrl.dead_time_trajectory, jctrl.dead_time_trajectory,
                    rtol=0, atol=TOL[name][1], err_msg=f"tick {k}")
            tctrl.load_state(jctrl)
    assert solved >= len(recorded) - 2
    if name == TIME_MPC:
        assert tctrl.opt.updates >= len(recorded) - 2
        if dead_time:
            assert len(tctrl.dead_time_trajectory) == 6
    elif name != "direct_controller" and dead_time:
        # the dead-time window replayed the logged commands
        assert len(tctrl.log.rows) >= len(recorded) - 3
        assert tctrl.log.rows == jctrl.log.rows


@pytest.mark.parametrize("name", HOST)
def test_load_state_carries_a_host_controller(recorded, name):
    """A port controller that starts in the middle of the sequence from the
    JAX one's state (``load_state``) continues it exactly."""
    jside, _ = _apps(name)
    mid = len(recorded) // 2
    for t, veh, traj in recorded[:mid]:
        _feed(jside, t, dict(veh, dead_time_steer=DEAD_TIME), traj)
    _, tside = _apps(name)
    tside[0].controllers[name].load_state(jside[0].controllers[name])
    for k, (t, veh, traj) in enumerate(recorded[mid:], mid):
        veh = dict(veh, dead_time_steer=DEAD_TIME)
        jc, jtr = _feed(jside, t, veh, traj)
        tc, ttr = _feed(tside, t, veh, traj)
        _check_tick(name, k, jc, jtr, tc, ttr)


# ---------------------------------------------------------------------
# control/openloop.py

def _log(module, rows):
    log = module.StampedLog(capacity=8)
    for row in rows:
        log.push(*row)
    return log


def _rows(rng, n):
    t = np.cumsum(rng.uniform(0.005, 0.02, n))
    return [(float(a), float(b), float(c)) for a, b, c in zip(
        t, rng.normal(0.0, 1.0, n), rng.normal(0.0, 0.2, n))]


@pytest.mark.parametrize("case", ["seeded", "empty_log", "empty_window",
                                  "over_capacity"])
def test_stamped_log_replay_matches_jax(case):
    rng = np.random.default_rng(3)
    rows = {"seeded": _rows(rng, 6), "empty_log": [],
            "empty_window": _rows(rng, 4),
            "over_capacity": _rows(rng, 13)}[case]
    t_from, t_to = (0.01, 0.01) if case == "empty_window" else (0.0, 0.12)
    jlog, tlog = _log(jol, rows), _log(tol, rows)
    assert tlog.rows == jlog.rows
    want = jlog.replay(t_from, t_to, 0.005)
    got = tlog.replay(t_from, t_to, 0.005)
    if case.startswith("empty"):
        assert want is None and got is None
        return
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 7])
@pytest.mark.parametrize("v_ch", [None, 32.0])
def test_rollout_bicycle_matches_jax(n, v_ch):
    rng = np.random.default_rng(n)
    state = [571172.0, 5364663.0, 0.3, 0.05, 9.0]
    accs, steers = rng.normal(0.0, 1.0, n), rng.normal(0.0, 0.1, n)
    want = jol.rollout_bicycle(state, accs, steers, 2.7, 0.005, v_ch)
    got = tol.rollout_bicycle(state, accs, steers, 2.7, 0.005, v_ch)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["seeded", "empty_log", "empty_window"])
def test_compensate_dead_time_matches_jax(case):
    rng = np.random.default_rng(5)
    rows = [] if case == "empty_log" else _rows(rng, 8)
    dead_time = 0.0 if case == "empty_window" else 0.05
    t = rows[-1][0] if rows else 0.1
    state = [10.0, -2.0, 0.1, 0.02, 6.0]
    want = jol.compensate_dead_time(_log(jol, rows), state, t, dead_time,
                                    0.005, 2.7, v_ch=32.0)
    got = tol.compensate_dead_time(_log(tol, rows), state, t, dead_time,
                                   0.005, 2.7, v_ch=32.0)
    np.testing.assert_array_equal(got, want)
    if case != "seeded":
        np.testing.assert_array_equal(got, state)


@pytest.mark.parametrize("tq", [-0.3, 0.0, 0.25, 0.8, 1.0, 1.7])
def test_lerp_extrap_matches_jax(tq):
    ts = np.array([0.0, 0.2, 0.5, 1.0])
    ys = np.array([1.0, -0.5, 2.0, 3.5])
    assert tol.lerp_extrap(tq, ts, ys) == jol.lerp_extrap(tq, ts, ys)
    # a single sample: no slope to extrapolate with
    assert tol.lerp_extrap(tq, ts[:1], ys[:1]) == jol.lerp_extrap(
        tq, ts[:1], ys[:1])


# ---------------------------------------------------------------------
# the time MPC at UTM magnitude (tests/test_mpc_tracking.py:86)

UTM_X = 571172.0
UTM_Y = 5364663.0


def test_time_mpc_no_utm_quantization():
    tpl_tpu_torch.use_device("cpu")
    heading, v, n = 0.3, 10.0, 200
    traj = Trajectory()
    traj.time = np.arange(n) * 0.1
    traj.x = UTM_X + np.cos(heading) * v * traj.time
    traj.y = UTM_Y + np.sin(heading) * v * traj.time
    traj.orientation = np.full(n, heading)
    traj.s = v * traj.time
    traj.curvature = np.zeros(n)
    traj.velocity = np.full(n, v)
    traj.acceleration = np.zeros(n)

    veh = VehicleState()
    veh.x, veh.y = UTM_X, UTM_Y
    veh.phi = heading
    veh.v = v

    shared = Bundle()

    @contextlib.contextmanager
    def lock_shared():
        yield

    ctrl = ModelPredictiveControllerTime(shared, lock_shared)
    con_input = Bundle(vehicle=veh, trajectory=traj)
    for i in range(5):
        con_input.t = i * 0.01
        (acc, steer), con_traj = ctrl.update(con_input)

    assert ctrl.opt.iterations > 0
    assert abs(steer) < 0.02
    normal = np.array([-np.sin(heading), np.cos(heading)])
    lat = (np.asarray(con_traj.x) - UTM_X) * normal[0] \
        + (np.asarray(con_traj.y) - UTM_Y) * normal[1]
    assert np.max(np.abs(lat)) < 0.1, np.max(np.abs(lat))
    # the solver's reference tables hold centred coordinates
    assert np.max(np.abs(ctrl.opt.params.ref_x)) < 200.0


def test_controllers_are_exported_and_registered():
    tpl_tpu_torch.use_device("cpu")
    app = ControlApp(uuid.uuid4().hex[:8], "demo")
    names = set(app.controllers)
    assert {"model_predictive_controller", TIME_MPC,
            "feedforward_controller", "flat_controller",
            "const_acc_controller", "direct_controller"} <= names
    for cls in (DirectController, FeedforwardController, FlatController,
                ModelPredictiveControllerTime):
        assert any(type(c) is cls for c in app.controllers.values())
    # the demo set's blocks reached the controllers' params
    with app.sh_controllers.lock():
        p = getattr(app.sh_controllers, TIME_MPC).params
        assert (p.horizon, p.step, p.max_iterations) == (40, 0.05, 20)
        assert app.sh_controllers.feedforward_controller.params \
            .use_stanley_law is True
