"""The control stage in isolation: the JAX package's ``ControlApp`` and the
port's, fed the same recorded ``ControlInput`` sequence tick by tick.

The inputs are recorded from the JAX package's closed loop on
``demo/country_follow`` (dp_lat_lon_planner, DP grid cut to T=6, S=61,
DS=9, L=11): per tick the control input's time, vehicle state and planned
trajectory.  Both apps load the demo control set (model_predictive_controller,
H=60, 20 iterations, float64).  A second run adds a steering dead time of
0.05 s to the recorded vehicle states, which the demo scenarios do not
have, so that the controller's dead-time rollforward runs.

Tolerances (float64 solves on both sides): controls atol=1e-8, predicted
trajectory (x, y, orientation, velocity) atol=1e-6.
"""

import copy
import uuid

import numpy as np
import pytest

from tpl_tpu.application import ControlApp as JControlApp
from tpl_tpu.environment import VehicleState as JVehicleState
from tpl_tpu.planning import Trajectory as JTrajectory
from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.application import ControlApp
from tpl_tpu_torch.environment import VehicleState
from tpl_tpu_torch.planning import Trajectory

CONTROL_ATOL = 1e-8
TRAJ_ATOL = 1e-6
GRID = dict(t_steps=6, s_steps=61, s_max=60.0, ds_steps=9, ds_max=16.0,
            l_steps=11)
TICKS = 20


def cut_grid(store, grid=GRID, planner="dp_lat_lon_planner"):
    """Select the DP planner and cut its grid (planning and env params)."""
    with store.lock():
        store.active_planner = planner
        params = getattr(store, planner).params
        for cpp in (params.planner.cpp, params.env.cpp):
            for k, v in grid.items():
                if hasattr(cpp, k):
                    setattr(cpp, k, v)


@pytest.fixture(scope="module")
def recorded():
    """(t, vehicle, trajectory) of each tick of the JAX closed loop."""
    np.random.seed(0)
    sim = JSimStandalone(app_id=uuid.uuid4().hex[:8],
                         scenario_path="demo/country_follow")
    cut_grid(sim.planning_app.sh_planners)
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


def _apps():
    tpl_tpu_torch.use_device("cpu")
    tag = uuid.uuid4().hex[:8]
    return (JControlApp("j" + tag, "demo"), JVehicleState, JTrajectory), \
        (ControlApp("t" + tag, "demo"), VehicleState, Trajectory)


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


@pytest.mark.parametrize("dead_time", [0.0, 0.05])
def test_control_app_matches_jax(recorded, dead_time):
    jside, tside = _apps()
    assert tside[0].registry.active_name() == "model_predictive_controller"
    ticks = recorded if dead_time == 0.0 else recorded[:6]
    solved = 0
    for k, (t, veh, traj) in enumerate(ticks):
        veh = dict(veh, dead_time_steer=dead_time)
        jc, jtr = _feed(jside, t, veh, traj)
        tc, ttr = _feed(tside, t, veh, traj)
        assert np.all(np.isfinite(tc))
        np.testing.assert_allclose(tc, jc, rtol=0, atol=CONTROL_ATOL,
                                   err_msg=f"tick {k}")
        for name in ("time", "x", "y", "orientation", "velocity"):
            np.testing.assert_allclose(
                np.asarray(getattr(ttr, name)), np.asarray(getattr(jtr, name)),
                rtol=0, atol=TRAJ_ATOL, err_msg=f"tick {k} {name}")
        solved += len(traj["time"]) >= 2
    assert solved >= len(ticks) - 2
    jmpc = jside[0].controllers["model_predictive_controller"]
    tmpc = tside[0].controllers["model_predictive_controller"]
    assert tmpc.opt._mu_step == jmpc.opt._mu_step
    if dead_time:
        np.testing.assert_allclose(tmpc.dead_time_trajectory,
                                   jmpc.dead_time_trajectory, rtol=0,
                                   atol=TRAJ_ATOL)
        assert len(tmpc.dead_time_trajectory) > 1


def test_emergency_routes_to_const_acc(recorded):
    """An emergency plan bypasses the MPC: the constant-deceleration
    fallback brakes on both sides alike."""
    jside, tside = _apps()
    t, veh, traj = recorded[-1]
    traj = dict(traj, emergency=True)
    jc, jtr = _feed(jside, t, veh, traj)
    tc, ttr = _feed(tside, t, veh, traj)
    assert tc[0] == -6.0
    np.testing.assert_array_equal(tc, jc)
    for name in ("x", "y", "velocity", "s"):
        np.testing.assert_allclose(getattr(ttr, name), getattr(jtr, name),
                                   rtol=0, atol=1e-12)
