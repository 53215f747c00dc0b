"""The closed loop through ``SimStandalone``: the JAX package's and the
port's, in lock step on ``demo/country_follow`` with ``dp_lat_lon_planner``
and the demo control set's ``model_predictive_controller``.

Both sims run 60 ticks of 0.01 s (``use_real_time = False``) with the rule
checker on.  For test speed the DP grid is cut to T=6, S=61, DS=9, L=11 and
the MPC horizon to 20 steps (of the demo set's 60), on both sides.

Tolerances: replan times exactly and zero rule violations on both sides.
The DP solve is float32 on both sides and its trajectories agree to 1e-3
(tests/test_torch_slice.py); the float64 MPC tracks that plan, and a 1e-3
shift of the plan moves the tracking controls and, through 0.6 s of
integration, the ego pose by about as much.  So ego x, y, v and the
controls are held to atol=1e-3.  (Measured on this configuration: the two
loops agree to ~1e-10, since the two DP solves pick the same actions.)
"""

import uuid

import numpy as np
import pytest

from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.simulation import SimStandalone

ATOL = 1e-3
GRID = dict(t_steps=6, s_steps=61, s_max=60.0, ds_steps=9, ds_max=16.0,
            l_steps=11)
HORIZON = 20
TICKS = 60
PLANNER = "dp_lat_lon_planner"


def make_sim(cls, planner=PLANNER, grid=GRID, horizon=HORIZON):
    sim = cls(app_id=uuid.uuid4().hex[:8],
              scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = planner
        params = getattr(store, planner).params
        for cpp in (params.planner.cpp, params.env.cpp):
            for k, v in grid.items():
                if hasattr(cpp, k):
                    setattr(cpp, k, v)
    controllers = sim.control_app.sh_controllers
    with controllers.lock():
        controllers.model_predictive_controller.params.horizon = horizon
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    return sim


def _observe(sim):
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        ego = (s.ego.x, s.ego.y, s.ego.yaw, s.ego.v, s.ego.a,
               s.ego.steer_angle)
        out = dict(t=s.t, ego=np.array(ego),
                   violations=list(s.rule_checker.violations))
    with sim.control_app.sh_controllers.lock():
        out["controls"] = np.array(sim.control_app.sh_controllers.controls)
    with sim.planning_app.sh_planners.lock():
        out["emergency"] = sim.planning_app.sh_planners.trajectory.emergency
    out["replan"] = sim.planning_app.planners[PLANNER].policy.last_replan_time
    return out


@pytest.fixture(scope="module")
def run():
    tpl_tpu_torch.use_device("cpu")
    np.random.seed(0)
    js, ts = make_sim(JSimStandalone), make_sim(SimStandalone)
    ticks = []
    for _ in range(TICKS):
        js.update()
        ts.update()
        ticks.append((_observe(js), _observe(ts)))
    mpc = ts.control_app.controllers["model_predictive_controller"]
    assert mpc.opt.horizon == HORIZON
    return ticks


def test_clock_and_replans_agree(run):
    replans = set()
    for k, (j, t) in enumerate(run):
        assert t["t"] == j["t"], k
        assert t["replan"] == j["replan"], k
        replans.add(t["replan"])
    assert run[-1][1]["t"] == pytest.approx(0.59)
    assert len(replans - {-1.0}) >= 2


def test_ego_and_controls_agree(run):
    for k, (j, t) in enumerate(run):
        assert np.all(np.isfinite(t["ego"])) and np.all(
            np.isfinite(t["controls"]))
        np.testing.assert_allclose(t["ego"], j["ego"], rtol=0, atol=ATOL,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(t["controls"], j["controls"], rtol=0,
                                   atol=ATOL, err_msg=f"tick {k}")
    # the loop drives: the ego keeps its speed while tracking the plan
    assert run[-1][1]["ego"][3] > 4.0
    assert np.any(run[-1][1]["controls"] != 0.0)


def test_no_violations_no_emergency(run):
    for k, (j, t) in enumerate(run):
        assert j["violations"] == [] and t["violations"] == [], k
        assert not j["emergency"] and not t["emergency"], k


def test_planner_error_propagates():
    """A planner exception leaves SimStandalone.update: a CUDA fault
    poisons the context, so the port does not latch an emergency and
    rebuild the planner as the JAX package's PlanningApp does."""
    tpl_tpu_torch.use_device("cpu")
    sim = make_sim(SimStandalone)
    sim.update()
    planner = sim.planning_app.planners[PLANNER]

    def broken(env):
        raise RuntimeError("CUDA error: an illegal memory access")

    planner.update = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sim.update()
