"""The closed loop through ``SimStandalone``: the JAX package's and the
port's, in lock step on ``demo/country_follow`` with the demo control set's
``model_predictive_controller``, once per planner:

- ``dp_lat_lon_planner``: 60 ticks of 0.01 s; for test speed the DP grid is
  cut to T=6, S=61, DS=9, L=11 on both sides;
- ``path_vel_decomp_planner``, the vendored planning set's own (RSTP,
  ``use_fused``, replanning every tick): 30 ticks of 0.01 s; for test speed
  its horizon is cut from 250 to 100 steps (50 m, so the leader ~43 m ahead
  is in it) on both sides.  Its collision screen is off on both sides: on
  this scenario it latches the hard brake from t=0.04 s on for a second in
  both packages, and the MPC would track no RSTP plan in the window
  (tests/test_torch_rstp.py holds the screen's flag to the JAX one).

Both sims run with ``use_real_time = False`` and the rule checker on, the
MPC horizon cut to 20 steps (of the demo set's 60) on both sides.

Tolerances: replan times exactly and zero rule violations on both sides.
The DP and RSTP solves are float32 on both sides and their trajectories
agree to 1e-3 (tests/test_torch_slice.py, tests/test_torch_rstp.py); the
float64 MPC tracks that plan, and a 1e-3 shift of the plan moves the
tracking controls and, through 0.6 s of integration, the ego pose by about
as much.  So ego x, y, v and the controls are held to atol=1e-3.
(Measured on the DP configuration: the two loops agree to ~1e-10, since
the two DP solves pick the same actions.)
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
RSTP = "path_vel_decomp_planner"
RSTP_HORIZON = 100
RSTP_TICKS = 30


def make_sim(cls, planner=PLANNER, grid=GRID, horizon=HORIZON):
    """A sim on demo/country_follow.  The DP planner is made active with
    ``grid``; the RSTP planner is the scenario's own set, cut to
    RSTP_HORIZON, its collision screen off."""
    sim = cls(app_id=uuid.uuid4().hex[:8],
              scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        if planner == RSTP:
            assert store.active_planner == RSTP
            params = store.path_vel_decomp_planner.params
            assert params.use_fused
            params.horizon = RSTP_HORIZON
            params.collision_screen = False
        else:
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


def _observe(sim, planner):
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        ego = (s.ego.x, s.ego.y, s.ego.yaw, s.ego.v, s.ego.a,
               s.ego.steer_angle)
        out = dict(t=s.t, ego=np.array(ego),
                   violations=list(s.rule_checker.violations))
    with sim.control_app.sh_controllers.lock():
        out["controls"] = np.array(sim.control_app.sh_controllers.controls)
    with sim.planning_app.sh_planners.lock():
        traj = sim.planning_app.sh_planners.trajectory
        out["emergency"] = traj.emergency
        # the RSTP planner replans every tick: its plan's first time stamp
        # is the tick's time
        out["replan"] = (float(traj.time[0]) if len(traj.time) else -1.0) \
            if planner == RSTP else \
            sim.planning_app.planners[planner].policy.last_replan_time
    return out


@pytest.fixture(scope="module", params=[PLANNER, RSTP])
def run(request):
    planner = request.param
    tpl_tpu_torch.use_device("cpu")
    np.random.seed(0)
    js = make_sim(JSimStandalone, planner)
    ts = make_sim(SimStandalone, planner)
    ticks = []
    for _ in range(RSTP_TICKS if planner == RSTP else TICKS):
        js.update()
        ts.update()
        ticks.append((_observe(js, planner), _observe(ts, planner)))
    mpc = ts.control_app.controllers["model_predictive_controller"]
    assert mpc.opt.horizon == HORIZON
    if planner == RSTP:
        fused = ts.planning_app.planners[RSTP].fused
        assert fused.H == RSTP_HORIZON and fused.steps == len(ticks) - 1
    return ticks


def test_clock_and_replans_agree(run):
    replans = set()
    for k, (j, t) in enumerate(run):
        assert t["t"] == j["t"], k
        assert t["replan"] == j["replan"], k
        replans.add(t["replan"])
    assert run[-1][1]["t"] == pytest.approx(0.01 * (len(run) - 1))
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
