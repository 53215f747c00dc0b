"""The closed loop through ``SimStandalone`` with the FAS-2025 planner chain:
the JAX package's and the port's sims in lock step on
``demo/country_follow``, once per planner of the chain:

- ``poly_lat_dp_lon_planner`` with the demo planning set's own block
  (lateral sweep 1 x 20 candidates, replanning every 0.5 s);
- ``lattice_planner`` with its defaults (21 x 13 candidates, a full replan
  every second).

TICKS ticks of 0.01 s each (three replans of the first planner, two of the
second).  For test speed the grids are cut on both sides: the lateral
samples and the lon and env grids to 60 m (61 stations), lon T=6, V=13,
A=5, P=60, env T=6, L=21.  ``use_real_time`` off, the rule checker on, the
MPC horizon cut to 20 steps (of the demo set's 60) on both sides, as in
tests/test_torch_closed_loop.py.  The port runs on the CPU, where every
kernel entry takes its plain version.

Tolerances: the clock and the replan times exactly; zero rule violations
and no emergency on both sides; ego x, y, yaw, v, a, steering angle and the
controls to atol=1e-3.  The lon solves are float32 on both sides and pick
the same jerks here; XLA's contracted multiply-adds move the trajectory by
~1e-7, the float64 MPC tracks it (measured: ~1e-7 on both planners).
"""

import uuid

import numpy as np
import pytest

from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.planning.dyn_prog import lon_kernel, poly_lat_kernel
from tpl_tpu_torch.simulation import SimStandalone

ATOL = 1e-3
HORIZON = 20
TICKS = 110
FAS = "poly_lat_dp_lon_planner"
LATTICE = "lattice_planner"
CUT_LAT = dict(s_max=60.0, s_steps=61)
CUT_LON = dict(t_steps=6, s_max=60.0, s_steps=61, v_steps=13, a_steps=5,
               path_steps=60)
CUT_ENV = dict(t_steps=6, s_max=60.0, s_steps=61, l_steps=21)


def make_sim(cls, planner):
    """A sim on demo/country_follow with ``planner`` active, its grids cut
    (CUT_*)."""
    sim = cls(app_id=uuid.uuid4().hex[:8],
              scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = planner
        params = getattr(store, planner).params
        if planner == FAS:
            lat, lon = params.planner.cpp_lat, params.planner.cpp_lon
        else:
            lat, lon = params.planner.lat_sampling, params.planner.dyn_prog
        for cpp, cut in ((lat, CUT_LAT), (lon, CUT_LON),
                         (params.env.cpp, CUT_ENV)):
            for k, v in cut.items():
                assert hasattr(cpp, k), k
                setattr(cpp, k, v)
    controllers = sim.control_app.sh_controllers
    with controllers.lock():
        controllers.model_predictive_controller.params.horizon = HORIZON
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    return sim


def observe(sim, planner):
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
    out["replan"] = sim.planning_app.planners[planner].policy.last_replan_time
    return out


@pytest.fixture(scope="module", params=[FAS, LATTICE])
def run(request):
    planner = request.param
    tpl_tpu_torch.use_device("cpu")
    js = make_sim(JSimStandalone, planner)
    ts = make_sim(SimStandalone, planner)
    ticks = []
    for _ in range(TICKS):
        js.update()
        ts.update()
        ticks.append((observe(js, planner), observe(ts, planner)))
    port = ts.planning_app.planners[planner]
    assert type(port).__module__.startswith("tpl_tpu_torch.")
    return planner, ticks


def test_clock_and_replan_times_agree(run):
    planner, ticks = run
    replans = set()
    for k, (j, t) in enumerate(ticks):
        assert t["t"] == j["t"], k
        assert t["replan"] == j["replan"], k
        replans.add(t["replan"])
    want = 3 if planner == FAS else 2
    assert len(replans - {-1.0}) >= want, sorted(replans)


def test_no_violation_no_emergency(run):
    _, ticks = run
    for k, (j, t) in enumerate(ticks):
        assert t["violations"] == [] and j["violations"] == [], k
        assert not t["emergency"] and not j["emergency"], k


def test_ego_and_controls_agree(run):
    _, ticks = run
    for k, (j, t) in enumerate(ticks):
        assert np.all(np.isfinite(t["ego"]))
        np.testing.assert_allclose(t["ego"], j["ego"], rtol=0, atol=ATOL,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(t["controls"], j["controls"], rtol=0,
                                   atol=ATOL, err_msg=f"tick {k}")
    # the loop drives: the ego keeps its speed while tracking the plan
    assert ticks[-1][1]["ego"][3] > 7.0


def test_the_chain_counts_no_kernel_launch_on_the_cpu(run):
    """On the CPU every entry takes its plain version: nothing launched."""
    assert lon_kernel.launches == 0 and poly_lat_kernel.launches == 0
