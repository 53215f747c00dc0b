"""The closed loop through ``SimStandalone`` with the graph DP planner
(``dp_poly_planner``): the JAX package's and the port's sims in lock step on
``demo/country_follow`` and ``demo/country_overtake``, the demo planning
set's own block (env 10 x 201 x 21 x 21 directions, graph 10 x 15 x 21,
two levels, a replan every second or when the collision screen forces one).

TICKS ticks of 0.01 s each: the replans at 0.0 and 0.01 s and the
screen-forced ones after 0.25 s.  ``use_real_time`` off, the rule checker
on, the MPC horizon cut to 20 steps (of the demo set's 60) on both sides,
as in tests/test_torch_fas_loop.py.  The port runs on the CPU, where every
kernel entry takes its plain version.

Tolerances: the clock and the replan times exactly; zero rule violations
and no emergency on both sides; ego x, y, yaw, v, a, steering angle and the
controls to atol=1e-3.  The edge costs part from the JAX ones by float32
roundings (tests/test_torch_dp_poly.py), the chosen edges are the same and
the float64 MPC tracks the same plan (measured: 2e-16 on country_follow,
5e-14 on country_overtake).
"""

import uuid

import numpy as np
import pytest
import torch

from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.planning.dyn_prog import dp_environment, poly_planner_kernel
from tpl_tpu_torch.simulation import SimStandalone

ATOL = 1e-3
HORIZON = 20
TICKS = 120
PLANNER = "dp_poly_planner"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on one torch thread: on a loaded host (the
    suite's parallel workers) torch's intra-op pool stalls on these large
    tensor programs, many times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_sim(cls, scenario):
    sim = cls(app_id=uuid.uuid4().hex[:8], scenario_path=scenario)
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = PLANNER
    controllers = sim.control_app.sh_controllers
    with controllers.lock():
        controllers.model_predictive_controller.params.horizon = HORIZON
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    return sim


def observe(sim):
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
    planner = sim.planning_app.planners[PLANNER]
    out["replan"] = planner.behavior.last_replan_time
    out["runtime"] = planner.runtime_planning
    return out


@pytest.fixture(scope="module",
                params=["demo/country_follow", "demo/country_overtake"])
def run(request):
    tpl_tpu_torch.use_device("cpu")
    js = make_sim(JSimStandalone, request.param)
    ts = make_sim(SimStandalone, request.param)
    ticks = []
    for _ in range(TICKS):
        js.update()
        ts.update()
        ticks.append((observe(js), observe(ts)))
    port = ts.planning_app.planners[PLANNER]
    assert type(port).__module__.startswith("tpl_tpu_torch.")
    return ticks


def test_clock_and_replan_times_agree(run):
    replans = set()
    for k, (j, t) in enumerate(run):
        assert t["t"] == j["t"], k
        assert t["replan"] == j["replan"], k
        replans.add(t["replan"])
    # the first replans and at least one forced by the collision screen
    assert {0.0, 0.01} <= replans and max(replans) >= 0.25, sorted(replans)
    assert run[-1][1]["runtime"] > 0.0


def test_no_violation_no_emergency(run):
    for k, (j, t) in enumerate(run):
        assert t["violations"] == [] and j["violations"] == [], k
        assert not t["emergency"] and not j["emergency"], k


def test_ego_and_controls_agree(run):
    for k, (j, t) in enumerate(run):
        assert np.all(np.isfinite(t["ego"]))
        np.testing.assert_allclose(t["ego"], j["ego"], rtol=0, atol=ATOL,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(t["controls"], j["controls"], rtol=0,
                                   atol=ATOL, err_msg=f"tick {k}")
    # the loop drives: the ego speeds up along the plan
    assert run[-1][1]["ego"][3] > 8.0


def test_the_planner_counts_no_kernel_launch_on_the_cpu(run):
    """On the CPU every entry takes its plain version: nothing launched."""
    assert dp_environment.dir_dist_launches == 0
    assert poly_planner_kernel.eval_launches == 0
    assert poly_planner_kernel.propagate_launches == 0
