"""The port's planner x controller smoke matrix: its counterpart of
tests/test_params_matrix.py (which needs the absent ``acc_2024/cv_3o``), on
``demo/country_follow``.

The port's ``SimStandalone`` runs one tick with every planner x controller
combination the registries hold, on the CPU, and none may raise.  For test
speed each planner runs at the cut grid the port's loop tests use
(tests/test_torch_no_jax.py); the MPCs' horizons are cut to 10 steps.
"""

import uuid

import numpy as np
import pytest

import tpl_tpu_torch
from tpl_tpu_torch.simulation import SimStandalone

DP_GRID = dict(t_steps=4, s_steps=41, s_max=40.0, ds_steps=5, ds_max=16.0,
               l_steps=7)
FAS_CUT = dict(s_max=40.0, s_steps=41, t_steps=4, v_steps=7, a_steps=4,
               path_steps=40, l_steps=11)
RSTP_HORIZON = 100


def _cut(obj, cut):
    for k, v in cut.items():
        if hasattr(obj, k):
            setattr(obj, k, v)


PLANNERS = ("base_planner", "path_vel_decomp_planner", "dp_lat_lon_planner",
            "poly_lat_dp_lon_planner", "dp_poly_planner", "lattice_planner",
            "idm_sampling_planner", "poly_sampling_planner")
CONTROLLERS = ("base_controller", "const_acc_controller", "direct_controller",
               "model_predictive_controller",
               "model_predictive_controller_time", "feedforward_controller",
               "flat_controller")


@pytest.fixture(scope="module")
def sim():
    """One standalone sim, every planner at its cut grid."""
    tpl_tpu_torch.use_device("cpu")
    np.random.seed(0)
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.path_vel_decomp_planner.params.horizon = RSTP_HORIZON
        dp = store.dp_lat_lon_planner.params
        for cpp in (dp.planner.cpp, dp.env.cpp):
            _cut(cpp, DP_GRID)
        for name in ("poly_lat_dp_lon_planner", "lattice_planner"):
            prm = getattr(store, name).params
            _cut(prm.env.cpp, FAS_CUT)
            for k in ("cpp_lat", "cpp_lon", "lat_sampling", "dyn_prog"):
                if hasattr(prm.planner, k):
                    _cut(getattr(prm.planner, k), FAS_CUT)
        gdp = store.dp_poly_planner.params
        _cut(gdp.dp_env, dict(t_steps=4, s_steps=41, s_max=40.0))
        _cut(gdp.dp_planner, dict(t_steps=4, ds_steps=5, l_steps=7,
                                  s_max=40.0))
    ctrl = sim.control_app.sh_controllers
    with ctrl.lock():
        ctrl.model_predictive_controller.params.horizon = 10
        ctrl.model_predictive_controller_time.params.horizon = 10
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    return sim


def test_every_planner_and_controller_is_registered(sim):
    assert tuple(sim.planning_app.planners) == PLANNERS
    assert tuple(sim.control_app.controllers) == CONTROLLERS


@pytest.mark.parametrize("planner", PLANNERS)
def test_planner_with_every_controller(sim, planner):
    store = sim.planning_app.sh_planners
    ctrl = sim.control_app.sh_controllers
    time_mpc = sim.control_app.controllers["model_predictive_controller_time"]
    solves = time_mpc.opt.updates
    for c in CONTROLLERS:
        with store.lock():
            store.active_planner = planner
        with ctrl.lock():
            ctrl.active_controller = c
        sim.update()   # must not raise
        with ctrl.lock():
            assert np.all(np.isfinite(ctrl.controls)), (planner, c)
    # the time MPC solved on every planner's plan (the base planner
    # publishes none)
    assert (time_mpc.opt.updates > solves) == (planner != "base_planner")
