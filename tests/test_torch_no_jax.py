"""The port never imports JAX or the JAX package: checked in a fresh
interpreter after ``import tpl_tpu_torch``, after one CPU planning tick of
the slice and after a few closed-loop ticks of the port's
``SimStandalone``, and statically over the port's sources."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
def leaked():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tpl_tpu"))
import tpl_tpu_torch
assert not leaked(), ("import", leaked())
from tpl_tpu_torch.application import EnvironmentApp, PlanningApp
from tpl_tpu_torch.application.environment_app import load_env_params
from tpl_tpu_torch.environment import DynamicObject, load_map_store
from tpl_tpu_torch.scenario_world import ScenarioWorld, SliceStack
tpl_tpu_torch.use_device("cpu")
apps = dict(EnvironmentApp=EnvironmentApp, PlanningApp=PlanningApp,
            DynamicObject=DynamicObject, load_env_params=load_env_params,
            load_map_store=load_map_store)
st = SliceStack(apps, ScenarioWorld(), "nojax",
                grid=dict(t_steps=4, s_steps=41, s_max=40.0, ds_steps=5,
                          ds_max=16.0, l_steps=7))
st.step(0.0)
st.step(0.1)
assert st.planner.traj_dp is not None
assert not leaked(), ("tick", leaked())

from tpl_tpu_torch.simulation import SimStandalone
sim = SimStandalone(app_id="nojax_loop", scenario_path="demo/country_follow")
store = sim.planning_app.sh_planners
store.active_planner = "dp_lat_lon_planner"
for cpp in (store.dp_lat_lon_planner.params.planner.cpp,
            store.dp_lat_lon_planner.params.env.cpp):
    for k, v in dict(t_steps=4, s_steps=41, s_max=40.0, ds_steps=5,
                     ds_max=16.0, l_steps=7).items():
        if hasattr(cpp, k):
            setattr(cpp, k, v)
sim.control_app.sh_controllers.model_predictive_controller.params.horizon = 10
ss = sim.core.sh_state.sim
ss.settings.running = True
ss.settings.use_real_time = False
ss.rule_checker.enable = True
for _ in range(4):
    sim.update()
mpc = sim.control_app.controllers["model_predictive_controller"]
assert mpc.opt.iterations > 0, "the MPC never solved"
assert sim.core.sh_state.sim.rule_checker.violations == []
assert not leaked(), ("closed loop", leaked())
print("clean")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("clean")


@pytest.mark.parametrize("path", ["tpl_tpu_torch", "chip_smoke.py"])
def test_sources_name_no_jax(path):
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tpl_tpu)\b(?!_torch)",
                     re.M)
    root = os.path.join(REPO, path)
    files = [root] if root.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            assert not bad.search(fh.read()), f
