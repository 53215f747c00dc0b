"""The port never imports JAX or the JAX package: checked in a fresh
interpreter after ``import tpl_tpu_torch``, after one CPU planning tick of
the slice, after a few closed-loop ticks of the port's ``SimStandalone``
and a tick with each of the time-indexed MPC, the feedforward, the flat and
the direct controller (the recorder, replay, ``tplsim`` and the live
reloader imported),
after the host C routes were built and called, after a batched update,
after two ticks of each FAS-2025 planner, after two ticks of each
rollout planner (IDM sampling, poly sampling) and after two ticks of the
graph DP planner (``dp_poly_planner``), after one sympy problem was
translated (``genopt``, ``optimizers`` and the examples imported) and one
scenario batch was solved by ``sharded_latlon_batch`` on a CPU mesh, and
statically over the port's sources (the graph DP planner's, the sympy front
end's and the scale-out layer's modules named on their own),
``chip_smoke.py``, the card tests it imports and the worker of the
two-process scale-out test.  The multi-process deployment's modules (the
shared-memory stores, the mains, ``SimAttach``, the GUI and the scene
renderer) import, and a shared store round-trips, with ``jax``, ``jaxlib``
and ``tpl_tpu`` blocked from import; their sources are scanned with the
helper of the multi-process tests."""

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

from tpl_tpu_torch.control import (DirectController, FeedforwardController,
                                   FlatController,
                                   ModelPredictiveControllerTime)
from tpl_tpu_torch.optim import ilqr_tracking_mpc_time
from tpl_tpu_torch.simulation import (SimRecorder, SimReplay, load_recording,
                                      tplsim)
from tpl_tpu_torch.util import hotreload
ctrl = sim.control_app.sh_controllers
ctrl.model_predictive_controller_time.params.horizon = 10
for name in ("model_predictive_controller_time", "feedforward_controller",
             "flat_controller", "direct_controller"):
    ctrl.active_controller = name
    sim.update()
    assert sim.control_app.registry.active_name() == name
tmpc = sim.control_app.controllers["model_predictive_controller_time"]
assert isinstance(tmpc, ModelPredictiveControllerTime)
assert tmpc.opt.updates > 0, "the time MPC never solved"
assert ilqr_tracking_mpc_time.launches == 0
assert not leaked(), ("the four controllers", leaked())

import numpy as np
import torch
from tpl_tpu_torch import native
from tpl_tpu_torch.ops import geometry
from tpl_tpu_torch.optim import batched, ilqr, problems
assert native.enabled() and native.get_lib() is not None
assert native.calls["project"] > 0, "the loop never took the C route"
pts = np.column_stack([np.arange(8.0), np.zeros(8)])
assert geometry.resample(pts, 0.5, 6).shape == (6, 5)
assert native.calls["resample"] > 0
prob, _ = problems.ref_line_smoother_k(ref_capacity=16)
upd = batched.make_batched_update_fn(prob, 5, 2, ilqr.EULER, torch.float64)
x, u, lam, mu = batched.init_batch(prob, 5, 2, torch.float64, "cpu")
f = lambda *a: torch.tensor(a, dtype=torch.float64)
params = dict(w_pos=f(1.0)[0], w_k=f(0.1)[0], ref_step=f(0.5)[0],
              ref_x=torch.arange(16.0, dtype=torch.float64) * 0.5,
              ref_y=torch.zeros(16, dtype=torch.float64))
cfg = dict(u_min=torch.full((5, 1), -1.0, dtype=torch.float64),
           u_max=torch.full((5, 1), 1.0, dtype=torch.float64),
           barrier_weight=f(1.0), lg_mult_limit=f(1e30), dt=f(0.5)[0],
           min_rel_cost_change=f(1e-6)[0], T=5, max_iterations=3,
           max_lg_iterations=1)
out = upd(x, u, lam, mu, torch.zeros((3, 2), dtype=torch.float64) + 0.1,
          params, cfg)
assert out[0].shape == (6, 3, 2) and bool(torch.isfinite(out[0]).all())
assert not leaked(), ("native and batched", leaked())

from tpl_tpu_torch.ops import jgeometry, splines
from tpl_tpu_torch.planning import LatticePlanner, PolyLatDpLonPlanner
cut = dict(s_max=40.0, s_steps=41, t_steps=4, v_steps=7, a_steps=4,
           path_steps=40, l_steps=11)
for name in ("poly_lat_dp_lon_planner", "lattice_planner"):
    sim = SimStandalone(app_id="nojax_" + name,
                        scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    store.active_planner = name
    prm = getattr(store, name).params
    for cpp in (prm.env.cpp, *(getattr(prm.planner, k) for k in (
            "cpp_lat", "cpp_lon", "lat_sampling", "dyn_prog")
            if hasattr(prm.planner, k))):
        for k, v in cut.items():
            if hasattr(cpp, k):
                setattr(cpp, k, v)
    sim.control_app.sh_controllers.model_predictive_controller.params \
        .horizon = 10
    ss = sim.core.sh_state.sim
    ss.settings.running = True
    ss.settings.use_real_time = False
    for _ in range(2):
        sim.update()
    assert sim.planning_app.planners[name].traj_lon is not None, name
assert not leaked(), ("poly chain", leaked())

from tpl_tpu_torch.planning import IdmSamplingPlanner, PolySamplingPlanner
from tpl_tpu_torch.planning.idm_sampling import idm_kernel
from tpl_tpu_torch.planning.poly_sampling import poly_kernel
for name, scenario in (("idm_sampling_planner", "demo/country_overtake"),
                       ("poly_sampling_planner", "demo/country_follow")):
    sim = SimStandalone(app_id="nojax_" + name, scenario_path=scenario)
    store = sim.planning_app.sh_planners
    store.active_planner = name
    sim.control_app.sh_controllers.model_predictive_controller.params \
        .horizon = 10
    ss = sim.core.sh_state.sim
    ss.settings.running = True
    ss.settings.use_real_time = False
    planner = sim.planning_app.planners[name]
    # the poly sampler replans every 0.2 s: make its second tick a replan
    planner.last_update_time = -1.0
    for _ in range(2):
        sim.update()
    done = planner.traj_np if name.startswith("idm") else planner.poly_traj
    assert done is not None, name
    assert isinstance(planner, (IdmSamplingPlanner, PolySamplingPlanner))
assert idm_kernel.rollout_launches == idm_kernel.evaluate_launches == 0
assert poly_kernel.launches == 0
assert not leaked(), ("rollout planners", leaked())

from tpl_tpu_torch.planning import DpPolyPlanner
from tpl_tpu_torch.planning.dyn_prog import dp_environment, poly_planner_kernel
sim = SimStandalone(app_id="nojax_dp_poly", scenario_path="demo/country_follow")
store = sim.planning_app.sh_planners
store.active_planner = "dp_poly_planner"
prm = store.dp_poly_planner.params
for cpp, cut in ((prm.dp_env, dict(t_steps=4, s_steps=41, s_max=40.0)),
                 (prm.dp_planner, dict(t_steps=4, ds_steps=5, l_steps=7,
                                       s_max=40.0))):
    for k, v in cut.items():
        assert hasattr(cpp, k), k
        setattr(cpp, k, v)
sim.control_app.sh_controllers.model_predictive_controller.params.horizon = 10
ss = sim.core.sh_state.sim
ss.settings.running = True
ss.settings.use_real_time = False
for _ in range(2):
    sim.update()
planner = sim.planning_app.planners["dp_poly_planner"]
assert isinstance(planner, DpPolyPlanner)
assert planner.behavior.traj_dp is not None
assert planner.dp_env.grid.dir_dist_map.shape == (4, 41, 21, 21)
assert dp_environment.dir_dist_launches == 0
assert poly_planner_kernel.eval_launches == 0
assert poly_planner_kernel.propagate_launches == 0
assert not leaked(), ("graph DP planner", leaked())

import sympy as sp
from tpl_tpu_torch.optim import genopt, optimizers, symext
from tpl_tpu_torch import parallel
from tpl_tpu_torch.examples import (crane_2d, scale_out, simple_vehicle,
                                    solver_crosscheck)
from tpl_tpu_torch.planning.dyn_prog import lat_lon_kernel as llk
from tpl_tpu_torch.scenes import dp_batch_scenes
xs, us = sp.symbols("x u")
gprob, _ = genopt.make_problem(genopt.Config(
    states=[xs], actions=[us], params=[], dynamics=[sp.Max(us, 1)],
    costs=[xs * symext.fixed(xs), sp.Integer(3)]))
gx = torch.ones(3, 1, dtype=torch.float64)
assert gprob.cost(gx, gx, torch.arange(3), 0.1, {}).shape == (3,)
assert optimizers.lateral_profile(device="cpu").dtype == torch.float32
spec = dict(t_steps=4, s_steps=41, ds_steps=5, l_steps=7)
dist, rl, pp, x0 = dp_batch_scenes(2, 4, 41, 7, nan=False)
nodes, trajs = parallel.sharded_latlon_batch(
    llk.make_latlon_solver(spec, "cpu")[0], parallel.scenario_mesh(2))(
    dist, rl, 0.5, pp, x0)
assert trajs.shape == (2, 4, 12) and bool(torch.isfinite(trajs).all())
assert not leaked(), ("sympy front end and scale-out", leaked())
print("clean")
"""


_BLOCKED_PROBE = r"""
import os, sys, uuid


class Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpl_tpu"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocked())
os.environ["TPL_TPU_SHM"] = "1"
from tpl_tpu_torch.application import mains
from tpl_tpu_torch.util import shm_store
from tpl_tpu_torch.simulation import SimAttach, tplsim
from tpl_tpu_torch.simulation import renderer
import tpl_tpu_torch.gui
from tpl_tpu_torch.gui import (GuiServer, birdseye, event_log, map_editor,
                               map_tiles, optim_view, renderers)
name = "/nojax_" + uuid.uuid4().hex[:8]
store = shm_store.ShmStore(name, reinit=True)
with store.lock():
    store.a = 1
other = shm_store.ShmStore(name)
other.revalidate()
assert other.a == 1
os.remove(shm_store.file_path(name))
print("clean")
"""


def test_multiprocess_modules_import_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TPL_TPU_SHM_ENGINE", None)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("clean")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("clean")


@pytest.mark.parametrize("path", [
    "tpl_tpu_torch", "chip_smoke.py", "tests/test_torch_kernel_cuda.py",
    "tpl_tpu_torch/planning/dyn_prog/dp_environment.py",
    "tpl_tpu_torch/planning/dyn_prog/poly_planner_kernel.py",
    "tpl_tpu_torch/planning/dyn_prog/dp_poly_planner.py",
    "tpl_tpu_torch/scenes.py", "tpl_tpu_torch/control",
    "tpl_tpu_torch/optim/ilqr_tracking_mpc_time.py",
    "tpl_tpu_torch/simulation", "tpl_tpu_torch/util/hotreload.py",
    "tpl_tpu_torch/optim/genopt.py", "tpl_tpu_torch/optim/symext.py",
    "tpl_tpu_torch/optim/optimizers.py", "tpl_tpu_torch/parallel",
    "tpl_tpu_torch/examples", "tests/torch_dist_worker.py",
    "tpl_tpu_torch/util/shm_store.py", "tpl_tpu_torch/native",
    "tpl_tpu_torch/application/mains.py", "tpl_tpu_torch/gui",
    "tpl_tpu_torch/simulation/renderer.py", "tests/torch_deploy.py"])
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
