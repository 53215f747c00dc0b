"""The port's multi-process deployment on the CPU: the apps of
``tpl_tpu_torch.application.mains`` as separate processes over the
shared-memory stores, the sim attached to them (``SimAttach``, ``tplsim
attach``).

- ``mains planning --cpu --max-ticks 3`` in a subprocess, on an env taken
  from the port's ``SimStandalone`` on ``demo/country_follow`` and
  published to the env store.  Its first tick resets the env (a new active
  planner), which drops the local map; a thread of the test waits on the
  env store's lock and puts the map back each time it finds it dropped, as
  the env process would (a child whose three ticks all missed it, on a
  busy host, runs again, at most three times).  The trajectory the child
  publishes must equal, bit for bit, the same ``PlanningApp``'s in this
  process on that env after as many replans on the map (1 to 3, as the map
  came back before or after the child's first replan): the transport is
  lossless (in-process parity with JAX is held by
  tests/test_torch_rstp.py).
- Fresh apps under their own app id: ``tplsim attach``'s loop holds the
  scenario's clock until the apps track a plan (``SimAttach.wait_for_apps``):
  the first plan the sim sees is at t = 0 with the ego where it started.
  Without the hold the clock ran from the first tick and the ego drove
  without a plan until the apps' first replan: 0.85-0.96 s of sim time on
  an NVIDIA H100's host, seconds on a busy CPU, long enough to leave a
  curving road.
- Fresh apps, the planning process stopped (SIGSTOP) for LATE_PLAN_S s
  before its first plan: ``tplsim``'s loop over LATE_PLAN_TICKS headless
  ticks, each waiting for the control process's input to be at most
  LATE_PLAN_LAG s behind, keeps the road
  (without the hold the ego, planless, left it at t = 4.56 s).
- The three mains with ``--cpu`` and ``SimAttach`` in the test under a
  non-empty app id, LOOP_TICKS ticks of 0.01 s, each tick only after the
  control process has published a solve that took the tick's time (the
  pacing of the test, see ``tests/torch_deploy.py``), the cuts of
  tests/test_torch_closed_loop.py written into the apps' stores: 0 rule
  violations, finite controls, no emergency plan, and the ego's progress
  within PROGRESS_BAND of the port's ``SimStandalone`` over the same sim
  time.  The band: the apps run free, so the planner's plan reaches the
  controller several ticks late (a CPU replan at H=100 takes ~0.2 s
  against a ~0.03 s tick here, longer on a busy host), where
  ``SimStandalone`` plans and tracks in every tick; the ego trailed it by
  2.0-2.3 % over 0.99 s (100 ticks) in three runs on an idle host.
- A ``GuiServer(app_id=...)`` with no stores attaches over shared memory to
  the same running apps and a ``SimAttach``: it serves the loop's state and
  params, and its param edit reaches the planning process, which publishes
  its next plans at the new horizon.
- ``tplsim attach --max-ticks`` against the same running apps exits 0.
- Every child exits 0 on SIGTERM; the store files of the app ids are
  removed.
"""

import contextlib
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import torch_deploy as deploy

import tpl_tpu_torch
from tpl_tpu_torch.util import SharedObject, snapshot, store_paths

LOOP_TICKS = 60
PROGRESS_BAND = 0.10      # relative, on the distance the ego travelled
# the planning process stopped for LATE_PLAN_S s before its first plan,
# the attached loop run LATE_PLAN_TICKS ticks of 0.01 s: the ego
# without a plan leaves the road at t = 4.56 s (the sim's clock run from
# the first tick, as before SimAttach.wait_for_apps)
LATE_PLAN_S = 10.0
LATE_PLAN_TICKS = 500
LATE_PLAN_LAG = 0.1


@pytest.fixture(autouse=True)
def shared_stores(monkeypatch):
    monkeypatch.setenv("TPL_TPU_SHM", "1")
    monkeypatch.delenv("TPL_TPU_SHM_ENGINE", raising=False)
    tpl_tpu_torch.use_device("cpu")
    from tpl_tpu_torch.util import StoreRegistry
    StoreRegistry.clear()
    yield
    StoreRegistry.clear()


@contextlib.contextmanager
def _in_process():
    """In-process stores (``TPL_TPU_SHM`` unset) and one torch thread, as
    the children run; both put back as they were."""
    shm = os.environ.pop("TPL_TPU_SHM", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if shm is not None:
            os.environ["TPL_TPU_SHM"] = shm


def _standalone_env(ticks=3):
    """The env of the port's in-process loop on demo/country_follow after
    ``ticks`` ticks (its own planner and controller, the demo sets)."""
    from tpl_tpu_torch.simulation import SimStandalone
    with _in_process():
        np.random.seed(0)
        sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                            scenario_path="demo/country_follow")
        with sim.core.sh_state.lock():
            ss = sim.core.sh_state.sim
            ss.settings.running = True
            ss.settings.use_real_time = False
        for _ in range(ticks):
            sim.update()
        with sim.env_app.env.lock():
            return snapshot(vars(sim.env_app.env.unwrap()))


def _traj(traj):
    return {k: np.asarray(v) for k, v in vars(traj).items()
            if isinstance(v, (np.ndarray, list, float, int))}


def _same_bits(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def _planning_child(state):
    """``mains planning --cpu --max-ticks 3 --params demo`` in a subprocess
    on ``state`` published to a fresh app id's env store, with a thread of
    this process in the env process's part: it waits on the env store's
    lock and puts the local map back whenever it finds it dropped.  Returns
    the trajectory the child published."""
    from tpl_tpu_torch.environment import EnvironmentState
    from tpl_tpu_torch.util.shm_store import (
        ShmObject, ShmStore, remove_app_stores)

    app_id = "mp" + uuid.uuid4().hex[:6]
    env = ShmObject(EnvironmentState(), store_paths(app_id).env, reinit=True)
    with env.lock():
        vars(env.unwrap()).update(snapshot(state))
    stop = threading.Event()

    def restore_map():
        while not stop.is_set():
            with env.lock():
                if env.local_map is None:
                    env.local_map = snapshot(state["local_map"])
            time.sleep(0.001)

    keeper = threading.Thread(target=restore_map, daemon=True)
    keeper.start()
    try:
        res = subprocess.run(
            [sys.executable, "-m", "tpl_tpu_torch.application.mains",
             "planning", "--cpu", "--max-ticks", "3", "--app-id", app_id,
             "--params", "demo"], cwd=deploy.REPO, env=deploy.child_env(),
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout + res.stderr
        planning = ShmStore(store_paths(app_id).planning)
        planning.revalidate()
        assert planning.active_planner == deploy.RSTP
        return _traj(planning.trajectory)
    finally:
        stop.set()
        keeper.join()
        remove_app_stores(app_id)


def test_planning_main_in_a_subprocess_matches_in_process():
    from tpl_tpu_torch.environment import EnvironmentState
    from tpl_tpu_torch.application.planning_app import PlanningApp

    state = _standalone_env()
    assert state["local_map"] is not None
    # the map comes back between the child's ticks only as fast as this
    # process's thread is scheduled: on a busy host all three ticks may
    # miss it, and the child publishes the planner's initial one-point
    # trajectory; then the child runs again (at most three times)
    for _ in range(3):
        got = _planning_child(state)
        if len(got["x"]) > 1:
            break
    assert len(got["x"]) == 250

    # the same app in this process on the same env, one torch thread
    with _in_process():
        shared = SharedObject(EnvironmentState())
        vars(shared.unwrap()).update(snapshot(state))
        app = PlanningApp(uuid.uuid4().hex[:8], "demo", shared_env=shared)
        app.update()                         # the reset: no map, no replan
        assert shared.local_map is None
        shared.local_map = snapshot(state["local_map"])
        want = []
        for _ in range(3):
            app.update()
            with app.sh_planners.lock():
                want.append(_traj(app.sh_planners.trajectory))
    assert any(_same_bits(got, w) for w in want), \
        [float(np.abs(got["x"] - w["x"]).max()) for w in want]


def test_attached_sim_holds_its_clock_until_the_apps_track_a_plan():
    import argparse
    from tpl_tpu_torch.simulation import SimAttach
    from tpl_tpu_torch.simulation import tplsim
    from tpl_tpu_torch.util.shm_store import remove_app_stores

    app_id = "hold" + uuid.uuid4().hex[:6]
    procs = deploy.start_mains(app_id)
    try:
        sim = SimAttach(app_id=app_id, scenario_path="demo/country_follow",
                        timeout=120)
        with sim.core.sh_state.lock():
            x0 = sim.core.sh_state.sim.ego.x
        seen = []
        update = sim.update

        def recorded(*args, **kwargs):
            update(*args, **kwargs)
            sim.sh_planning.revalidate()
            with sim.core.sh_state.lock():
                s = sim.core.sh_state.sim
                seen.append((s.t, s.ego.x, len(sim.sh_planning.trajectory.x)))
        sim.update = recorded
        args = argparse.Namespace(planner=None, headless=True, no_reload=True,
                                  max_t=None, max_ticks=10, verbose=False,
                                  scenario="demo/country_follow")
        tplsim._drive(sim, sim.core, sim.sh_planning, args)
        planned = [s for s in seen if s[2] >= 2]
        assert planned, f"no plan in {len(seen)} ticks"
        assert planned[0][:2] == (0.0, x0), planned[0]
        assert seen[-1][0] > 0.0
    finally:
        out = deploy.stop_mains(procs)
        remove_app_stores(app_id)
    for name, (code, text) in out.items():
        assert code == 0, f"{name} exited {code}:\n{text[-3000:]}"


def test_attached_sim_keeps_the_road_when_the_first_plan_is_late():
    import argparse
    import signal
    from tpl_tpu_torch.simulation import SimAttach
    from tpl_tpu_torch.simulation import tplsim
    from tpl_tpu_torch.util import StoreRegistry
    from tpl_tpu_torch.util.shm_store import remove_app_stores

    app_id = "late" + uuid.uuid4().hex[:6]
    procs = deploy.start_mains(app_id)
    planner = procs["planning"].pid
    resumed = threading.Event()

    def resume():
        if not resumed.is_set():
            resumed.set()
            os.kill(planner, signal.SIGCONT)
    timer = threading.Timer(LATE_PLAN_S, resume)
    try:
        sim = SimAttach(app_id=app_id, scenario_path="demo/country_follow",
                        timeout=120)
        deploy.cut_and_start(sim)
        # each tick waits until the control process's input is at most
        # LATE_PLAN_LAG s of sim time behind (test_attached_loop_closes_
        # across_processes waits for a solve at each tick's time): the ego
        # takes controls that are a few ticks old at most, however busy
        # the host
        control_input = StoreRegistry.get(store_paths(app_id).control_input)
        update = sim.update

        def paced():
            update()
            with sim.core.sh_state.lock():
                t = sim.core.sh_state.sim.t
            start = time.time()
            while True:
                control_input.revalidate()
                if control_input.t >= t - LATE_PLAN_LAG:
                    return
                deploy._check(procs, start, 60.0, f"control input at t={t}")
        sim.update = paced
        # the planning process stopped before its first plan
        os.kill(planner, signal.SIGSTOP)
        timer.start()
        sim.sh_planning.revalidate()
        plan = getattr(sim.sh_planning, "trajectory", None)
        assert plan is None or len(plan.x) < 2, "planned before the stop"
        args = argparse.Namespace(planner=None, headless=True, no_reload=True,
                                  max_t=None, max_ticks=LATE_PLAN_TICKS,
                                  verbose=False,
                                  scenario="demo/country_follow")
        code = tplsim._drive(sim, sim.core, sim.sh_planning, args)
        with sim.core.sh_state.lock():
            s = snapshot(sim.core.sh_state.sim)
        assert code == 0 and s.rule_checker.violations == [], \
            s.rule_checker.violations[:3]
        # the held clock's paused ticks take the first tick's zero step
        assert s.t == pytest.approx(LATE_PLAN_TICKS * 0.01)
    finally:
        timer.cancel()
        resume()
        out = deploy.stop_mains(procs)
        remove_app_stores(app_id)
    for name, (code, text) in out.items():
        assert code == 0, f"{name} exited {code}:\n{text[-3000:]}"


@pytest.fixture(scope="module")
def reference():
    """The port's SimStandalone over the attached loop's sim time, run
    before the apps start (their loops keep two cores busy)."""
    return _standalone_progress((LOOP_TICKS - 1) * 0.01)


@pytest.fixture(scope="module")
def deployment(reference):
    """The three mains with --cpu under one app id, for this module (after
    the reference)."""
    app_id = "mp" + uuid.uuid4().hex[:6]
    procs = deploy.start_mains(app_id)
    try:
        yield app_id, procs
    finally:
        out = deploy.stop_mains(procs)
        from tpl_tpu_torch.util.shm_store import remove_app_stores
        remove_app_stores(app_id)
        for name, (code, text) in out.items():
            assert code == 0, f"{name} exited {code}:\n{text[-3000:]}"


def _standalone_progress(sim_t):
    """The ego's start and end x of the port's SimStandalone with the cuts
    of tests/torch_deploy.py, run to ``sim_t``."""
    from tpl_tpu_torch.simulation import SimStandalone
    with _in_process():
        np.random.seed(0)
        sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                            scenario_path="demo/country_follow")
        with sim.core.sh_state.lock():
            x0 = sim.core.sh_state.sim.ego.x
        with sim.planning_app.sh_planners.lock():
            p = sim.planning_app.sh_planners.path_vel_decomp_planner.params
            p.horizon = deploy.RSTP_HORIZON
            p.collision_screen = False
        with sim.control_app.sh_controllers.lock():
            sim.control_app.sh_controllers.model_predictive_controller \
                .params.horizon = deploy.MPC_HORIZON
        with sim.core.sh_state.lock():
            ss = sim.core.sh_state.sim
            ss.settings.running = True
            ss.settings.use_real_time = False
            ss.rule_checker.enable = True
        while True:
            sim.update()
            with sim.core.sh_state.lock():
                s = sim.core.sh_state.sim
                if s.t >= sim_t - 1e-9:
                    assert not s.rule_checker.violations
                    return x0, s.ego.x


def test_attached_loop_closes_across_processes(deployment, reference):
    from tpl_tpu_torch.simulation import SimAttach
    from tpl_tpu_torch.util import StoreRegistry

    app_id, procs = deployment
    assert app_id
    np.random.seed(0)
    sim = SimAttach(app_id=app_id, scenario_path="demo/country_follow",
                    timeout=120)
    with sim.core.sh_state.lock():
        x0 = sim.core.sh_state.sim.ego.x
    deploy.cut_and_start(sim)
    # SimStandalone plans in its first tick: so does this loop
    deploy.wait_for_plan(sim, procs, deploy.RSTP_HORIZON)
    control_input = StoreRegistry.get(store_paths(app_id).control_input)
    emergencies = 0
    for _ in range(LOOP_TICKS):
        t = deploy.paced_tick(sim, control_input, procs)
        sim.sh_control.revalidate()
        assert np.all(np.isfinite(sim.sh_control.controls))
        sim.sh_planning.revalidate()
        emergencies += bool(sim.sh_planning.trajectory.emergency)
    with sim.core.sh_state.lock():
        s = snapshot(sim.core.sh_state.sim)
    assert s.t == pytest.approx((LOOP_TICKS - 1) * 0.01)   # tick 1: dt 0
    assert s.rule_checker.violations == []
    assert emergencies == 0
    # the cuts reached the apps' held bundles: the plan has 100 steps
    assert len(sim.sh_planning.trajectory.x) == deploy.RSTP_HORIZON
    assert sim.sh_control.model_predictive_controller.params.horizon == \
        deploy.MPC_HORIZON
    ref_x0, ref_x = reference
    assert t == pytest.approx((LOOP_TICKS - 1) * 0.01)
    assert x0 == ref_x0
    travelled, ref = s.ego.x - x0, ref_x - ref_x0
    assert ref > 3.0
    assert abs(travelled - ref) <= PROGRESS_BAND * ref, (travelled, ref)


def test_tplsim_attach_exits_zero(deployment):
    app_id, _ = deployment
    res = subprocess.run(
        [sys.executable, "-m", "tpl_tpu_torch.simulation.tplsim", "attach",
         "--scenario", "demo/country_follow", "--app-id", app_id,
         "--no-reload", "--headless", "--max-ticks", "20"],
        cwd=deploy.REPO, env=deploy.child_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    # the clock held until the apps track a plan (SimAttach.wait_for_apps):
    # its paused ticks take the first tick's zero step, so 20 run 0.2 s
    assert "scenario demo/country_follow: t=0.20s ticks=20" in res.stdout
    assert "rule violations: 0" in res.stdout


def _get(gui, path):
    import json
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{gui.port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _post(gui, path, payload):
    import json
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{gui.port}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def test_gui_attached_by_app_id_sees_a_running_loop(deployment):
    from tpl_tpu_torch.gui import GuiServer
    from tpl_tpu_torch.simulation import SimAttach
    from tpl_tpu_torch.util import StoreRegistry

    app_id, procs = deployment
    sim = SimAttach(app_id=app_id, scenario_path="demo/country_follow",
                    timeout=120)
    deploy.cut_and_start(sim)
    deploy.wait_for_plan(sim, procs, deploy.RSTP_HORIZON)
    gui = GuiServer(app_id=app_id, port=0).start()
    try:
        control_input = StoreRegistry.get(
            store_paths(app_id).control_input)
        for _ in range(10):
            deploy.paced_tick(sim, control_input, procs)
        state = _get(gui, "/state.json")
        assert state["t"] == pytest.approx(0.09)
        assert state["running"] is True and state["violations"] == []
        assert state["planning"]["active"] == deploy.RSTP
        assert state["control"]["active"] == "model_predictive_controller"
        assert state["ego"]["v"] > 0.0
        assert all(np.isfinite(state["control"]["controls"]))
        params = _get(gui, "/params.json")
        assert params["planning"][deploy.RSTP]["horizon"] == \
            deploy.RSTP_HORIZON

        # an edit through the GUI reaches the planning process's bundle:
        # its next plans have the new horizon
        assert _post(gui, "/param", {"target": "planning",
                                     "name": deploy.RSTP,
                                     "param": "horizon", "value": 80}) == 200
        deploy.wait_for_plan(sim, procs, 80)
        for _ in range(3):
            deploy.paced_tick(sim, control_input, procs)
        state = _get(gui, "/state.json")
        assert state["t"] == pytest.approx(0.12)
        assert state["violations"] == []
    finally:
        gui.stop()
