"""
Simulation recorder and replay: capture per-tick sim states and planner /
controller stats to disk, replay recordings into the sim store, export
headless scene renderings, and attach the sim to apps running as other
processes.
(reference: library/tpl/simulation/record.py, replay.py, attach.py)

The port of tpl_tpu/simulation/record.py (numpy host code).  ``SimAttach``
differs from the JAX package's where that one cannot meet the apps of
``application/mains``: it opens their stores by the names they use
(:func:`tpl_tpu_torch.util.store_paths`), the environment as the
``ShmObject`` the env process publishes, and it hands the control store's
controls to the ego, as ``SimStandalone`` does.
"""

import os
import copy
import time
import pickle
import os.path as osp

import numpy as np

from tpl_tpu_torch.util import Bundle, StoreRegistry, snapshot, store_paths
from tpl_tpu_torch.simulation.state import SimState

# the seconds between SimAttach.wait_for_apps's paused ticks
WAIT_POLL_S = 0.005


class SimRecorder:
    """Capture sim states + runtimes each tick; save as a pickle bundle.
    (record.py:98-188, imdash video capture replaced by the headless
    renderer in tpl_tpu_torch.simulation.renderer)"""

    def __init__(self, standalone, path, dt_state_log=0.05,
                 render_video=False):
        self.sta = standalone
        self.path = path
        self.dt_state_log = dt_state_log
        self.render_video = render_video

        os.makedirs(self.path, exist_ok=True)

        self.t_last_state_log = -1.0
        self.frames = []

        self.log = Bundle()
        self.log.sim_states = []
        self.log.runtime_planner = []
        self.log.active_planner = []
        self.log.runtime_controller = []
        self.log.active_controller = []

    def capture(self):
        with self.sta.core.sh_state.lock():
            sim = copy.deepcopy(self.sta.core.sh_state.sim)
            sim.manager = None

        if round(sim.t - self.t_last_state_log, 5) >= self.dt_state_log:
            self.log.sim_states.append(sim)

            with self.sta.planning_app.sh_planners.lock():
                self.log.runtime_planner.append(
                    self.sta.planning_app.sh_planners.runtime)
                self.log.active_planner.append(
                    self.sta.planning_app.sh_planners.active_planner)

            with self.sta.control_app.sh_controllers.lock():
                self.log.runtime_controller.append(
                    self.sta.control_app.sh_controllers.runtime)
                self.log.active_controller.append(
                    self.sta.control_app.sh_controllers.active_controller)

            self.t_last_state_log = sim.t

            if self.render_video:
                from tpl_tpu_torch.simulation.renderer import render_scene
                self.frames.append(render_scene(
                    self.sta.env_app.env, sim,
                    planners=self.sta.planning_app.sh_planners))

    def finish(self):
        with open(osp.join(self.path, "recording.pkl"), "wb") as f:
            pickle.dump(dict(self.log), f)

        # runtime statistics like the reference test harness
        rt = np.array(self.log.runtime_planner, dtype=float)
        if len(rt):
            stats = dict(
                mean_ms=float(rt.mean() * 1e3),
                std_ms=float(rt.std() * 1e3),
                max_ms=float(rt.max() * 1e3),
                p99_ms=float(np.percentile(rt, 99) * 1e3))
            with open(osp.join(self.path, "runtime_stats.txt"), "w") as f:
                for k, v in stats.items():
                    f.write(f"{k}: {v:.3f}\n")

        if self.render_video and self.frames:
            from tpl_tpu_torch.simulation.renderer import save_frames
            save_frames(self.frames, osp.join(self.path, "frames"))


def load_recording(path):
    with open(osp.join(path, "recording.pkl"), "rb") as f:
        return Bundle(**pickle.load(f))


class SimReplayState:

    def __init__(self):
        self.running = True
        self.sleep_time = 0.01
        self.step = 0


class SimReplay:
    """Step recorded sim states back into the sim store. (replay.py)"""

    def __init__(self, app_id="", recording_path=None, sim_store=None):
        self.recording = load_recording(recording_path)

        paths = store_paths(app_id)
        self.app_id = f"{app_id}_" if app_id else ""

        self.sh_replay = StoreRegistry.get(paths.sim_replay)
        with self.sh_replay.lock():
            self.sh_replay.state = SimReplayState()

        self.sh_state = sim_store if sim_store is not None else \
            StoreRegistry.get(paths.sim)

        with self.sh_state.lock():
            if not hasattr(self.sh_state, "sim"):
                self.sh_state.sim = SimState()
            self.sh_state.sim = self.recording.sim_states[0]
            self.sh_state.sim.settings.running = False

    def update(self):
        with self.sh_replay.lock():
            if self.sh_replay.state.running:
                self.sh_replay.state.step += 1
                self.sh_replay.state.step = max(0, min(
                    len(self.recording.sim_states) - 1,
                    self.sh_replay.state.step))
            state = copy.deepcopy(self.sh_replay.state)

        with self.sh_state.lock():
            self.sh_state.sim = self.recording.sim_states[state.step]
            self.sh_state.sim.settings.running = False

        time.sleep(max(0.0, state.sleep_time))
        return state.step


class SimAttach:
    """Attach the simulation core to environment / planning / control apps
    running as other processes (``tpl_tpu_torch.application.mains``) over
    shared-memory stores.  (reference: library/tpl/simulation/attach.py)

    ``__init__`` waits until each app has published its store (at most
    ``timeout`` s each, if given), then loads the scenario into them, as
    ``SimStandalone`` does.  :meth:`update` is ``SimStandalone.update``
    without the apps: it ticks the physics and senses into the env store,
    then hands the control store's latest controls to the ego.
    :meth:`wait_for_apps` holds the scenario's clock until the apps track a
    plan (``tplsim attach`` calls it before the clock runs)."""

    def __init__(self, app_id="", scenario_path=None, timeout=None):
        from tpl_tpu_torch.environment import EnvironmentState
        from tpl_tpu_torch.simulation.core import SimCore
        from tpl_tpu_torch.util.shm_store import ShmObject, ShmStore

        paths = store_paths(app_id)
        self.timeout = timeout
        self.core = SimCore(app_id=app_id, scenario_path=scenario_path)
        self.sh_env = ShmObject(EnvironmentState(), paths.env)
        self.sh_planning = ShmStore(paths.planning)
        self.sh_control = ShmStore(paths.control)

        for name, store, attr in (
                ("environment", self.sh_env, "t"),
                ("planning", self.sh_planning, "planner_names"),
                ("control", self.sh_control, "controller_names")):
            self._wait(name, store, attr, timeout)
        with self.core.sh_state.lock():
            self.core.reload_scenario(scenario_path, self.sh_env,
                                      self.sh_planning, self.sh_control)

    @staticmethod
    def _wait(name, store, attr, timeout=None):
        start = time.time()
        while not store.wait_for_attr(attr, timeout=1.0):
            if timeout is not None and time.time() - start > timeout:
                raise TimeoutError(f"no {name} app published its store in "
                                   f"{timeout} s")
            print(f"Waiting for valid {name} ...", flush=True)

    def validate_env(self):
        self._wait("environment", self.sh_env, "t")

    def wait_for_apps(self):
        """Ticks the sim with its clock held (the physics paused, the
        sensing into the env store going on) until the planning app has
        published a plan and the control app has published two solves
        since: the first tick the clock runs then tracks a plan, as
        ``SimStandalone``'s first tick does, however long a fresh app's
        first replan takes (its first-use imports and kernel loads, seconds
        on a busy host, while the ego would drive on without a plan).
        Raises ``TimeoutError`` after the ``timeout`` given to
        ``__init__``, if one was."""
        with self.core.sh_state.lock():
            self.core.sh_state.sim.settings.running = False
        start, seen = time.time(), None
        while True:
            self.sh_planning.revalidate()
            plan = getattr(self.sh_planning, "trajectory", None)
            if seen is None and plan is not None and len(plan.x) >= 2:
                seen = self.sh_control.shm_version()
            if (seen is not None
                    and self.sh_control.shm_version() >= seen + 2):
                return
            if (self.timeout is not None
                    and time.time() - start > self.timeout):
                raise TimeoutError(f"the apps tracked no plan in "
                                   f"{self.timeout} s")
            self.update()
            time.sleep(WAIT_POLL_S)

    def update(self, wall_time=None):
        self.validate_env()
        sim = self.core.get_next_sim_state(
            self.sh_env, self.sh_planning, self.sh_control,
            wall_time=wall_time)
        self.core.write_sim_state(sim)
        self._apply_controls()

    def _apply_controls(self):
        self.sh_control.revalidate()
        acc, steer = snapshot(self.sh_control.controls)
        with self.core.sh_state.lock():
            ego = self.core.sh_state.sim.ego
            ego.control_acc = acc
            ego.control_steer = steer
