"""
Simulation recorder and replay: capture per-tick sim states and planner /
controller stats to disk and replay recordings into the sim store.
(reference: library/tpl/simulation/record.py, replay.py)

The port of tpl_tpu/simulation/record.py (numpy host code).  Not ported
yet: ``SimAttach`` (it drives apps in other processes over the shared-memory
stores of ``util/shm_store``, which the port lacks) and the scene renderer
``simulation/renderer`` (``render_video=True`` raises ImportError naming
it at the first frame).
"""

import os
import copy
import time
import pickle
import os.path as osp

import numpy as np

from tpl_tpu_torch.util import Bundle, StoreRegistry
from tpl_tpu_torch.simulation.state import SimState


class SimRecorder:
    """Capture sim states + runtimes each tick; save as a pickle bundle.
    (record.py:98-188, imdash video capture replaced by a headless
    renderer, tpl_tpu_torch.simulation.renderer, which is not ported yet)"""

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

        if app_id != "":
            app_id += "_"
        self.app_id = app_id

        self.sh_replay = StoreRegistry.get(f"/{app_id}tpl_sim_replay")
        with self.sh_replay.lock():
            self.sh_replay.state = SimReplayState()

        self.sh_state = sim_store if sim_store is not None else \
            StoreRegistry.get(f"/{app_id}tpl_sim")

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
