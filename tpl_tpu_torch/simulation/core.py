"""
Simulation core: owns the /tpl_sim store, scenario lifecycle, and the
fixed-step integration schedule. The actual models (bicycle ego, IDM
traffic, noise, rule checks) live in `tpl_tpu_torch.simulation.physics` as
array-first building blocks.

Behavioral parity target: reference library/tpl/simulation/core.py
(scenario reload :52-89, stepping :388-458, measurement fan-out
:225-323).
"""

import copy
import time

import numpy as np

from tpl_tpu_torch import util
from tpl_tpu_torch.util import snapshot
from tpl_tpu_torch.environment import DynamicObject, TrafficLightDetection
from tpl_tpu_torch.environment.map_module import load_map_store
from tpl_tpu_torch.simulation import physics
from tpl_tpu_torch.simulation.state import (
    SimState, SimCar, SimEgo, load_sim_state,
)
from tpl_tpu_torch.application.environment_app import load_env_params
from tpl_tpu_torch.application.planning_app import load_planning_params
from tpl_tpu_torch.application.control_app import load_control_params

# hard bound on catch-up substeps after a long stall, in units of int_step
MAX_CATCHUP_STEPS = 100


class ScenarioLoadError(RuntimeError):
    """A scenario path could not be loaded.

    Raised instead of silently continuing with whatever state is in the
    store (the reference prints and carries on, core.py:52-58 — which
    lets a misnamed scenario record garbage rule violations against the
    default scene in sweeps/CI)."""


class SimCore:

    def __init__(self, app_id="", scenario_path=None):
        self.clock = _StepClock()
        self.acc_delay = physics.DelayLine()
        self.steer_delay = physics.DelayLine()
        self.last_obj_measure_t = 0.0
        self.manager = None

        self.app_id = f"{app_id}_" if app_id else ""
        self.sh_state = util.StoreRegistry.get(util.store_paths(app_id).sim)
        with self.sh_state.lock():
            self.sh_state.storage = scenario_path or "default"
            self.sh_state.sim = SimState()

    # ------------------------------------------------------------------
    # scenario lifecycle

    def reload_scenario(self, scenario_path, env, planning, control):
        if scenario_path is None:
            return
        sim = load_sim_state(scenario_path)
        if sim is None:
            raise ScenarioLoadError(
                f"loading scenario {scenario_path!r} failed "
                "(not found in any data root)")

        self.clock.reset()
        self.acc_delay.clear()
        self.steer_delay.clear()
        self.last_obj_measure_t = 0.0

        sim.t = 0.0
        # scenarios saved mid-run may carry finished=1 (e.g.
        # acc_2024/rb_3o); clearing it restarts them, unlike the
        # reference which terminates such scenarios after one tick
        sim.finished = False
        sim.rule_checker.violations = []
        sim.settings.reload_requested = False
        # the manager module is live code: keep it on the core, never in shm
        self.manager = sim.manager
        sim.manager = None

        self._push_scenario_params(sim, env, planning, control)
        self.sh_state.sim = sim
        self.sh_state.storage = scenario_path

    def _push_scenario_params(self, sim, env, planning, control):
        with env.lock():
            env.full_reset()
            load_env_params(env, sim.init_env_params)
            env.selected_map = sim.selected_map
            env.map_store_path = sim.map_store_path
            env.maps = load_map_store(sim.map_store_path)
            env.reset_counter = 1
            sim.available_maps = [
                (k, v.name) for k, v in util.get_obj_dict(env.maps).items()]
        with planning.lock():
            load_planning_params(planning, sim.init_planning_params)
        with control.lock():
            load_control_params(control, sim.init_control_params)

    # ------------------------------------------------------------------
    # one scheduler tick

    def get_next_sim_state(self, env, planning, control, wall_time=None):
        now = time.time() if wall_time is None else wall_time

        with self.sh_state.lock():
            sh_sim = self.sh_state.sim
            if sh_sim.finished and sh_sim.settings.reload_if_finished:
                sh_sim.settings.reload_requested = True
            if sh_sim.settings.reload_requested:
                try:
                    self.reload_scenario(
                        self.sh_state.storage, env, planning, control)
                except ScenarioLoadError as e:
                    # a live reload request (GUI/store edit) must not
                    # kill the running sim; drop the request, and stop
                    # reload_if_finished from re-requesting the broken
                    # path every tick (re-enable it after fixing it)
                    print(f"reload ignored: {e}")
                    sh_sim.settings.reload_requested = False
                    sh_sim.settings.reload_if_finished = False
            sim = snapshot(self.sh_state.sim)
            sim.manager = self.manager
            sh_sim.settings.single_step_requested = False

        if self.manager is not None:
            self.manager.update(sim)

        dt, n_steps = self.clock.advance(sim.settings, now)

        with env.lock():
            cmap = env.get_current_map()
            for _ in range(n_steps):
                self._substep(sim, env, dt)
            physics.check_rules(sim, cmap)
            self._sense(env, sim)

        return sim

    def _substep(self, sim, env, dt):
        """One physics integration step of ``dt`` sim seconds."""
        s = sim.settings
        if s.update_vehicle_state:
            ego = sim.ego
            if dt > 0.0:
                self.acc_delay.push(sim.t, ego.control_acc,
                                    ego.acc_dead_time, dt)
                self.steer_delay.push(sim.t, ego.control_steer,
                                      ego.steer_dead_time, dt)
            ego.a = self.acc_delay.sample(sim.t, ego.acc_dead_time, ego.a)
            ego.steer_angle = self.steer_delay.sample(
                sim.t, ego.steer_dead_time, ego.steer_angle)
            physics.step_bicycle(ego, dt)
        if s.update_dynamic_objects:
            physics.step_traffic(sim.t, sim.ego, sim.cars, env.maps, dt)
        sim.t = round(sim.t + dt, 5)

    # ------------------------------------------------------------------
    # measurement fan-out into the environment store

    def _sense(self, env, sim):
        s = sim.settings
        if s.set_env_time:
            env.t = sim.t
        if s.set_env_vehicle_state:
            _observe_ego(env.vehicle_state, env.t, sim.ego)
        if s.set_env_dynamic_objects:
            if sim.t - self.last_obj_measure_t > s.set_env_dynamic_objects_dt:
                self._observe_cars(env, sim.cars)
                self.last_obj_measure_t = sim.t
        if s.set_env_traffic_lights:
            self._observe_traffic_lights(env, sim.traffic_lights)
        if s.set_env_time_constraints:
            env.man_time_cons = [
                (np.array([tc.x, tc.y]), tc.t_min, tc.t_max)
                for tc in sim.time_constraints]

    def _observe_cars(self, env, cars):
        env.tracks.simulation = []
        env.ir_pc_dets = []
        for meas in physics.noisy_car_measurements(env.t, cars):
            det = DynamicObject()
            det.id = meas.uuid
            det.t = env.t
            det.pos = np.array([meas.x, meas.y])
            det.v = meas.v
            det.yaw = meas.yaw
            det.evade = meas.evade
            det.hull = SimCar.get_convex_hull(meas)
            if meas.noise_hull:
                det.hull = det.hull + np.random.normal(
                    0.0, meas.noise_hull, det.hull.shape)
            det.hull_radius = np.max(np.linalg.norm(
                det.hull - det.pos[None, :], axis=1))
            det = snapshot(det)
            # raw point-cloud detections carry no motion estimate
            det.yaw = None
            det.v = None
            env.ir_pc_dets.append(det)

    def _observe_traffic_lights(self, env, traffic_lights):
        env.tl_dets.simulation = []
        ego_pos = np.array([env.vehicle_state.x, env.vehicle_state.y])
        for tl in traffic_lights:
            det = TrafficLightDetection()
            det.t = env.t
            det.near_point = ego_pos
            det.far_point = np.array([tl.x, tl.y])
            det.state = tl.state
            det.confidence = 1.0
            env.tl_dets.simulation.append(det)

    # ------------------------------------------------------------------

    def write_sim_state(self, sim):
        with self.sh_state.lock():
            live_settings = snapshot(self.sh_state.sim.settings)
            if sim.settings.running or sim.settings.single_step_requested:
                published = copy.copy(sim)
                published.manager = None
                self.sh_state.sim = published
            self.sh_state.sim.available_maps = sim.available_maps
            self.sh_state.sim.settings = live_settings


def _observe_ego(veh, t, ego):
    """Project the sim ego onto the measured vehicle-state schema."""
    veh.t = t
    veh.x, veh.y = ego.x, ego.y
    veh.phi = ego.yaw
    veh.v = ego.v
    veh.a = ego.a
    veh.delta = ego.steer_angle
    veh.lat_acc = ego.v ** 2 * np.tan(ego.steer_angle) / ego.wheel_base

    veh.wheel_base = ego.wheel_base
    veh.track_width = ego.track_width
    veh.rear_axis_to_rear = ego.rear_to_rear_axis
    veh.rear_axis_to_front = ego.wheel_base + ego.front_to_front_axis
    veh.cog_axes_ratio = ego.cog_axes_ratio

    veh.dead_time_steer = ego.steer_dead_time
    veh.dead_time_acc = ego.acc_dead_time

    veh.steering_wheel_button = False
    veh.imu_state = 3


class _StepClock:
    """Fixed-step accumulator: converts wall/virtual time progress into a
    (dt, n_substeps) schedule per tick."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.backlog = 0.0
        self.prev_wall = -1.0

    def advance(self, settings, now):
        """Returns (dt, n_steps): integrate n_steps substeps of dt."""
        if not settings.update_logic:
            self.backlog = 0.0
            self.prev_wall = now
            return 0.0, 0

        if not settings.running:
            self.prev_wall = now
            self.backlog = 0.0
            if settings.single_step_requested:
                return settings.fixed_time_step, 1
            # parity: a paused sim still runs one zero-dt substep per tick
            # (delay lines resample, poses re-anchor; reference
            # core.py:440-448 enters its while loop once with dt=0)
            return 0.0, 1

        if self.prev_wall > 0:
            grew = (now - self.prev_wall if settings.use_real_time
                    else settings.fixed_time_step)
            self.backlog += grew
        self.prev_wall = now

        dt = settings.int_step
        self.backlog = min(dt * MAX_CATCHUP_STEPS, self.backlog)
        n = int(np.floor(round(self.backlog / dt, 5)))
        self.backlog = round(self.backlog - n * dt, 5)
        return dt, n
