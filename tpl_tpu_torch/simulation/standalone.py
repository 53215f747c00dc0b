"""
Single-process closed-loop harness: one object owns the sim core plus
the three applications and ticks them as a pipeline
(physics -> perception -> planning -> control -> actuation).

Behavioral parity target: library/tpl/simulation/standalone.py.
"""

from tpl_tpu_torch.application import EnvironmentApp, PlanningApp, ControlApp
from tpl_tpu_torch.simulation.core import SimCore
from tpl_tpu_torch.util import snapshot


def _pick(explicit, from_scenario):
    """Explicit param set wins; otherwise the scenario's, if any."""
    if explicit is not None:
        return explicit
    return from_scenario if from_scenario != "" else None


class SimStandalone:

    def __init__(self, app_id="", scenario_path=None, env_params=None,
                 planning_params=None, control_params=None):
        self.core = SimCore(app_id, scenario_path)

        with self.core.sh_state.lock():
            scenario = self.core.sh_state.sim
            planning_params = _pick(planning_params,
                                    scenario.init_planning_params)
            control_params = _pick(control_params,
                                   scenario.init_control_params)

        self.env_app = EnvironmentApp(app_id, env_params)
        self.planning_app = PlanningApp(app_id, planning_params,
                                        shared_env=self.env_app.env)
        self.control_app = ControlApp(app_id, control_params)

        self.core.reload_scenario(
            scenario_path, self.env_app.env,
            self.planning_app.sh_planners,
            self.control_app.sh_controllers)

    # ------------------------------------------------------------------

    def update(self, wall_time=None):
        sim = self._step_physics(wall_time)
        vehicle = self._step_perception(sim.t)
        trajectory = self._step_planning()
        self._step_control(sim.t, vehicle, trajectory)
        self._apply_controls()

    def _step_physics(self, wall_time):
        sim = self.core.get_next_sim_state(
            self.env_app.env, self.planning_app.sh_planners,
            self.control_app.sh_controllers, wall_time=wall_time)
        self.core.write_sim_state(sim)
        return sim

    def _step_perception(self, t):
        with self.env_app.env.lock():
            self.env_app.update(t)
            return snapshot(self.env_app.env.vehicle_state)

    def _step_planning(self):
        self.planning_app.update()
        with self.planning_app.sh_planners.lock():
            return snapshot(self.planning_app.sh_planners.trajectory)

    def _step_control(self, t, vehicle, trajectory):
        with self.control_app.sh_input.lock():
            ci = self.control_app.sh_input
            ci.t, ci.vehicle, ci.trajectory = t, vehicle, trajectory
        self.control_app.update()

    def _apply_controls(self):
        with self.control_app.sh_controllers.lock():
            acc, steer = snapshot(self.control_app.sh_controllers.controls)
        with self.core.sh_state.lock():
            ego = self.core.sh_state.sim.ego
            ego.control_acc = acc
            ego.control_steer = steer
