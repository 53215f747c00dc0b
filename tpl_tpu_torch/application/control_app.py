"""
Control application: hosts the controller family, routes emergency
trajectories to the constant-deceleration fallback, and publishes
controls plus tracking-error statistics each tick.

Behavioral parity target: library/tpl/application/control_app.py.
"""

import time

import numpy as np

from tpl_tpu_torch.application.registry import (
    ComponentRegistry, merge_param_set, save_param_set)
from tpl_tpu_torch.control import BaseController
from tpl_tpu_torch.environment import VehicleState
from tpl_tpu_torch.planning import Trajectory
from tpl_tpu_torch.util import (
    Bundle, StoreRegistry, project, short_angle_dist, snapshot)


class ControlInput:
    """What a controller consumes: wall time, ego state, and the plan."""

    def __init__(self):
        self.t = 0.0
        self.vehicle = VehicleState()
        self.trajectory = Trajectory()


class ControlStats:
    """Per-tick tracking quality, published for the GUI/recorder."""

    def __init__(self, runtime=0.0, err_d_lat=0.0, err_vel=0.0,
                 err_heading=0.0):
        self.runtime = runtime
        self.err_d_lat = err_d_lat
        self.err_vel = err_vel
        self.err_heading = err_heading


def tracking_errors(vehicle, trajectory):
    """Project the ego pose onto the planned path and measure lateral,
    heading, and velocity deviation (reference control_app.py:92-110)."""

    path = np.column_stack((trajectory.x, trajectory.y))
    proj = project(path, np.array([vehicle.x, vehicle.y]))
    v_ref = np.interp(proj.arc_len, trajectory.s, trajectory.velocity)
    return (proj.distance,
            float(v_ref) - vehicle.v,
            short_angle_dist(proj.angle, vehicle.phi))


class ControlApp:

    FALLBACK = "const_acc_controller"

    def __init__(self, app_id="", control_params_path=None):
        self.app_id = app_id

        self.sh_input = StoreRegistry.get(f"/{app_id}tpl_control_input")
        with self.sh_input.lock():
            defaults = ControlInput()
            for field in ("t", "vehicle", "trajectory"):
                setattr(self.sh_input, field, getattr(defaults, field))

        self.sh_controllers = StoreRegistry.get(f"/{app_id}tpl_control")
        with self.sh_controllers.lock():
            self.registry = ComponentRegistry(
                self.sh_controllers, BaseController, kind="control",
                active_key="active_controller",
                names_key="controller_names")
            self.sh_controllers.runtime = 0.0
            self.sh_controllers.stats = ControlStats()
            self.sh_controllers.controls = (0.0, 0.0)
            self.sh_controllers.active_controller_state = Bundle()
            self.registry.load_params(control_params_path)

        self.controllers = self.registry.by_name

    def _select(self, con_input):
        """Emergency plans bypass the active controller entirely and
        brake via the constant-deceleration fallback."""
        if con_input.trajectory.emergency:
            return self.controllers[self.FALLBACK]
        return self.registry.get(
            self.registry.active_name(), default_name="base_controller")

    def update(self):
        tick_start = time.perf_counter()

        with self.sh_input.lock():
            con_input = ControlInput()
            con_input.t = self.sh_input.t
            con_input.vehicle = snapshot(self.sh_input.vehicle)
            con_input.trajectory = snapshot(self.sh_input.trajectory)

        controls, control_traj = self._select(con_input).update(con_input)

        runtime = time.perf_counter() - tick_start
        stats = ControlStats(runtime=runtime)
        if len(con_input.trajectory.time) >= 2:
            (stats.err_d_lat, stats.err_vel,
             stats.err_heading) = tracking_errors(
                con_input.vehicle, con_input.trajectory)

        with self.sh_controllers.lock():
            self.sh_controllers.runtime = runtime
            self.sh_controllers.stats = stats
            self.sh_controllers.controls = controls
            self.sh_controllers.control_trajectory = control_traj


def load_control_params(sh_controllers, path=None):
    if path is None:
        path = getattr(sh_controllers, "storage", "default")
    merge_param_set(sh_controllers, "control", "active_controller", path)


def save_control_params(sh_controllers):
    save_param_set(sh_controllers, "control", "active_controller",
                   sh_controllers.controller_names)
