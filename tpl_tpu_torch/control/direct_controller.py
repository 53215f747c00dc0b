"""Trajectory passthrough controller: reads acceleration and
curvature-derived steering straight off the planned trajectory at the
dead-time-shifted lookup time. No feedback, no solve — the cheapest
possible baseline controller.

Behavioral parity target: library/tpl/control/direct_controller.py; the
port of tpl_tpu/control/direct_controller.py (numpy host code).
"""

import numpy as np

from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.util import snapshot


class Params:

    def __init__(self):
        self.a_max = 3.0
        self.a_min = -3.0
        self.steer_rate_max_abs = 1.0


def _stationary_trajectory(veh):
    out = Trajectory()
    out.x = np.array([veh.x])
    out.y = np.array([veh.y])
    return out


class DirectController(BaseController):

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared
        with self.lock_shared():
            self.shared.params = Params()

        self.command = (0.0, 0.0)
        self.prev_t = 0.0

    def load_state(self, other):
        """Copy the carried state (last command, last tick time) from
        another instance, e.g. the JAX package's."""
        self.command = tuple(other.command)
        self.prev_t = other.prev_t

    def update(self, con_input):
        veh = con_input.vehicle
        traj = con_input.trajectory
        placeholder = _stationary_trajectory(veh)

        dt = con_input.t - self.prev_t
        self.prev_t = con_input.t
        if dt == 0 or len(traj.time) < 2:
            return self.command, placeholder

        with self.lock_shared():
            params = snapshot(self.shared.params)

        # sample the plan where the actuators will actually act
        t_q = np.clip(con_input.t + veh.dead_time_steer,
                      traj.time[0], traj.time[-1])
        acc = np.interp(t_q, traj.time, traj.acceleration)
        curv = np.interp(t_q, traj.time, traj.curvature)
        steer = np.arctan(curv * veh.wheel_base)

        self.command = (
            float(np.clip(acc, params.a_min, params.a_max)),
            float(np.clip(steer, -veh.delta_max, veh.delta_max)))
        return self.command, placeholder
