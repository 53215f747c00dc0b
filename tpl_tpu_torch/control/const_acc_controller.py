"""Constant-deceleration fallback controller used on emergency
trajectories. (reference: library/tpl/control/const_acc_controller.py)"""

import numpy as np

from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.planning.trajectory import Trajectory


class ConstAccController(BaseController):

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared

        self.steering_angle = 0.0
        self.acceleration = -6.0
        self.con_traj = Trajectory()
        self.last_update_time = -1.0

    def update(self, con_input):
        t = con_input.t
        veh = con_input.vehicle

        if t - self.last_update_time >= 1.0:
            # prevents steering creep under biased measurement noise
            self.steering_angle = 0.0
        self.last_update_time = t

        dt = 0.1
        ts = np.arange(0.0, 2.0, dt)
        n = len(ts)
        xs = np.zeros(n + 1)
        ys = np.zeros(n + 1)
        ss = np.zeros(n + 1)
        phis = np.zeros(n + 1)
        vs = np.zeros(n + 1)
        xs[0], ys[0], phis[0], vs[0] = veh.x, veh.y, veh.phi, veh.v

        for i in range(n):
            dx = vs[i] * np.cos(phis[i])
            dy = vs[i] * np.sin(phis[i])
            xs[i + 1] = xs[i] + dt * dx
            ys[i + 1] = ys[i] + dt * dy
            ss[i + 1] = ss[i] + dt * np.hypot(dx, dy)
            phis[i + 1] = phis[i] + dt * vs[i] * np.tan(
                self.steering_angle) / veh.wheel_base
            vs[i + 1] = max(0.0, vs[i] + dt * self.acceleration)

        self.con_traj = Trajectory()
        self.con_traj.time = ts
        self.con_traj.x = xs
        self.con_traj.y = ys
        self.con_traj.orientation = phis
        self.con_traj.velocity = vs
        self.con_traj.s = ss

        return (self.acceleration, self.steering_angle), self.con_traj
