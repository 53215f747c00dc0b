"""
Feedforward controller: curvature feedforward steering plus PI
longitudinal control on (arc-length, velocity) errors, with open-loop
dead-time compensation through the shared command log.

Behavioral parity target: library/tpl/control/feedforward_controller.py;
the port of tpl_tpu/control/feedforward_controller.py (numpy host code;
``util.project`` takes the port's C route).
"""

import numpy as np

from tpl_tpu_torch import util
from tpl_tpu_torch.ops.interp import short_angle_dist, lerp_xs
from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.control.openloop import (
    StampedLog, compensate_dead_time, lerp_extrap)
from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.util import snapshot


class Params:

    def __init__(self):
        self.k_p_s_lon = 1.0
        self.k_i_s_lon = 0.01
        self.k_p_v_lon = 1.0
        self.k_i_v_lon = 0.02

        self.k_p_lat = 2.0
        self.k_p_heading = 10.0
        self.k_stan_lat = 2.0
        self.use_stanley_law = False

        self.a_max = 3.0
        self.a_min = -3.0
        self.steer_rate_max = 1.0

        self.err_lat_max = 0.2
        self.err_int_lon_max_s = 2.0
        self.err_int_lon_max_v = 2.0

        self.v_ch = 32.0
        self.step_comp_dead_time = 0.005


class FeedforwardController(BaseController):

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared
        with self.lock_shared():
            self.shared.params = Params()

        self.log = StampedLog()
        self.int_s = 0.0          # arc-length error integrator
        self.int_v = 0.0          # velocity error integrator
        self.acc = 0.0
        self.steering_angle = 0.0
        self.prev_t = 0.0

    def load_state(self, other):
        """Copy the carried state (command log, integrators, last command,
        last tick time) from another instance, e.g. the JAX package's."""
        self.log.rows = list(other.log.rows)
        self.int_s, self.int_v = other.int_s, other.int_v
        self.acc, self.steering_angle = other.acc, other.steering_angle
        self.prev_t = other.prev_t

    def update(self, con_input):
        t = con_input.t
        veh = con_input.vehicle
        traj = con_input.trajectory

        placeholder = Trajectory()
        placeholder.x = np.array([veh.x])
        placeholder.y = np.array([veh.y])

        dt = t - self.prev_t
        if dt < 0.0 or dt >= 0.1:
            # time jump: integrators and in-flight commands are stale
            dt = float(np.clip(dt, 0.0, 0.1))
            self.int_s = self.int_v = 0.0
            self.log.clear()
        self.prev_t = t
        if dt == 0 or len(traj.time) < 2:
            return (self.acc, self.steering_angle), placeholder

        with self.lock_shared():
            params = snapshot(self.shared.params)
            self.shared.err_int_lon_s = self.int_s
            self.shared.err_int_lon_v = self.int_v

        state = compensate_dead_time(
            self.log, [veh.x, veh.y, veh.phi, veh.delta, veh.v],
            t, veh.dead_time_steer, params.step_comp_dead_time,
            veh.wheel_base, v_ch=params.v_ch)

        # feedforward targets at the dead-time-shifted query time
        try:
            t_q = np.clip(t, traj.time[0], traj.time[-1]) \
                + veh.dead_time_steer
            x_trg = lerp_extrap(t_q, traj.time, traj.x)
            y_trg = lerp_extrap(t_q, traj.time, traj.y)
            phi_trg = float(lerp_xs(
                t_q, np.asarray(traj.time), np.asarray(traj.orientation),
                angle=True, clip_alpha=True))
            v_trg = lerp_extrap(t_q, traj.time, traj.velocity)
            a_trg = lerp_extrap(t_q, traj.time, traj.acceleration)
            k_trg = lerp_extrap(t_q, traj.time, traj.curvature)
        except Exception:
            return (self.acc, self.steering_angle), placeholder

        # --- longitudinal PI on (s, v) errors, measured at the CoG
        cog = state[:2] + 0.5 * veh.wheel_base * np.array(
            [np.cos(state[2]), np.sin(state[2])])
        path = np.vstack((traj.x, traj.y)).T
        err_s = (util.project(path, (x_trg, y_trg)).arc_len
                 - util.project(path, tuple(cog)).arc_len)
        err_v = v_trg - state[4]

        self.int_s = float(np.clip(self.int_s + err_s * dt,
                                   -params.err_int_lon_max_s,
                                   params.err_int_lon_max_s))
        self.int_v = float(np.clip(self.int_v + err_v * dt,
                                   -params.err_int_lon_max_v,
                                   params.err_int_lon_max_v))

        acc_ff = a_trg - 9.81 * np.sin(veh.pitch)
        self.acc = float(np.clip(
            acc_ff
            + params.k_p_s_lon * err_s + params.k_i_s_lon * self.int_s
            + params.k_p_v_lon * err_v + params.k_i_v_lon * self.int_v,
            params.a_min, params.a_max))

        # --- lateral: curvature feedforward + heading/offset feedback
        steer_ff = np.arctan(
            veh.wheel_base * (1 + (state[4] / params.v_ch) ** 2) * k_trg)
        offset = cog - (x_trg, y_trg)
        err_lat = np.array([-np.sin(phi_trg), np.cos(phi_trg)]) @ offset
        err_heading = short_angle_dist(state[2], phi_trg)

        if params.use_stanley_law:
            steer_cmd = steer_ff + err_heading + np.arctan(
                params.k_stan_lat * -err_lat / max(1.0, state[4]))
        else:
            steer_cmd = (steer_ff
                         + params.k_p_lat / max(1.0, veh.v) * err_lat
                         + params.k_p_heading * err_heading)

        rate = np.clip((steer_cmd - self.steering_angle) / dt,
                       -params.steer_rate_max, params.steer_rate_max)
        if veh.v > 0.5:
            self.steering_angle = float(np.clip(
                self.steering_angle + rate * dt,
                -veh.delta_max, veh.delta_max))

        if dt > 0.0:
            self.log.push(t, self.acc, self.steering_angle)
        return (self.acc, self.steering_angle), placeholder
