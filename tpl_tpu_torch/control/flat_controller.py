"""
Differential-flatness tracking controller.

The flat output is the rear-axle midpoint; tracking runs as two
decoupled PI(+feedforward) loops on the flat coordinates, then the
commands map back through the flatness transform. Dead time is
compensated open-loop via the shared command log + closed-form rollout.

Behavioral parity target: library/tpl/control/flat_controller.py; the
port of tpl_tpu/control/flat_controller.py (numpy host code).
"""

import numpy as np

from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.control.openloop import (
    StampedLog, compensate_dead_time)
from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.util import snapshot


class Params:

    def __init__(self):
        self.k_pos = 10.0
        self.k_vel = 5.0
        self.ki_pos = 0.1
        self.a_max = 3.0
        self.a_min = -3.0
        self.steer_rate_max_abs = 1.0
        self.step_comp_dead_time = 0.005


# columns of the packed target sample
TRG_X, TRG_Y, TRG_V, TRG_A, TRG_PHI, TRG_K = range(6)


class FlatController(BaseController):

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared
        with self.lock_shared():
            self.shared.params = Params()

        self.log = StampedLog()
        self.pos_int = np.zeros(2)     # clamped position-error integrators
        self.command = (0.0, 0.0)
        self.prev_t = 0.0

    def load_state(self, other):
        """Copy the carried state (command log, integrators, last command,
        last tick time) from another instance, e.g. the JAX package's."""
        self.log.rows = list(other.log.rows)
        self.pos_int = np.array(other.pos_int, dtype=float)
        self.command = tuple(other.command)
        self.prev_t = other.prev_t

    def _target(self, traj, t_q):
        """Sample the packed target row at the (clipped) query time."""
        table = np.column_stack([
            traj.x, traj.y, traj.velocity, traj.acceleration,
            np.unwrap(traj.orientation, period=2.0 * np.pi),
            traj.curvature])
        row = np.array([np.interp(t_q, traj.time, table[:, c])
                        for c in range(table.shape[1])])
        return None if np.any(np.isnan(row)) else row

    def update(self, con_input):
        t = con_input.t
        veh = con_input.vehicle
        traj = con_input.trajectory

        placeholder = Trajectory()
        placeholder.x = np.array([veh.x])
        placeholder.y = np.array([veh.y])

        dt = min(0.1, t - self.prev_t)
        if dt < 0.0:
            dt = 0
            self.log.clear()
        self.prev_t = t
        if dt == 0 or len(traj.time) < 2:
            return self.command, placeholder

        with self.lock_shared():
            params = snapshot(self.shared.params)

        state = compensate_dead_time(
            self.log, [veh.x, veh.y, veh.phi, veh.delta, veh.v],
            t, veh.dead_time_steer, params.step_comp_dead_time,
            veh.wheel_base)

        t_q = np.clip(t + veh.dead_time_steer, traj.time[0], traj.time[-1])
        trg = self._target(traj, t_q)
        if trg is None:
            return self.command, placeholder

        # flat target at the rear-axle midpoint: shift the reference pose
        # back by the slip-corrected heading psi
        beta = np.arcsin(np.clip(
            trg[TRG_K] * veh.wheel_base * 0.5, -1.0, 1.0))
        psi = trg[TRG_PHI] - beta
        heading_vec = np.array([np.cos(psi), np.sin(psi)])
        p_trg = trg[:2] - veh.wheel_base * 0.5 * heading_vec
        pd_trg = trg[TRG_V] * heading_vec
        pdd_trg = trg[TRG_A] * heading_vec

        # regularize the flatness singularity at standstill
        stopping = state[4] < 1.0
        if stopping:
            state[4] = 1.0
        pd = state[4] * np.array([np.cos(state[2]), np.sin(state[2])])

        self.pos_int = np.clip(self.pos_int + state[:2] - p_trg, -1.0, 1.0)

        # virtual flat-space acceleration command
        u = (pdd_trg - params.k_vel * (pd - pd_trg)
             - params.k_pos * (state[:2] - p_trg)
             - params.ki_pos * self.pos_int)

        speed_sq = pd @ pd
        acc = (pd @ u) / np.sqrt(speed_sq)
        prev_steer = self.command[1]
        if stopping:
            steer = prev_steer
        else:
            # 2-D cross product (np.cross on 2-vectors is removed in
            # numpy 2.x)
            cross = pd[0] * u[1] - pd[1] * u[0]
            steer = np.arctan(np.sign(state[4]) * cross
                              * veh.wheel_base / speed_sq ** 1.5)

        # note: the reference computes a steer-rate limit here but then
        # overwrites it with the raw clipped command
        # (flat_controller.py:149-156) — the effective behavior is the
        # plain clamp below, which we implement directly
        self.command = (
            float(np.clip(acc, params.a_min, params.a_max)),
            float(np.clip(steer, -veh.delta_max, veh.delta_max)))

        if dt > 0.0:
            self.log.push(t, *self.command)
        return self.command, placeholder
