"""
Time-indexed MPC tracking controller: tracks (x, y, v)(t) directly on
the planned trajectory's own time grid with a CoG slip-angle bicycle
model. Built on the shared TrackingMpc template.

Behavioral parity target:
library/tpl/control/model_predictive_controller_time.py; the port of
tpl_tpu/control/model_predictive_controller_time.py.  The solve
(``trajectory_tracking_mpc_time``: nx=6, nu=2, nc=4, HEUN, float64 on
``tpl_tpu_torch.device()``) is one launch of the hand-written kernel
``csrc/ilqr_tracking_mpc_time.cu`` on a CUDA device
(``optim/ilqr_tracking_mpc_time.py``); the dead-time window runs through
``Solver.rollforward_deadtime`` with the acceleration in slot 5.
"""

import numpy as np

from tpl_tpu_torch import util
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.util import Bundle
from tpl_tpu_torch.control.tracking_mpc import (
    TrackingMpc, IdleCompensationParams)


class CostFunctionParams:

    def __init__(self):
        self.pd = 10.0
        self.pv = 5.0
        self.pdelta = 0.0
        self.min_pdelta_dot = 0.1
        self.pdelta_dot = 0.1
        self.min_p_phi_dot = 0.0
        self.p_phi_dot = 0.0
        self.p_phi = 0.0
        self.p_phi_ref_dot_diff = 0.0
        self.pa = 2.0
        self.pj = 0.5


class Params:

    def __init__(self):
        self.horizon = 40
        self.step = 0.05
        self.max_iterations = 20

        self.cycle_time = 0.01
        self.acc_min = -3.0
        self.acc_max = 3.0
        self.jerk_min = -3.0
        self.jerk_max = 1.5
        self.steer_rate_min = -1.0
        self.steer_rate_max = 1.0

        self.cog_pos = 0.5
        self.ref_dt = 0.1

        self.cost_function = CostFunctionParams()
        self.idle_comp = IdleCompensationParams()


class ModelPredictiveControllerTime(TrackingMpc):

    # state layout: [x, y, phi, delta, v, a] (CoG position)
    IDX_ACC = 5
    PARAMS = Params

    def _make_problem(self):
        return problems.trajectory_tracking_mpc_time(ref_capacity=128)

    def _on_tick(self, delta_time):
        if delta_time < 0.0:
            self.history.clear()

    def _cycle_dt(self, params):
        return params.cycle_time

    def _make_reference(self, traj, veh, params):
        self.lat_dist_to_traj = util.project(
            np.vstack((traj.x, traj.y)).T, (veh.x, veh.y)).distance
        # center UTM coordinates on the trajectory start: kept from the JAX
        # package (its float32 device tracing lost the ulp at UTM
        # magnitude); positions only enter through differences, and the
        # reference tables hold small numbers
        return Bundle(traj=traj,
                      x_off=float(traj.x[0]), y_off=float(traj.y[0]))

    def _program_solver(self, veh, params, ref):
        p = self.opt.params
        traj = ref.traj
        p.l = veh.wheel_base
        p.ref_x = np.asarray(traj.x) - ref.x_off
        p.ref_y = np.asarray(traj.y) - ref.y_off
        p.ref_phi = traj.orientation
        p.ref_v = traj.velocity
        p.ref_dt = params.ref_dt
        p.ref_t_offset = veh.dead_time_steer
        p.a_offset = 9.81 * np.sin(veh.pitch)
        p.cog_pos = params.cog_pos

    def _initial_state(self, veh, params, ref):
        lever = params.cog_pos * veh.wheel_base
        return np.array([
            veh.x - ref.x_off + np.cos(veh.phi) * lever,
            veh.y - ref.y_off + np.sin(veh.phi) * lever,
            veh.phi, veh.delta, veh.v, veh.a])

    def _idle_engaged(self, veh, params, ref):
        look = params.idle_comp.traj_look_ahead_steps
        v_ref = ref.traj.velocity
        return look < len(v_ref) and v_ref[look] < params.idle_comp.traj_thresh

    def _predicted_trajectory(self, t, veh, ref):
        out = self._base_trajectory(t, veh, ref.x_off, ref.y_off)
        out.acceleration = self.opt.x[:, 5].copy()
        return out
