"""
Spatial-progress MPC tracking controller: the planned trajectory is
resampled into equidistant reference arrays and tracked with the
reference progress s_r carried as a solver state. Built on the shared
TrackingMpc template (solver setup, dead-time compensation, idle
handling live there).

Behavioral parity target:
library/tpl/control/model_predictive_controller.py:95-237; the port of
tpl_tpu/control/model_predictive_controller.py.
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
        self.pdelta_dot = 0.0
        self.min_p_phi_dot = 0.0
        self.p_phi_dot = 0.0
        self.p_phi = 0.01
        self.p_phi_ref_dot_diff = 0.01
        self.pa = 2.0
        self.pj = 0.5


class Params:

    def __init__(self):
        self.horizon = 60
        self.step = 0.05
        self.max_iterations = 20

        self.acc_min = -3.0
        self.acc_max = 3.0
        self.jerk_min = -3.0
        self.jerk_max = 1.5
        self.steer_rate_min = -1.0
        self.steer_rate_max = 1.0

        self.ref_step = 0.5

        self.cost_function = CostFunctionParams()
        self.idle_comp = IdleCompensationParams()


class ModelPredictiveController(TrackingMpc):

    # state layout: [x, y, phi, delta, v, s_r, a]
    IDX_ACC = 6
    IDX_VEL_REF = 5          # velocity column of the resampled reference
    PARAMS = Params

    def __init__(self, shared, lock_shared):
        super().__init__(shared, lock_shared)
        # smoothed controller cycle time drives the dead-time rollout
        self.cycle_time_estimate = 0.01

    def _make_problem(self):
        return problems.trajectory_tracking_mpc(ref_capacity=128)

    def _on_tick(self, delta_time):
        if 0.0 <= delta_time <= 1.0:
            self.cycle_time_estimate = (0.95 * self.cycle_time_estimate
                                        + 0.05 * delta_time)
        else:
            # time jumped: the in-flight command history is meaningless
            self.history.clear()

    def _cycle_dt(self, params):
        return self.cycle_time_estimate

    def _make_reference(self, traj, veh, params):
        course = np.vstack([traj.x, traj.y, traj.orientation, traj.s,
                            traj.curvature, traj.velocity]).T
        grid = util.resample_path(course, params.ref_step, 100,
                                  start_index=0, zero_vel_at_end=True)
        if grid is None:
            return None
        self.lat_dist_to_traj = util.project(
            grid[:, :2], (veh.x, veh.y)).distance
        # center UTM coordinates on the reference start: kept from the JAX
        # package, whose float32 device solves lose 0.5 m to the ulp at UTM
        # magnitude (~5e6); positions only enter through differences, so
        # the rigid translation is exact
        return Bundle(grid=grid,
                      x_off=float(grid[0, 0]), y_off=float(grid[0, 1]))

    def _program_solver(self, veh, params, ref):
        p = self.opt.params
        p.l = veh.wheel_base
        p.ref_x = ref.grid[:, 0] - ref.x_off
        p.ref_y = ref.grid[:, 1] - ref.y_off
        p.ref_phi = ref.grid[:, 2]
        p.ref_k = ref.grid[:, 4]
        p.ref_v = ref.grid[:, 5]
        p.ref_step = params.ref_step
        p.a_offset = 9.81 * np.sin(veh.pitch)

    def _initial_state(self, veh, params, ref):
        return np.array([veh.x - ref.x_off, veh.y - ref.y_off,
                         veh.phi, veh.delta, veh.v, 0.0, veh.a])

    def _anchor(self, x0, ref):
        # seed the progress state by projecting the (dead-time
        # compensated) position onto the centered reference
        centered = ref.grid[:, :2] - (ref.x_off, ref.y_off)
        x0[5] = util.project(centered, x0[:2]).arc_len
        return x0

    def _stamp_dead_time(self, trace, ref):
        trace[:, 1] += ref.x_off
        trace[:, 2] += ref.y_off
        return trace

    def _idle_engaged(self, veh, params, ref):
        look = params.idle_comp.traj_look_ahead_steps
        return ref.grid[look, self.IDX_VEL_REF] < params.idle_comp.traj_thresh

    def _predicted_trajectory(self, t, veh, ref):
        out = self._base_trajectory(t, veh, ref.x_off, ref.y_off)
        out.s = self.opt.x[:-1, 5] - self.opt.x[0, 5]
        out.acceleration = self.opt.u[:, 0].copy()
        return out
