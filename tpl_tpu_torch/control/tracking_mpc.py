"""
Shared machinery for the trajectory-tracking MPC controllers: solver
construction, the issued-control log with dead-time forward rollout,
standstill (idle) compensation, and the template update loop. The two
concrete controllers (spatial-progress and time-indexed) reduce to a
reference builder plus a handful of layout hooks on top of this.

Behavioral parity targets:
library/tpl/control/model_predictive_controller.py:95-237 and
model_predictive_controller_time.py (same algorithm, restructured); the
port of tpl_tpu/control/tracking_mpc.py.  The solver runs in float64 on
``tpl_tpu_torch.device()``: on a CUDA device the tracking MPC's solve is one
launch of the hand-written iLQR kernel.
"""

import numpy as np
import torch

from tpl_tpu_torch.util import runtime, snapshot
from tpl_tpu_torch.optim.solver import Solver
from tpl_tpu_torch.control.base_controller import BaseController
from tpl_tpu_torch.planning.trajectory import Trajectory


class IdleCompensationParams:

    def __init__(self):
        self.active = False
        self.min_acc = -2.0
        self.jerk = -1.0
        self.veh_thresh = 0.5
        self.traj_thresh = 0.1
        self.traj_look_ahead_steps = 5


class IdleCompensation:
    """Near-standstill override: ramp braking down at a fixed jerk and
    freeze the steering command so the car settles instead of hunting."""

    def __init__(self):
        self.acc_ramp = 0.0
        self.held_steer = 0.0

    def apply(self, p, engaged, acc, steer, delta_time):
        if engaged:
            self.acc_ramp += p.jerk * delta_time
            steer = self.held_steer
        else:
            self.held_steer = steer
            self.acc_ramp = 0.0
        self.acc_ramp = min(0.0, max(p.min_acc, self.acc_ramp))
        return acc + self.acc_ramp, steer


class ControlLog:
    """Ring buffer of issued (acc, steer) commands.

    `rollforward` compensates actuator dead time by integrating the
    measured state through the commands still in flight, using the
    solver's own dynamics so the compensation model matches the MPC
    prediction model exactly.
    """

    def __init__(self, capacity=100):
        self.capacity = capacity
        self.entries = []

    def clear(self):
        self.entries = []

    def push(self, acc, steer):
        self.entries.append((acc, steer))
        if len(self.entries) > self.capacity:
            self.entries.pop(0)

    def rollforward(self, solver, x0, t, cycle_dt, dead_time,
                    idx_delta, idx_acc):
        """Returns (compensated x0, stamped (steps+1, 1+nx) trace).

        The whole command window runs through the solver's
        `Solver.rollforward_deadtime`; the window is front-padded to its
        full length (padding rows pass the state through).
        """
        n = int(dead_time / cycle_dt + 1e-5)
        k = min(n, len(self.entries))
        if n == 0:
            return x0, np.concatenate([[t], x0])[None]
        cmds = np.zeros((n, 2))
        if k > 0:
            cmds[n - k:] = self.entries[-k:]
        valid = np.arange(n) >= (n - k)
        states = solver.rollforward_deadtime(
            x0, cmds, valid, idx_delta, idx_acc, cycle_dt)[n - k:]
        times = t + np.arange(k + 1) * cycle_dt
        trace = np.concatenate([times[:, None], states], axis=1)
        return states[-1].copy(), trace


class TrackingMpc(BaseController):
    """Template for both tracking MPCs.

    Subclasses provide the problem factory and the state layout
    (IDX_ACC), build the reference arrays, seed the initial state, and
    assemble the predicted trajectory; everything else — solver setup,
    dead-time compensation, control extraction/clamping, idle
    compensation, history bookkeeping — runs here.
    """

    ABSTRACT = True          # not a registrable controller by itself
    IDX_DELTA = 3
    IDX_ACC = None           # subclass: acceleration slot in the state
    HORIZON_MAX = 60
    PARAMS = None            # subclass: Params class for the shared store

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared

        prob, spec = self._make_problem()
        self.opt = Solver(prob, spec, horizon_max=self.HORIZON_MAX,
                          dtype=torch.float64)
        self.opt.integrator_type = self.opt.HEUN
        self.opt.lg_mult_limit = 0.0
        self.opt.barrier_weight[:] = 10000.0
        self.opt.params.v_ch = 32.0
        self.opt.params.max_delta = 0.7

        self.history = ControlLog()
        self.idle = IdleCompensation()
        self.controls = (0.0, 0.0)
        self.con_traj = Trajectory()
        self.dead_time_trajectory = np.zeros((0, self.IDX_ACC + 2))
        self.lat_dist_to_traj = 0.0
        self.jerk = 0.0
        self.last_update_time = 0.0

        with self.lock_shared():
            self.shared.params = self.PARAMS()

    # -- subclass hooks ------------------------------------------------

    def _make_problem(self):
        raise NotImplementedError

    def _on_tick(self, delta_time):
        """History-reset / cycle-estimate policy."""
        raise NotImplementedError

    def _make_reference(self, traj, veh, params):
        """Returns an opaque reference object, or None to hold the last
        command. Must also set self.lat_dist_to_traj."""
        raise NotImplementedError

    def _program_solver(self, veh, params, ref):
        """Write reference arrays + problem params into the solver."""
        raise NotImplementedError

    def _initial_state(self, veh, params, ref):
        raise NotImplementedError

    def _cycle_dt(self, params):
        """Integration step for the dead-time rollforward."""
        raise NotImplementedError

    def _anchor(self, x0, ref):
        """Final x0 fixup after dead-time compensation (e.g. progress
        re-projection). Default: unchanged."""
        return x0

    def _stamp_dead_time(self, trace, ref):
        """Post-process the dead-time trace (e.g. undo UTM centering)."""
        return trace

    def _idle_engaged(self, veh, params, ref):
        raise NotImplementedError

    def _predicted_trajectory(self, t, veh, ref):
        raise NotImplementedError

    # -- template ------------------------------------------------------

    def _solver_limits(self, params):
        opt = self.opt
        opt.u_min[:, 0] = params.jerk_min
        opt.u_max[:, 0] = params.jerk_max
        opt.u_min[:, 1] = params.steer_rate_min
        opt.u_max[:, 1] = params.steer_rate_max
        opt.params.min_acc = params.acc_min
        opt.params.max_acc = params.acc_max
        opt.params.merge(vars(params.cost_function))
        opt.horizon = params.horizon
        opt.step = params.step
        opt.max_iterations = params.max_iterations

    @runtime
    def update(self, con_input):
        t = con_input.t
        veh = con_input.vehicle
        traj = con_input.trajectory

        delta_time = t - self.last_update_time
        self._on_tick(delta_time)

        with self.lock_shared():
            params = snapshot(self.shared.params)

        if traj is None or len(traj.time) < 2:
            return self.controls, self.con_traj
        ref = self._make_reference(traj, veh, params)
        if ref is None:
            return self.controls, self.con_traj

        self._solver_limits(params)
        self._program_solver(veh, params, ref)

        x0 = self._initial_state(veh, params, ref)
        if veh.dead_time_steer > 0.0:
            x0, trace = self.history.rollforward(
                self.opt, x0, t, self._cycle_dt(params),
                veh.dead_time_steer, self.IDX_DELTA, self.IDX_ACC)
            self.dead_time_trajectory = self._stamp_dead_time(trace, ref)
        x0 = self._anchor(x0, ref)

        self.opt.x[0] = x0
        self.opt.update()

        steer = float(np.clip(self.opt.x[1][self.IDX_DELTA],
                              -veh.delta_max, veh.delta_max))
        acc = float(np.clip(self.opt.x[1][self.IDX_ACC],
                            params.acc_min, params.acc_max))

        if delta_time > 0.0:
            self.history.push(acc, steer)
        self.last_update_time = t

        p_idle = params.idle_comp
        engaged = (p_idle.active and veh.v < p_idle.veh_thresh
                   and self._idle_engaged(veh, params, ref))
        acc, steer = self.idle.apply(p_idle, engaged, acc, steer, delta_time)

        self.jerk = self.opt.u[0][0]
        self.controls = (acc, steer)
        self.con_traj = self._predicted_trajectory(t, veh, ref)
        return self.controls, self.con_traj

    def _base_trajectory(self, t, veh, x_off=0.0, y_off=0.0):
        """Predicted rollout shared by both layouts (x,y,phi,delta,v...)."""
        opt = self.opt
        out = Trajectory()
        out.time = t + np.arange(0, opt.T * opt.dt, opt.dt)
        out.x = opt.x[:-1, 0] + x_off
        out.y = opt.x[:-1, 1] + y_off
        out.orientation = opt.x[:-1, 2].copy()
        out.velocity = opt.x[:-1, 4].copy()
        out.curvature = np.tan(opt.x[:-1, self.IDX_DELTA]) / veh.wheel_base
        return out
