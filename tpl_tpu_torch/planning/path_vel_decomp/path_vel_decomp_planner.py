"""
RSTP planner: path/velocity-decomposed spatial trajectory planning
(IV 2023 / ACC 2024). Orchestrates path smoothing or corridor path
optimization followed by velocity optimization, then assembles the
trajectory.  The port of
``tpl_tpu/planning/path_vel_decomp/path_vel_decomp_planner.py``; it
replans on every tick, and with ``use_fused`` (the vendored param set)
the whole replan is :class:`FusedRstpReplan` on ``tpl_tpu_torch.device()``.
The GUI renderer hook is not ported.
(reference: library/tpl/planning/path_vel_decomp/path_vel_decomp_planner.py)
"""

import numpy as np

from tpl_tpu_torch.util import runtime, Bundle
from tpl_tpu_torch.planning.base_planner import BasePlanner
from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.planning.path_vel_decomp.path_smoothing import (
    PathSmoothing, Params as PathSmoothingParams)
from tpl_tpu_torch.planning.path_vel_decomp.path_optim import (
    PathOptim, Params as PathOptimParams)
from tpl_tpu_torch.planning.path_vel_decomp.velocity_optim import (
    VelocityOptim, Params as VelocityOptimParams)
from tpl_tpu_torch.planning.path_vel_decomp.fused_replan import (
    FusedRstpReplan)
from tpl_tpu_torch.planning.utils import traj_collision_imminent
from tpl_tpu_torch.environment import EnvironmentState
from tpl_tpu_torch.planning.replan_policy import snapshot_env
from tpl_tpu_torch.util import snapshot


class Params:

    def __init__(self):
        self.horizon = 250
        # disables obstacle avoidance; only smooth the reference locally
        self.smooth_only = False
        self.write_debug_data = False
        # single-dispatch device pipeline (fused_replan.py): one device
        # round trip per replan instead of two
        self.use_fused = True

        # Safety layer beyond the reference: screen the published plan
        # against the latest predictions every tick; a predicted overlap
        # latches trajectory.emergency, which routes control to the
        # const-acc hard brake (control_app.py:119-121 semantics) until
        # the plan has been conflict-free for screen_hold_time seconds.
        self.collision_screen = True
        self.screen_hold_time = 1.0
        # marginal overlaps only latch the hard brake when ego and object
        # actually close on each other this fast: the velocity plan's tail
        # legitimately bunches up behind a matched-speed leader
        # (closing ~ 0), while oncoming/crossing threats close fast
        self.screen_min_closing = 1.0

        self.path_smoothing = PathSmoothingParams()
        self.path_optim = PathOptimParams()
        self.velocity_optim = VelocityOptimParams()


class PathVelDecompPlanner(BasePlanner):

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared

        self.path_smoothing = PathSmoothing()
        self.path_optim = PathOptim()
        self.velocity_optim = VelocityOptim()
        self.fused = None  # built lazily on the first fused tick

        self.trajectory = Trajectory()
        self.last_screen_hit = -np.inf

        with self.lock_shared():
            self.shared.params = Params()
            self.shared.debug = Bundle()

        self.env = EnvironmentState()

    def write_debug_data(self, env, params):
        vo = self.velocity_optim
        dbg = Bundle()
        dbg.s_leader = vo.s_leader
        dbg.v_leader = vo.v_leader
        if params.write_debug_data:
            dbg.opt_path = self.path_optim.opt_path
            dbg.d_lower_constr = self.path_optim.d_lower_constr
            dbg.d_upper_constr = self.path_optim.d_upper_constr
            dbg.v_lim = np.maximum(0.0, vo.v_lim)
            dbg.v_ref = np.maximum(
                0.0, np.minimum(vo.v_lim, vo.v_ref[:, 0]))
        with self.lock_shared():
            self.shared.debug = dbg

    def screen_trajectory(self, env, params):
        """Per-tick host screen of the freshly planned trajectory against
        the latest predictions (planning/utils.traj_collision_imminent).
        A hit latches ``trajectory.emergency`` for screen_hold_time so the
        vehicle hard-brakes out of the conflict instead of tracking a plan
        the world has already invalidated.  No reference counterpart: the
        reference RSTP planner publishes into the conflict (its own stress
        scenarios collide, see PARITY.md)."""
        traj = self.trajectory
        if not params.collision_screen or len(traj.x) == 0:
            traj.emergency = False
            return
        veh = env.vehicle_state
        traj_np = np.zeros((len(traj.x), 7))
        traj_np[:, 0] = traj.time
        traj_np[:, 2] = traj.x
        traj_np[:, 3] = traj.y
        traj_np[:, 6] = traj.orientation
        l_veh = veh.rear_axis_to_front + veh.rear_axis_to_rear
        if traj_collision_imminent(traj_np, env.predicted, veh.width,
                                   l_veh, env.t,
                                   min_closing_speed=params.screen_min_closing,
                                   ignore_leading_aligned=True):
            self.last_screen_hit = env.t
        if env.t < self.last_screen_hit:  # time jumped backwards
            self.last_screen_hit = -np.inf
        traj.emergency = bool(
            env.t - self.last_screen_hit < params.screen_hold_time)

    @runtime
    def update(self, sh_env):
        with self.lock_shared():
            params = snapshot(self.shared.params)

        params.path_optim.horizon = params.horizon
        params.velocity_optim.horizon = params.horizon

        env = snapshot_env(sh_env, self.env)
        if env.local_map is None:
            return self.trajectory

        # ask the map module for the windowing this planner needs: the
        # velocity limit window starts min_d_safe behind the front bumper
        ahead = (env.vehicle_state.rear_axis_to_front
                 + params.velocity_optim.min_d_safe)
        with sh_env.lock():
            lm = sh_env.local_map
            if lm is None:      # env reset between the two lock windows
                return self.trajectory
            lm.update_inters_paths = True
            lm.step_shift_idx = 1
            lm.shift_vel_lim = -int(ahead / lm.step_size_ref)

        if not params.smooth_only and params.use_fused:
            return self._update_fused(env, params)

        if params.smooth_only:
            self.path_optim.reset_required = True
            self.path_smoothing.update(env, params.path_smoothing)
            opt_path = self.path_smoothing.opt_path
        else:
            self.path_smoothing.reset_required = True
            self.path_optim.update(env, params.path_optim)
            opt_path = self.path_optim.opt_path

        vo = self.velocity_optim
        vo.update(opt_path, env, params.velocity_optim)

        n = params.velocity_optim.horizon
        return self._publish(env, params, opt_path,
                             time_prof=vo.opt.x[:n, 1].copy(),
                             s=np.arange(n) * params.velocity_optim.step,
                             velocity=vo.v_opt,
                             acceleration=vo.opt.u[:, 0].copy())

    def _update_fused(self, env, params):
        """Single-dispatch replan through the fused device pipeline."""
        # Size the fused step at the configured horizon: the solves are
        # serial scans over horizon_max steps, so padding a 100-step
        # problem to a fixed 256 would pay 2.5x the latency.  Rebuilding
        # (losing warm starts) only happens when the horizon parameter
        # itself moves.
        H = max(16, int(params.horizon))
        if self.fused is None or self.fused.H != H:
            self.fused = FusedRstpReplan(horizon_max=H)

        self.path_smoothing.reset_required = True
        prep = self.path_optim.prepare(env, params.path_optim)
        out = self.fused.step(prep, env, params.path_optim,
                              params.velocity_optim)
        T = out["T"]
        opt_path = out["opt_path"]

        # mirror host-pipeline bookkeeping so debug output and a later
        # switch back to the host path stay consistent
        self.path_optim.opt_path = opt_path
        vo = self.velocity_optim
        vo.s_leader = float(out["s_leader"])
        vo.v_leader = float(out["v_leader"])
        vo.v_lim = out["v_lim"]
        vo.v_ref = out["v_ref"]
        vo.v_opt = out["v_opt"]
        vo.stop_mask = out["stop_mask"][:T]

        return self._publish(env, params, opt_path,
                             time_prof=out["time_prof"][:T],
                             s=np.arange(T) * params.velocity_optim.step,
                             velocity=out["v_opt"],
                             acceleration=out["acc"][:T])

    def _publish(self, env, params, opt_path, time_prof, s, velocity,
                 acceleration):
        """Assemble the planned spatial path + velocity profile into the
        published trajectory, write debug bundles, and run the per-tick
        collision screen."""
        self.write_debug_data(env, params)

        traj = self.trajectory
        traj.time = env.t + time_prof
        traj.s = s
        traj.x = opt_path[:, 0].copy()
        traj.y = opt_path[:, 1].copy()
        traj.orientation = opt_path[:, 2].copy()
        traj.curvature = opt_path[:, 4].copy()
        traj.velocity = velocity
        traj.acceleration = acceleration

        self.screen_trajectory(env, params)
        return self.trajectory
