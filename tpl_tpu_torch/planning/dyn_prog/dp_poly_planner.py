"""
Graph/polynomial DP planner driver with a behavior decision layer
(FollowBehavior / EvasiveBehavior configured and selected by cost).

(reference: library/tpl/planning/dyn_prog/dp_poly_planner.py — note the
reference snapshot's driver is unregistered work-in-progress referencing
missing APIs; this driver keeps its structure and behavior layer but runs
against this framework's DP environment.  The JAX package's form is
tpl_tpu/planning/dyn_prog/dp_poly_planner.py.)

A replan builds the environment grids and the directional distance field
on ``tpl_tpu_torch.device()`` (``runtime_environment``), then runs
``poly_planner_kernel.DpPolyPlannerKernel.update`` there: one upload of the
start state, the graph's edge evaluation and propagation kernels, one
download of the trajectory (``runtime_planning``).  Both times end in a
synchronize of the device.
"""

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpl_tpu_torch import util
from tpl_tpu_torch.util import Bundle
from tpl_tpu_torch.ops import curv_to_vel_profile
from tpl_tpu_torch.ops.interp import lerp_xs, short_angle_dist
from tpl_tpu_torch.planning.dyn_prog.dp_env import (
    mark_conflict_zones, smooth_ref_velocity,
)
from tpl_tpu_torch.environment import EnvironmentState
from tpl_tpu_torch.planning.base_planner import BasePlanner
from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.planning.utils import traj_collision_imminent
from tpl_tpu_torch.planning.replan_policy import (
    ReplanPolicy, snapshot_env, pass_gate, cog, trajectory_from_array,
)
from tpl_tpu_torch.planning.dyn_prog.dp_environment import (
    DpEnvironment, DpEnvParams, gen_prediction_quads,
)
from tpl_tpu_torch.planning.dyn_prog.poly_planner_kernel import (
    DpPolyParams, DpPolyPlannerKernel,
    PP_T, PP_S, PP_DS, PP_DDS, PP_L, PP_DL, PP_DDL,
)
from tpl_tpu_torch.ops.splines import PolyQuintic
from tpl_tpu_torch.util import snapshot


@dataclass
class Params:
    update_always: bool = False

    a_lat_max: float = 2.5
    j_max_v_profile: float = 1.5
    j_min_v_profile: float = -1.5

    replan_time: float = 1.0
    # floor for screen-forced early replans: the exact device DP judged
    # the plan valid at the last replan, so the conservative host screen
    # may only pull the next replan forward to this cadence, not to
    # every 0.01 s pass
    replan_time_min: float = 0.25
    dead_time: float = 0.0
    d_reinit_lat: float = 0.5

    write_debug_data: bool = True

    dp_env: DpEnvParams = field(default_factory=DpEnvParams)
    dp_planner: DpPolyParams = field(default_factory=DpPolyParams)


@dataclass
class Behavior:
    """A behavior option is the same graph-DP solve under a different
    lateral-keeping weight; the driver runs the active one each replan
    and switches to whichever option currently scores the lowest cost
    (negative progress, shifted by a per-behavior handicap).
    (reference: dp_poly_planner.py:48-93)"""

    w_l = 10.0            # lateral-keeping weight this behavior plans with

    last_replan_time: float = 0.0
    traj_dp: np.ndarray = None
    params: object = None

    def configure(self, params):
        self.params = snapshot(params)
        self.params.dp_planner.w_l = self.w_l

    def valid(self):
        return self.traj_dp is not None

    def cost_handicap(self):
        return 0.0

    def cost(self):
        # negative progress, shifted by the per-behavior handicap
        return (np.inf if not self.valid()
                else 1000.0 - self.traj_dp[-1, PP_S]
                - self.cost_handicap())


class FollowBehavior(Behavior):
    w_l = 10.0

    def cost_handicap(self):
        # preferred when evasion gains less than one vehicle length
        return self.params.dp_planner.length_veh


class EvasiveBehavior(Behavior):
    w_l = 0.1


def traj_points_at(traj, ts):
    """Quintic re-expansion between stored maneuver points, batched over
    all query times (poly_planner.cu:157-186 DynProgPolyTraj::at).

    One vectorized Hermite solve covers every query — the planner
    interpolates ~50 points per tick, and a per-point scalar version
    cost ~0.5 ms each on the host.
    """
    ts = np.asarray(ts, dtype=np.float64)
    node_t = traj[:, PP_T]
    n = len(traj)
    t_end = node_t[-1]
    i = np.clip(np.searchsorted(node_t, ts, side="right") - 1,
                0, max(n - 2, 0))
    j = np.minimum(i + 1, n - 1)
    start, end = traj[i], traj[j]

    res = np.zeros((len(ts), 8))
    res[:, PP_T] = ts

    # in-segment queries: batched quintics (splines broadcast over the
    # leading query dim); degenerate segments get a widened span and are
    # overwritten by the extrapolation branch below
    et = np.where(end[:, PP_T] > start[:, PP_T],
                  end[:, PP_T], end[:, PP_T] + 1e-6)
    lon = PolyQuintic(start[:, PP_T], start[:, PP_S], start[:, PP_DS],
                      start[:, PP_DDS], et, end[:, PP_S],
                      end[:, PP_DS], end[:, PP_DDS])
    lat = PolyQuintic(start[:, PP_T], start[:, PP_L], start[:, PP_DL],
                      start[:, PP_DDL], et, end[:, PP_L],
                      end[:, PP_DL], end[:, PP_DDL])
    res[:, PP_S] = lon.f(ts)
    res[:, PP_DS] = lon.df(ts)
    res[:, PP_DDS] = lon.ddf(ts)
    res[:, PP_L] = lat.f(ts)
    res[:, PP_DL] = lat.df(ts)
    res[:, PP_DDL] = lat.ddf(ts)

    # beyond the last node (or on a degenerate segment): constant
    # velocity along s, frozen lateral offset
    beyond = (ts > t_end) | (j == i)
    if beyond.any():
        e = end[beyond]
        res[beyond, PP_DS] = e[:, PP_DS]
        res[beyond, PP_S] = e[:, PP_S] + e[:, PP_DS] * (ts[beyond] - t_end)
        res[beyond, PP_DDS] = 0.0
        res[beyond, PP_L] = e[:, PP_L]
        res[beyond, PP_DL] = 0.0
        res[beyond, PP_DDL] = 0.0
    return res


def traj_point_at(traj, t):
    """Single-query convenience wrapper over :func:`traj_points_at`."""
    return traj_points_at(traj, np.array([t]))[0]


def _synchronize(t):
    """Wait for the work queued on ``t``'s device (a CUDA tensor's)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class DpPolyPlanner(BasePlanner):

    def __init__(self, shared, lock_shared):
        np.seterr(divide="ignore", invalid="ignore")

        self.shared = shared
        self.lock_shared = lock_shared

        self.policy = ReplanPolicy()
        self.last_time = -1.0
        self.last_shift_time = -1.0   # per-pass trajectory-age clock

        self.ref_line = None
        self.ref_line_shift = 0.0
        self.ref_line_step_size = 0.5
        self.ref_proj = None

        self.behavior_options = [FollowBehavior()]
        self.behavior = self.behavior_options[0]

        self.init_state = None
        self.trajectory = Trajectory()
        self.trajectory_np = None

        self.dp_env = DpEnvironment()
        self.dp_planner = DpPolyPlannerKernel()

        self.runtime_planning = 0.0
        self.runtime_environment = 0.0

        with self.lock_shared():
            self.shared.params = Params()
            self.shared.debug = Bundle()

    def update_params(self, env):
        veh = env.vehicle_state
        with self.lock_shared():
            params = self.shared.params
            length_veh = veh.rear_axis_to_front + veh.rear_axis_to_rear
            params.dp_planner.length_veh = length_veh
            params.dp_planner.width_veh = veh.width
            params.dp_env.dilation = np.sqrt(2.0) * veh.width * 0.5
            sh_params = snapshot(params)
        return sh_params

    def update_reference_line(self, env, params):
        """(dp_poly_planner.py:182-226)"""
        if self.ref_line is not None:
            proj_prev = util.project(self.ref_line[:, :2],
                                     env.local_map.path[0, :2])
            self.ref_line_shift = round(
                proj_prev.arc_len / self.ref_line_step_size) \
                * self.ref_line_step_size

        lm = env.local_map
        self.ref_line = np.column_stack(
            [lm.path, lm.d_left, lm.d_right, np.zeros(len(lm.path))])
        self.ref_line_step_size = lm.step_size_ref

        self.ref_line[:, 5] = curv_to_vel_profile(
            self.ref_line[:, 4], self.ref_line[:, 5], params.a_lat_max)
        self.ref_line[:, 5] = smooth_ref_velocity(
            self.ref_line[:, 5],
            params.dp_planner.dds_min, params.dp_planner.dds_max,
            params.j_min_v_profile, params.j_max_v_profile,
            env.local_map.step_size_ref)
        mark_conflict_zones(self.ref_line,
                            env.local_map.intersection_paths,
                            skip_oob=True)

    def update_environment(self, env, params):
        start = time.perf_counter()
        self.dp_env.reinit_buffers(params.dp_env)
        self.dp_env.set_ref_line(self.ref_line, self.ref_line_step_size)

        maps = {m.uuid: m for m in env.get_relevant_maps()}
        for obj in env.predicted:
            for pred in obj.predictions:
                m = maps.get(pred.uuid_assoc_map)
                if m is None:
                    continue
                ts = np.array([0.0, *(params.dp_env.dt_start
                                      + pred.states[:-1, 0])])
                quads = gen_prediction_quads(
                    pred.states, obj.hull, m.path[:, :2], ts,
                    station_step_size=5.0, sweep_length=0.5)
                self.dp_env.insert_geometry(quads, obj.stationary)

        self.dp_env.update()
        _synchronize(self.dp_env.update_dir_dist_map())
        self.runtime_environment = (time.perf_counter() - start) * 1000.0

    def update_planner(self, env, params, replan):
        if not replan:
            return
        self.behavior.configure(params)
        self.dp_planner.reinit_buffers(self.behavior.params.dp_planner)

        start = time.perf_counter()
        self.behavior.traj_dp = self.dp_planner.update(
            self.init_state, self.dp_env)
        self.runtime_planning = (time.perf_counter() - start) * 1000.0
        self.behavior.last_replan_time = env.t

        # pick the lowest-cost valid behavior
        best = min(self.behavior_options, key=lambda b: b.cost())
        if best.valid():
            self.behavior = best

    def update_trajectory(self, env, params):
        p = params.dp_planner
        traj_dp = self.behavior.traj_dp

        ts = np.arange(traj_dp[0, PP_T], (p.t_steps - 1) * p.dt, p.dt_cart)
        pts = traj_points_at(traj_dp, ts)

        # frenet -> cartesian (poly_planner.cu:446-494) against the
        # CURRENT host ref-line window (cols 0..5 = x, y, phi, s, k, v):
        # the per-tick shift in update_initial_state keeps traj_dp in
        # this window's frame, while the device env only refreshes at
        # the replan cadence
        rl = self.ref_line
        grid_s = np.arange(len(rl)) * self.ref_line_step_size
        x_r = lerp_xs(pts[:, PP_S], grid_s, rl[:, 0])
        y_r = lerp_xs(pts[:, PP_S], grid_s, rl[:, 1])
        h_r = lerp_xs(pts[:, PP_S], grid_s, rl[:, 2], angle=True)
        k_r = lerp_xs(pts[:, PP_S], grid_s, rl[:, 4])

        n = len(pts)
        cart = np.zeros((n, 8))
        cart[:, 0] = pts[:, PP_T] + env.t + params.dead_time
        cart[:, 2] = x_r - pts[:, PP_L] * np.sin(h_r)
        cart[:, 3] = y_r + pts[:, PP_L] * np.cos(h_r)
        cart[:, 6] = np.where(
            pts[:, PP_DS] < 1e-3, h_r,
            np.arctan(pts[:, PP_DL] / np.maximum(pts[:, PP_DS], 1e-9))
            + h_r)
        cart[:, 4] = np.sqrt(
            ((1.0 - k_r * pts[:, PP_L]) * pts[:, PP_DS]) ** 2
            + pts[:, PP_DL] ** 2)
        if n > 1:
            dxy = np.diff(cart[:, 2:4], axis=0)
            seg = np.hypot(dxy[:, 0], dxy[:, 1])
            cart[1:, 1] = np.cumsum(seg)
            dt_ = np.maximum(np.diff(cart[:, 0]), 1e-9)
            cart[:-1, 5] = np.diff(cart[:, 4]) / dt_
            cart[-1, 5] = cart[-2, 5]
            cart[:-1, 7] = short_angle_dist(cart[:-1, 6], cart[1:, 6]) \
                / np.maximum(seg, 1e-9)
            cart[-1, 7] = cart[-2, 7]

        self.trajectory_np = cart
        self.trajectory = trajectory_from_array(cart)

    def reset_initial_state(self, veh, params):
        proj = util.project(self.ref_line[:, :2], cog(veh))

        self.init_state = np.zeros(8)
        self.init_state[PP_S] = proj.arc_len + veh.v * params.dead_time
        self.init_state[PP_DS] = veh.v
        self.init_state[PP_L] = self.ref_proj.distance
        self.trajectory_np = None

    def update_initial_state(self, env, params):
        """(dp_poly_planner.py:344-410)"""
        veh = env.vehicle_state
        self.ref_proj = util.project(env.local_map.path[:, :2],
                                     [veh.x, veh.y])
        pol = self.policy

        t_traj = env.t - self.last_shift_time
        self.last_shift_time = env.t

        # cold starts: a human driving, a world jump, or nothing stored
        # yet (reset_changed is side-effecting and must stay behind the
        # automated check, mirroring when the reference samples it)
        if (not veh.automated or pol.reset_changed(env)
                or self.behavior.traj_dp is None):
            self.reset_initial_state(veh, params)
            return True

        if self.trajectory_np is not None and len(self.trajectory.x):
            pos_traj = np.vstack([self.trajectory.x,
                                  self.trajectory.y]).T
            if pol.off_plan_lateral(util.project, pos_traj, cog(veh),
                                    params.d_reinit_lat):
                self.reset_initial_state(veh, params)
                return True

        # shift trajectory: re-expand at the original node times, slide
        # by the elapsed time and the ref-line window shift, keep nodes
        # still ahead (one batched quintic solve for all nodes)
        self.init_state = traj_point_at(self.behavior.traj_dp, t_traj)
        self.init_state[PP_T] = 0.0
        self.init_state[PP_S] -= self.ref_line_shift

        pts = traj_points_at(self.behavior.traj_dp,
                             self.behavior.traj_dp[1:, PP_T])
        pts[:, PP_T] -= t_traj
        pts[:, PP_S] -= self.ref_line_shift
        self.behavior.traj_dp = np.vstack(
            [self.init_state[None], pts[pts[:, PP_T] > 0.0]])

        due = (env.t - self.behavior.last_replan_time
               >= params.replan_time)
        return due or params.update_always

    def write_debug_data(self, t, params, veh):
        with self.lock_shared():
            dbg = self.shared.debug
            dbg.ref_line = self.ref_line
            dbg.runtime_planning = self.runtime_planning
            dbg.runtime_environment = self.runtime_environment
            if self.behavior.traj_dp is not None:
                dbg.traj_dp = self.behavior.traj_dp.copy()

    def update(self, sh_env):
        env = snapshot_env(sh_env, EnvironmentState(),
                           fields=("vehicle_state", "local_map",
                                   "local_map_behind", "selected_map",
                                   "predicted"))
        if env.local_map is None:
            return self.trajectory

        params = self.update_params(env)

        if self.last_time == env.t and not params.update_always:
            time.sleep(0.001)
        if self.last_time > env.t:
            self.last_shift_time = 0.0
            for b in self.behavior_options:
                b.last_replan_time = 0.0
        update_needed, self.last_time = pass_gate(
            env, self.last_time, params.update_always)

        if update_needed:
            self.last_time = env.t
            self.update_reference_line(env, params)
            replan = self.update_initial_state(env, params)
            # between replans the pass is host-only: a conservative
            # screen of the stored plan against the latest predictions
            # forces the replan one pass early on new threats, so the
            # expensive device pipeline (env grids + graph DP) runs at
            # the replan cadence, not per 0.01 s tick (same policy as
            # dp_lat_lon_planner.py update())
            if (not replan
                    and env.t - self.behavior.last_replan_time
                    >= params.replan_time_min
                    and traj_collision_imminent(
                        self.trajectory_np, env.predicted,
                        params.dp_planner.width_veh,
                        params.dp_planner.length_veh, env.t)):
                replan = True
            if replan:
                self.update_environment(env, params)
            self.update_planner(env, params, replan)
            self.update_trajectory(env, params)

        if params.write_debug_data:
            self.write_debug_data(env.t, params, env.vehicle_state)

        return self.trajectory
