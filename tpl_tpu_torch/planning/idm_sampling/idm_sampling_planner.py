"""
IDM sampling rollout planner: object preprocessing (hull sweeps,
prediction projections), candidate setup, dead-time trajectory buffer,
warm-started candidate selection with decision hysteresis, reverse-driving
detection, and emergency handling.
(reference: library/src/idm_sampling.cpp:666-905 update and
library/tpl/planning/idm_sampling/idm_sampling_planner.py; the JAX
package's form is tpl_tpu/planning/idm_sampling/idm_sampling_planner.py)

The host work stays numpy.  A replan is one upload (every input packed into
one float32 buffer), the two kernel launches of ``idm_kernel`` (rollout,
then evaluation) on ``tpl_tpu_torch.device()``, and one download (the
states and costs of every candidate, one buffer).
"""

import time

import numpy as np
import torch

import tpl_tpu_torch
from tpl_tpu_torch import util
from tpl_tpu_torch.util import Bundle
from tpl_tpu_torch.ops import rampify_profile, convex_hull, project
from tpl_tpu_torch.ops.interp import short_angle_dist
from tpl_tpu_torch.environment import EnvironmentState
from tpl_tpu_torch.planning.base_planner import BasePlanner
from tpl_tpu_torch.planning.replan_policy import EmergencyLatch
from tpl_tpu_torch.planning.trajectory import Trajectory
from tpl_tpu_torch.planning.idm_sampling import idm_kernel
from tpl_tpu_torch.planning.idm_sampling.idm_kernel import (
    IdmSamplingParams, OBJ_KEYS, COST_KEYS,
    R_T, R_X, R_Y, R_H, R_V, R_A, R_S, R_L,
    V_T, V_X, V_Y, V_H, V_ST, V_V, V_A, V_S, V_L,
)
from tpl_tpu_torch.util import snapshot


MAX_OBJS = 12
MAX_PRED = 16
MAX_HULL = 16

# the planner state carried from one replan to the next (load_carry)
CARRY_KEYS = ("traj_np", "traj_ref_np", "dead_time_states", "i_prev",
              "i_min_prev", "t_decision", "reverse_counter",
              "enable_reverse", "_x_off_prev", "_y_off_prev", "v_ref",
              "last_update_time", "_shift_accum", "reset_counter")


class Params:

    def __init__(self):
        self.a_min = -2.5
        self.a_max = 2.5
        self.j_min = -1.5
        self.j_max = 1.5
        # replan cadence (the JAX package's replan_time, idm_sampling_
        # planner.py:45-49)
        self.replan_time = 0.05
        self.cpp = IdmSamplingParams()


def _prep_objects(predicted, local_map_uuid, linestrip):
    """Build padded object tensors (updatePredGeometry twin,
    idm_sampling.cpp:160-236)."""
    objs = dict(
        pred_t=np.zeros((MAX_OBJS, MAX_PRED), np.float32),
        pred_xy=np.zeros((MAX_OBJS, MAX_PRED, 2), np.float32),
        pred_heading=np.zeros((MAX_OBJS, MAX_PRED), np.float32),
        pred_v=np.zeros((MAX_OBJS, MAX_PRED), np.float32),
        pred_dists=np.zeros((MAX_OBJS, MAX_PRED), np.float32),
        hull_preds=np.zeros((MAX_OBJS, MAX_PRED, MAX_HULL, 2), np.float32),
        hull_projs=np.full((MAX_OBJS, MAX_PRED, 4), -1000.0, np.float32),
        radius_hull=np.zeros(MAX_OBJS, np.float32),
        valid=np.zeros(MAX_OBJS, bool),
        on_local_map=np.zeros(MAX_OBJS, bool),
    )

    oi = 0
    for obj in predicted:
        for pred in obj.predictions:
            if oi >= MAX_OBJS:
                break
            states = np.asarray(pred.states)  # (P, 5): t, x, y, yaw, v
            if len(states) < 2:
                continue
            on_local = pred.uuid_assoc_map == local_map_uuid

            # hull to object-local frame at prediction start
            pp0 = states[0]
            c, s = np.cos(-pp0[3]), np.sin(-pp0[3])
            R = np.array([[c, -s], [s, c]])
            hull_local = (np.asarray(obj.hull) - pp0[1:3]) @ R.T
            radius = float(np.max(np.linalg.norm(hull_local, axis=1))) \
                if len(hull_local) else 0.0

            P = min(len(states), MAX_PRED)
            st = states[:P]

            # hulls at each prediction point
            hp = np.zeros((P, len(hull_local), 2))
            for i in range(P):
                ci, si = np.cos(st[i, 3]), np.sin(st[i, 3])
                Ri = np.array([[ci, -si], [si, ci]])
                hp[i] = hull_local @ Ri.T + st[i, 1:3]

            # merge hull i with hull i+1 (swept), pad to MAX_HULL
            merged = np.zeros((P, MAX_HULL, 2), np.float32)
            for i in range(P):
                if i < P - 1:
                    h = convex_hull(np.vstack([hp[i], hp[i + 1]]))
                else:
                    h = convex_hull(hp[i]) if len(hp[i]) > 2 else hp[i]
                n = min(len(h), MAX_HULL)
                merged[i, :n] = h[:n]
                merged[i, n:] = h[min(n, len(h)) - 1]

            # hull projections to the ref linestrip
            projs = np.full((P, 4), -1000.0, np.float32)
            for i in range(P):
                ps = project(linestrip, merged[i])
                arc = np.array([p.arc_len for p in ps])
                dist = np.array([p.distance for p in ps])
                inb = np.array([p.in_bounds for p in ps])
                if np.any(inb):
                    projs[i] = [arc.min(), arc.max(),
                                dist[inb].min(), dist[inb].max()]

            dists = np.zeros(P)
            dists[1:] = np.cumsum(np.linalg.norm(
                np.diff(st[:, 1:3], axis=0), axis=1))

            objs["pred_t"][oi, :P] = st[:, 0]
            objs["pred_t"][oi, P:] = st[-1, 0] + np.arange(MAX_PRED - P) + 1
            objs["pred_xy"][oi, :P] = st[:, 1:3]
            objs["pred_xy"][oi, P:] = st[-1, 1:3]
            objs["pred_heading"][oi, :P] = st[:, 3]
            objs["pred_heading"][oi, P:] = st[-1, 3]
            objs["pred_v"][oi, :P] = st[:, 4]
            objs["pred_v"][oi, P:] = st[-1, 4]
            objs["pred_dists"][oi, :P] = dists
            objs["pred_dists"][oi, P:] = dists[-1] + np.arange(
                MAX_PRED - P) + 1
            objs["hull_preds"][oi, :P] = merged
            objs["hull_preds"][oi, P:] = merged[P - 1]
            objs["hull_projs"][oi, :P] = projs
            objs["hull_projs"][oi, P:] = projs[P - 1]
            objs["radius_hull"][oi] = radius
            objs["valid"][oi] = True
            objs["on_local_map"][oi] = on_local
            oi += 1

    return objs


def run_kernels(init_ref, init_con, l_trgs, d_stops, dt_replan, rl_dev,
                ref_step, objs_np, pp_vec, l_trg_global, T, dev):
    """One upload, the rollout and the evaluation on ``dev``, one download:
    returns (ref_states (C, T, 10), states (C, T, 9), costs (5, C)) as
    float32 numpy arrays."""
    C, NR = len(l_trgs), len(rl_dev)
    host = [np.asarray(init_ref, np.float32), np.asarray(init_con, np.float32),
            np.asarray(l_trgs, np.float32), np.asarray(d_stops, np.float32),
            np.float32([dt_replan, ref_step, l_trg_global]),
            np.asarray(pp_vec, np.float32), np.asarray(rl_dev, np.float32)]
    host += [np.asarray(objs_np[k], np.float32) for k in OBJ_KEYS]
    sizes = [a.size for a in host]
    buf = torch.from_numpy(np.concatenate([a.ravel() for a in host])).to(dev)
    views, at = [], 0
    for a, n in zip(host, sizes):
        views.append(buf[at:at + n].view(a.shape))
        at += n
    init_ref_t, init_con_t, l_t, d_t, scal, pp_t, rl_t = views[:7]
    objs = dict(zip(OBJ_KEYS, views[7:]))
    out = torch.empty(C * T * 19 + len(COST_KEYS) * C, dtype=torch.float32,
                      device=dev)
    refs = out[:C * T * 10].view(C, T, 10)
    cons = out[C * T * 10:C * T * 19].view(C, T, 9)
    costs = out[C * T * 19:].view(len(COST_KEYS), C)
    idm_kernel.rollout(init_ref_t, init_con_t, l_t, d_t, scal[0:1], rl_t,
                       scal[1:2], objs, pp_t, T, out=(refs, cons))
    idm_kernel.evaluate(refs, cons, l_t, objs, rl_t, scal[1:2], pp_t,
                        scal[2:3], out=costs)
    host_out = out.cpu().numpy()
    return (host_out[:C * T * 10].reshape(C, T, 10),
            host_out[C * T * 10:C * T * 19].reshape(C, T, 9),
            host_out[C * T * 19:].reshape(len(COST_KEYS), C))


class IdmSamplingPlanner(BasePlanner):

    def __init__(self, shared, lock_shared):
        self.shared = shared
        self.lock_shared = lock_shared

        self.reset_counter = 0
        # the rollout eval may pick an invalid-but-least-bad candidate
        # for many passes before the latch engages (tolerance 50)
        self.latch = EmergencyLatch(cycles=50, tolerance=50)
        self.reverse_counter = 0
        self.enable_reverse = False

        self.last_update_time = 0.0
        # wall milliseconds of the last replan pass
        self.runtime_planning = 0.0

        self.trajectory = Trajectory()
        self.traj_np = None            # selected (T, 9) states
        self.traj_ref_np = None
        self.dead_time_states = None   # (D, 9)

        self.i_prev = -1
        self.i_min_prev = 0
        self.t_decision = 0.0
        self._shift_accum = 0
        self._x_off_prev = 0.0
        self._y_off_prev = 0.0

        self.env = EnvironmentState()
        self.v_ref = None
        # the inputs of the last replan's kernel call (a dict), for checks
        self.last_inputs = None

        with self.lock_shared():
            self.shared.params = Params()
            self.shared.debug = Bundle()

    def reset(self):
        self.traj_np = None
        self.traj_ref_np = None
        self.dead_time_states = None
        self.i_prev = -1
        self.t_decision = 0.0
        self._shift_accum = 0

    def load_carry(self, other):
        """Take the replan-to-replan state of ``other`` (an IDM sampling
        planner of either package, or a dict of :data:`CARRY_KEYS` plus
        ``latch_counter`` / ``latch_invalid_streak``): arrays copied as
        float64 numpy, so that both planners continue from one state."""
        get = (other.get if isinstance(other, dict)
               else lambda k: getattr(other, k))
        for k in CARRY_KEYS:
            v = get(k)
            if isinstance(v, np.ndarray):
                v = np.array(v, np.float64)
            setattr(self, k, v)
        if isinstance(other, dict):
            self.latch.counter = other["latch_counter"]
            self.latch.invalid_streak = other["latch_invalid_streak"]
        else:
            self.latch.counter = other.latch.counter
            self.latch.invalid_streak = other.latch.invalid_streak

    def update_closest_inters_point(self, cmap, veh, params):
        d_close = 1.0e6
        for ip in cmap.intersection_paths:
            if not ip.stop_proj.in_bounds:
                continue
            if abs(ip.stop_proj.distance) > 1.0:
                continue
            d_close = min(d_close, ip.stop_proj.arc_len)
        params.cpp.d_next_inters_point = d_close

    def _lerp_state(self, states, t):
        ts = states[:, 0]
        i = int(np.clip(np.searchsorted(ts, t, side="right") - 1,
                        0, max(len(ts) - 2, 0)))
        j = min(i + 1, len(ts) - 1)
        a = np.clip((t - ts[i]) / max(ts[j] - ts[i], 1e-9), 0.0, 1.0)
        res = states[i] * (1 - a) + states[j] * a
        res[V_H] = states[i, V_H] + short_angle_dist(
            states[i, V_H], states[j, V_H]) * a
        if round(a * 1e4) == 0:
            res[V_A] = states[i, V_A]
            res[V_ST] = states[i, V_ST]
        else:
            res[V_A] = states[j, V_A]
            res[V_ST] = states[j, V_ST]
        return res

    def update(self, sh_env):
        env = self.env
        with sh_env.lock():
            if sh_env.local_map is None:
                return self.trajectory

            env.t = sh_env.t
            env.reset_counter = sh_env.reset_counter
            env.vehicle_state = snapshot(sh_env.vehicle_state)
            env.local_map = snapshot(sh_env.local_map)
            env.local_map_behind = snapshot(sh_env.local_map_behind)
            env.selected_map = snapshot(sh_env.selected_map)
            env.tracks = snapshot(sh_env.tracks)
            env.predicted = snapshot(sh_env.predicted)
            env.man_time_cons = snapshot(sh_env.man_time_cons)

            sh_env.local_map.update_inters_paths = True
            sh_env.local_map.step_shift_idx = 1
            sh_env.local_map.position_vehicle = \
                10.0 if self.enable_reverse else 1.0

        veh = env.vehicle_state

        params = Params()
        with self.lock_shared():
            sh_params = self.shared.params
            sh_params.cpp.dead_time = veh.dead_time_steer
            sh_params.cpp.wheel_base = veh.wheel_base
            sh_params.cpp.width_veh = veh.width
            sh_params.cpp.length_veh = (veh.rear_axis_to_rear
                                        + veh.rear_axis_to_front)
            sh_params.cpp.radius_veh = np.hypot(
                sh_params.cpp.width_veh * 0.5,
                sh_params.cpp.length_veh * 0.5)
            sh_params.cpp.dist_front_veh = veh.rear_axis_to_front
            sh_params.cpp.dist_back_veh = veh.rear_axis_to_rear
            util.merge_into(params, vars(sh_params))
            params.cpp = snapshot(sh_params.cpp)

        cmap = env.local_map
        if cmap is None:
            return self.trajectory

        dt_replan = env.t - self.last_update_time
        if dt_replan == 0.0:
            return self.trajectory

        reset_needed = (self.reset_counter != env.reset_counter
                        or dt_replan < 0.0 or not veh.automated)
        if reset_needed:
            self.reset_counter = env.reset_counter
            self.latch.clear()
            self.reset()
        elif dt_replan < params.replan_time and self.traj_np is not None:
            # between replans the stored closed-loop plan stays valid; the
            # local-map window keeps sliding each env tick, so accumulate
            # the per-tick shifts for the warm-start reseed
            self._shift_accum += cmap.shift_idx_start_ref
            return self.trajectory
        self.last_update_time = env.t
        dt_replan = max(0.0, dt_replan)
        replan_start = time.perf_counter()

        self.update_closest_inters_point(cmap, veh, params)

        # drivable velocity profile on the ref line
        if self.v_ref is None:
            self.v_ref = np.array([[veh.v, veh.a]])
        else:
            shift = self._shift_accum + cmap.shift_idx_start_ref
            idx = min(shift, len(self.v_ref) - 1)
            self.v_ref[0, :] = self.v_ref[idx]
        self._shift_accum = 0

        ref_line = cmap.path.copy()
        self.v_ref = rampify_profile(
            self.v_ref[0, 0], self.v_ref[0, 1], ref_line[:, 5],
            params.a_min, params.a_max, params.j_min, params.j_max,
            1.0, cmap.step_size_ref)
        self.v_ref[cmap.path[:, 5] < 0.1, :] = 0.0
        ref_line[:, 5] = self.v_ref[:, 0]
        ref_proj = util.project(ref_line[:, :2], [veh.x, veh.y])

        # device ref line: [x, y, heading, k, v_max, d_left, d_right],
        # offset-centered
        x_off = float(np.mean(ref_line[:, 0]))
        y_off = float(np.mean(ref_line[:, 1]))
        rl_dev = np.zeros((len(ref_line), 7), np.float32)
        rl_dev[:, 0] = ref_line[:, 0] - x_off
        rl_dev[:, 1] = ref_line[:, 1] - y_off
        rl_dev[:, 2] = ref_line[:, 2]
        rl_dev[:, 3] = ref_line[:, 4]
        rl_dev[:, 4] = ref_line[:, 5]
        rl_dev[:, 5] = cmap.d_left
        rl_dev[:, 6] = cmap.d_right
        linestrip = ref_line[:, :2] - np.array([x_off, y_off])

        # projections are translation invariant: prepare objects against
        # the raw linestrip, then shift coordinates to the centered frame
        objs_np = _prep_objects(env.predicted, env.local_map_behind.uuid,
                                ref_line[:, :2])
        objs_np["pred_xy"] = objs_np["pred_xy"] - np.array(
            [x_off, y_off], np.float32)
        objs_np["hull_preds"] = objs_np["hull_preds"] - np.array(
            [x_off, y_off], np.float32)

        cpp = params.cpp

        # lateral candidate offsets (idm_sampling.cpp:684-708)
        d_left = float(np.max(cmap.d_left)) - (
            cpp.d_safe_lat_path + cpp.width_veh / 2.0 * np.sqrt(2.0))
        d_right = float(np.min(-cmap.d_right)) + (
            cpp.d_safe_lat_path + cpp.width_veh / 2.0 * np.sqrt(2.0))
        ls = []
        for i in range(cpp.lat_steps - 1, -1, -1):
            ls.append(d_right / cpp.lat_steps * (i + 1))
        ls.append(0.0)
        for i in range(cpp.lat_steps):
            ls.append(d_left / cpp.lat_steps * (i + 1))

        l_trgs = np.array(ls + [0.0], np.float32)
        d_stops = np.full(len(l_trgs), 1.0e6, np.float32)
        d_stops[-1] = cpp.d_next_inters_point

        # initial states (reference planner: idm_sampling_planner.py:177-207)
        init_con = np.zeros(9)
        init_con[V_X] = veh.x - x_off
        init_con[V_Y] = veh.y - y_off
        init_con[V_H] = veh.phi
        init_con[V_ST] = veh.delta
        init_con[V_V] = veh.v
        init_con[V_A] = veh.a
        init_con[V_S] = ref_proj.arc_len
        init_con[V_L] = ref_proj.distance

        init_ref = np.zeros(10)
        if self.traj_ref_np is None:
            init_ref[R_X] = veh.x - x_off
            init_ref[R_Y] = veh.y - y_off
            init_ref[R_H] = veh.phi
            init_ref[R_V] = veh.v
            init_ref[R_A] = veh.a
            init_ref[R_S] = ref_proj.arc_len
            init_ref[R_L] = ref_proj.distance
        else:
            prev = self._lerp_ref(self.traj_ref_np,
                                  cpp.dead_time + dt_replan)
            init_ref[:] = prev
            init_ref[R_T] = cpp.dead_time
            raw_x = prev[R_X] + self._x_off_prev
            raw_y = prev[R_Y] + self._y_off_prev
            proj_init = util.project(ref_line[:, :2], (raw_x, raw_y))
            init_ref[R_X] = raw_x - x_off
            init_ref[R_Y] = raw_y - y_off
            init_ref[R_S] = proj_init.arc_len
            init_ref[R_L] = proj_init.distance

        # dead-time integration (idm_sampling.cpp:710-775)
        int_states = None
        init_con_roll = init_con
        if cpp.dead_time > 0.0:
            steps_dead = 11
            dtd = cpp.dead_time / (steps_dead - 1)
            if self.dead_time_states is not None:
                self.dead_time_states[:, V_T] -= dt_replan
                keep = self.dead_time_states[
                    self.dead_time_states[:, V_T] >= 0.0]
                self.dead_time_states = keep if len(keep) else None
            if self.dead_time_states is None:
                self.dead_time_states = np.zeros((steps_dead, 9))
                self.dead_time_states[:, V_T] = np.arange(steps_dead) * dtd
                self.dead_time_states[:, V_A] = init_con[V_A]
                self.dead_time_states[:, V_ST] = init_con[V_ST]

            int_states = np.stack([
                self._lerp_state(self.dead_time_states, dtd * i)
                for i in range(steps_dead)])
            a0, st0 = int_states[0, V_A], int_states[0, V_ST]
            int_states[0] = init_con
            int_states[0, V_A] = a0
            int_states[0, V_ST] = st0
            for i in range(steps_dead - 1):
                ps = int_states[i]
                ns = int_states[i + 1]
                ns[V_T] = ps[V_T] + dtd
                ns[V_V] = ps[V_V] + dtd * ps[V_A]
                ns[V_H] = ps[V_H] + dtd * ns[V_V] * np.tan(ps[V_ST]) \
                    / cpp.wheel_base
                ns[V_X] = ps[V_X] + dtd * ns[V_V] * np.cos(ns[V_H])
                ns[V_Y] = ps[V_Y] + dtd * ns[V_V] * np.sin(ns[V_H])
                proj = util.project(linestrip, (ns[V_X], ns[V_Y]))
                ns[V_S] = proj.arc_len
                ns[V_L] = proj.distance
            init_con_roll = int_states[-1]

        # device rollouts: one upload, two launches, one download
        self.last_inputs = dict(
            init_ref=np.float32(init_ref), init_con=np.float32(init_con_roll),
            l_trgs=l_trgs, d_stops=d_stops, dt_replan=np.float32(dt_replan),
            ref_line=rl_dev, ref_step=np.float32(cmap.step_size_ref),
            objs=objs_np, pp=cpp.packed(), l_trg_global=np.float32(cpp.l_trg),
            T=cpp.steps_t)
        refs, cons, costs_t = run_kernels(
            init_ref, init_con_roll, l_trgs, d_stops, dt_replan, rl_dev,
            cmap.step_size_ref, objs_np, cpp.packed(), cpp.l_trg,
            cpp.steps_t, tpl_tpu_torch.device())
        refs = refs.astype(np.float64)
        cons = cons.astype(np.float64)
        costs = idm_kernel.costs_dict(costs_t.astype(np.float64))

        i_select = self._select(costs, dt_replan, cpp)

        sel_states = cons[i_select]
        sel_refs = refs[i_select]

        # prepend dead-time integration states (idm_sampling.cpp:869-884)
        if int_states is not None and len(int_states) > 1:
            sel_states = np.vstack([int_states[:-1], sel_states])

        self.traj_np = sel_states
        self.traj_ref_np = sel_refs
        self._x_off_prev = x_off
        self._y_off_prev = y_off

        # append selection to the dead-time buffer
        if cpp.dead_time > 0.0:
            s = self._lerp_state(sel_states, cpp.dead_time)
            self.dead_time_states = np.vstack(
                [self.dead_time_states, s[None]])

        self.latch.note(not bool(costs["invalid"][i_select]))
        self.latch.decay()

        # reverse detection (idm_sampling_planner.py:208-217)
        if veh.v < 0.1:
            self.reverse_counter = min(100, self.reverse_counter + 1)
        if veh.v > 2.0:
            self.reverse_counter = 0
        self.enable_reverse = self.reverse_counter == 100

        emergency = self.latch.active
        if not emergency:
            tr = Trajectory()
            tr.time = env.t + sel_states[:, V_T]
            xs = sel_states[:, V_X] + x_off
            ys = sel_states[:, V_Y] + y_off
            tr.s = np.concatenate([[0.0], np.cumsum(np.hypot(
                np.diff(xs), np.diff(ys)))])
            tr.x = xs
            tr.y = ys
            tr.orientation = sel_states[:, V_H]
            tr.curvature = np.tan(sel_states[:, V_ST]) / veh.wheel_base
            tr.velocity = sel_states[:, V_V]
            tr.acceleration = sel_states[:, V_A]
            self.trajectory = tr
        else:
            self.trajectory = Trajectory()
            self.trajectory.emergency = True
            self.reset()

        self.runtime_planning = (time.perf_counter() - replan_start) * 1e3

        with self.lock_shared():
            dbg = Bundle()
            dbg.runtime_planning = self.runtime_planning
            dbg.costs = {k: v.tolist() for k, v in costs.items()}
            dbg.i_select = i_select
            dbg.l_trgs = l_trgs.tolist()
            # subsampled candidate rollout fan in world coordinates
            dbg.cand_xy = cons[:, ::5, [V_X, V_Y]] + [x_off, y_off]
            dbg.cand_invalid = costs["invalid"].astype(bool)
            self.shared.debug = dbg

        return self.trajectory

    def _lerp_ref(self, refs, t):
        ts = refs[:, R_T]
        i = int(np.clip(np.searchsorted(ts, t, side="right") - 1,
                        0, max(len(ts) - 2, 0)))
        j = min(i + 1, len(ts) - 1)
        a = np.clip((t - ts[i]) / max(ts[j] - ts[i], 1e-9), 0.0, 1.0)
        res = refs[i] * (1 - a) + refs[j] * a
        res[R_H] = refs[i, R_H] + short_angle_dist(
            refs[i, R_H], refs[j, R_H]) * a
        return res

    def _select(self, costs, dt_replan, cpp):
        """Hierarchical candidate selection with decision hysteresis.
        (idm_sampling.cpp:802-860)"""
        cc = costs["cost_collision"]
        ci = costs["cost_interaction"]
        cd = costs["cost_distance"]
        c = costs["cost"]

        cc_min = np.min(cc)
        mask1 = cc <= cc_min
        ci_min = np.min(np.where(mask1, ci, np.inf))
        mask2 = mask1 & (ci <= ci_min)
        cd_min = np.min(np.where(mask2, cd, np.inf))
        mask3 = mask2 & (np.abs(cd - cd_min) <= 5.0)
        c_m = np.where(mask3, c, np.inf)
        i_min = int(np.argmin(c_m))

        i_select = self.i_prev
        if i_select < 0 or i_select >= len(cc):
            i_select = i_min
        if costs["invalid"][i_select]:
            i_select = i_min
        if i_min != i_select:
            if self.i_min_prev == i_min:
                self.t_decision += dt_replan
                if self.t_decision > cpp.dt_decision:
                    i_select = i_min
                    self.t_decision = 0.0
            else:
                self.t_decision = 0.0
            self.i_min_prev = i_min

        self.i_prev = i_select
        return i_select
