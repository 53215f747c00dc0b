"""
RSTP velocity stage: solve the space-domain velocity/time profile along
the optimized path under map limits, a leader vehicle, and maneuver
velocity/time windows.

Structure: leader selection and time windows run as batched projections
(one `project_many` per constraint set); warm starts are re-indexed by
traveled arc length through the shared ArcShift; the reference profile
is a jerk/acc-limited rampify of the stacked speed limits.  The solve
runs on ``tpl_tpu_torch.device()`` (one ``ilqr_rstp`` launch on a CUDA
device), not pinned to the host CPU as in the JAX package.

Behavioral parity target:
library/tpl/planning/path_vel_decomp/velocity_optim.py:86-300.
"""

import numpy as np

from tpl_tpu_torch import util
from tpl_tpu_torch.util import runtime
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.optim.solver import Solver
from tpl_tpu_torch.ops import (add_vel_constraint, rampify_profile,
                               zero_after_first_zero)
from tpl_tpu_torch.planning.path_vel_decomp.warm_start import (
    ResetGate, ArcShift)

FAR_AWAY = 1e6


class CostFunctionParams:

    def __init__(self):
        self.p_v = 0.1
        self.p_a = 1.0


class Params:

    def __init__(self):
        self.horizon = 250
        self.step = 0.5
        self.ref_step = 0.5

        self.a_min = -2.5
        self.a_max = 2.5
        self.j_min = -1.5
        self.j_max = 1.5
        self.max_a_total = 5.0
        self.max_lat_acc = 1.5
        self.max_traffic_light_stop_acc = 2.0

        self.d_lat_leader_safe = 1.0

        self.dt_safe = 1.5
        self.min_d_safe = 1.0
        self.min_v_profile = 1.0

        self.time_constr_alpha = 10.0
        self.time_constr_beta = 0.005

        self.cost_func = CostFunctionParams()


def select_leader(path, tracks, veh, d_lat_assoc):
    """Closest in-corridor object ahead of the ego along ``path``.

    Each track's hull is projected in one batched call; a track
    qualifies when its hull stays in bounds and reaches laterally into
    the association corridor. Returns (s_leader, v_leader) with the
    reference's quirk that the gap is ego-relative only for moving
    leaders (velocity_optim.py:106-139).
    """
    s_leader, v_leader = FAR_AWAY, 0.0
    ego_s = util.project(path[:, :2], (veh.x, veh.y)).arc_len

    for o in tracks:
        center = util.project(path[:, :2], o.pos)
        if abs(center.distance) - o.hull_radius >= d_lat_assoc:
            continue

        hull = util.project_many(path[:, :2], o.hull)
        if not hull["in_bounds"].all():
            continue
        d = hull["distance"]
        one_sided = (d >= 0.0).all() or (d < 0.0).all()
        if one_sided and np.abs(d).min() > d_lat_assoc:
            continue

        s_front = hull["arc_len"].min()
        if s_front >= s_leader:
            continue
        s_leader = s_front
        v_leader = max(0.0, o.v * np.cos(center.angle - o.yaw))
        if v_leader > 0.5:
            s_leader -= ego_s

    return s_leader, v_leader


class VelocityOptim:

    def __init__(self, horizon_max=250):
        prob, spec = problems.velocity_profile_space(ref_capacity=512)
        self.opt = Solver(prob, spec, horizon_max=horizon_max)
        self.opt.max_iterations = 20
        self.opt.lg_mult_limit = 0.1
        self.opt.barrier_weight[:] = 1000.0

        self.gate = ResetGate()
        self.shifter = ArcShift()

        # published profile channels (read by the planner/GUI)
        self.v_lim = np.zeros(1)
        self.v_ref = np.zeros((1, 2))
        self.v_opt = np.zeros(1)
        self.stop_mask = np.zeros(1)
        self.s_leader = FAR_AWAY
        self.v_leader = 0.0

    # ------------------------------------------------------------------

    def _speed_limits(self, path, env, params, step):
        """Stack map profile, leader gap, and maneuver windows into one
        per-step speed-limit array."""
        lim_v = path[:, 5].copy()

        # leader: ramp the limit down toward the safety gap
        standoff = (env.vehicle_state.rear_axis_to_front
                    + params.min_d_safe)
        gap_safe = self.v_leader * params.dt_safe + standoff
        closing = min(4.0, self.v_leader / max(0.01, env.vehicle_state.v))
        taper = self.s_leader / gap_safe * closing
        add_vel_constraint(
            lim_v, int((self.s_leader - gap_safe) / step),
            self.v_leader * taper, length=20)

        # maneuver velocity windows between two anchor points
        for pos1, pos2, v_cons in env.man_vel_cons:
            a = util.project(path[:, :2], pos1).index
            b = util.project(path[:, :2], pos2).index
            add_vel_constraint(lim_v, a, v_cons, b - a, 0)

        return lim_v

    def _reference_profile(self, lim_v, params, step, horizon, cold):
        """Jerk/acc-limited drivable profile under the stacked limits,
        seeded from the previous tick's shifted profile head."""
        if self.v_ref.shape[0] != horizon:
            head = self.v_ref[0]
            self.v_ref = np.zeros((horizon, 2))
            self.v_ref[0] = head
        if cold:
            self.v_ref[0] = (lim_v[0], 0.0)
        else:
            self.v_ref = self.shifter.resample(self.v_ref)
        self.v_ref = rampify_profile(
            self.v_ref[0, 0], self.v_ref[0, 1], lim_v,
            params.a_min, params.a_max, params.j_min, params.j_max,
            params.min_v_profile, step)

    def _time_windows(self, path, env, params, t, horizon, step):
        """Maneuver time constraints → per-step (t_min, t_max) arrays
        plus the v-weight shaping that releases tracking before a
        timed waypoint. One batched projection covers all anchors."""
        t_max = np.full(horizon, 1e11)
        t_min = np.zeros(horizon)
        t_off = np.ones(horizon)
        v_weight = np.ones(horizon)

        ego = util.project(path[:, :2], np.array(
            [env.vehicle_state.x, env.vehicle_state.y]))
        t_ego = ((1.0 - ego.alpha) * self.opt.x[ego.start, 1]
                 + ego.alpha * self.opt.x[ego.end, 1])
        clock_origin = t - t_ego

        cons = list(env.man_time_cons)
        if not cons:
            return t_min, t_max, t_off, v_weight

        anchors = np.array([pos for pos, _, _ in cons])
        pr = util.project_many(path[:, :2], anchors)
        grid = step * np.arange(horizon)

        for k, (_, c_min, c_max) in enumerate(cons):
            idx = pr["index"][k]
            if idx >= horizon - 1:
                continue
            if t <= c_min:
                t_min[idx] = max(0.0, c_min - clock_origin)
                t_off[idx] = (c_min - clock_origin) - self.opt.x[idx, 1]
                anchor_s = pr["arc_len"][k] - params.time_constr_alpha
                v_weight = np.minimum(
                    v_weight,
                    ((grid - anchor_s) * params.time_constr_beta) ** 2)
            if t <= c_max:
                t_max[idx] = max(0.0, c_max - clock_origin)

        return t_min, t_max, t_off, v_weight

    # ------------------------------------------------------------------

    @runtime
    def update(self, path, env, params):
        veh = env.vehicle_state
        params.horizon = min(len(path), params.horizon)
        horizon, step = params.horizon, params.step
        cold = self.gate.fire(env)

        opt = self.opt
        opt.integrator_type = opt.EULER
        opt.horizon = horizon
        opt.step = step
        opt.u_min[:] = params.a_min
        opt.u_max[:] = params.a_max
        opt.params.merge(dict(
            ref_step=params.ref_step, max_a_total=params.max_a_total,
            **vars(params.cost_func)))

        # warm-start re-indexing by traveled arc length
        self.shifter.advance(path, step, horizon, util.project)
        opt.x[:-1] = self.shifter.resample(opt.x[:-1, :])
        opt.x[:, 1] -= opt.x[0, 1]    # time channel restarts at 0
        opt.u = self.shifter.resample(opt.u, hold=True)
        opt.lagrange_multiplier = self.shifter.resample(
            opt.lagrange_multiplier)

        self.s_leader, self.v_leader = select_leader(
            path, env.get_all_tracks(), veh,
            veh.width / 2.0 + params.d_lat_leader_safe)

        lim_v = self._speed_limits(path, env, params, step)
        self._reference_profile(lim_v, params, step, horizon, cold)

        if cold:
            opt.x[0, :2] = (veh.v, veh.a)

        t_min, t_max, t_off, v_weight = self._time_windows(
            path, env, params, env.t, horizon, step)

        opt.params.merge(dict(
            ref_v=self.v_ref[:, 0], ref_k=path[:, 4],
            ref_t_min=t_min, ref_t_max=t_max,
            ref_t_offset=t_off, ref_v_weight=v_weight))

        opt.update()

        # zero the profile tail after the first commanded stop
        alive = ((lim_v >= params.min_v_profile)
                 * ((t_min - opt.x[:-1, 1] <= 0.0)
                    | (opt.x[:-1, 0] > params.min_v_profile * 1.1)))
        self.stop_mask = zero_after_first_zero(alive.astype(float))
        self.v_lim = lim_v
        self.v_opt = opt.x[:-1, 0] * self.stop_mask
