"""
RSTP lateral stage: corridor-constrained lateral-profile optimization.

The corridor is assembled in packed per-step arrays: map bounds, a
fixed already-traversed head, then one batched hull projection per
predicted object decides the evade side and carves the corridor slice
in a single masked assignment. Smoothed evasion ramps come from the
slope-limited corridor rampify (the C route of
:mod:`tpl_tpu_torch.native`), and the profile solves on the
shared iLQR core: on a CUDA device one launch of the ``ilqr_rstp`` kernel
(float32), through :class:`~tpl_tpu_torch.optim.solver.Solver`.

The port of ``tpl_tpu/planning/path_vel_decomp/path_optim.py``; the
solver runs on ``tpl_tpu_torch.device()`` instead of being pinned to the
host CPU.

Behavioral parity target:
library/tpl/planning/path_vel_decomp/path_optim.py:11-307.
"""

import numpy as np

from tpl_tpu_torch import native, util
from tpl_tpu_torch.util import runtime
from tpl_tpu_torch.optim import problems
from tpl_tpu_torch.optim.solver import Solver
from tpl_tpu_torch.planning.path_vel_decomp.warm_start import ResetGate


def rampify_corridor(step, horizon, evasion_sharpness, proj_distance, path,
                     gap, lower, upper):
    """Smooth evasive lower-bound profile via two slope-limited passes.

    (reference: path_optim.py:11-55; forward pass then backward pass,
    slope limited by the opposite corridor bound minus the lateral gap)
    """
    if native.enabled():
        return native.rampify_corridor(step, horizon, evasion_sharpness,
                                       proj_distance, path, gap, lower, upper)

    # the oracle: the same two passes in numpy
    n = len(path)
    profiles = []
    for backward in (False, True):
        prof = np.zeros(n) - 10
        order = range(horizon - 1, -1, -1) if backward else range(horizon)
        d = lower[horizon - 1] if backward else lower[0]
        for i in order:
            d = max(lower[i], d)
            prof[i] = d
            span = (np.arange(i, -1, -1) if backward
                    else np.arange(i, horizon))
            slope = -(evasion_sharpness / max(path[i, 5], 1e-8) ** 2)
            if len(span):
                headroom = (upper[span] - gap - d) / (
                    np.maximum(1, np.abs(span - i)) * step)
                slope = min(slope, float(headroom.min()))
            if backward:
                slope = min(slope, (proj_distance - d) / max(1, i * step))
            d += step * slope
        profiles.append(prof)
    return np.maximum(*profiles)


class CostFunctionParams:

    def __init__(self):
        self.w_d = 0.5
        self.w_v_d = 0.5
        self.w_a_d = 0.5
        self.w_k = 0.5


class Params:

    def __init__(self):
        self.horizon = 250
        self.step = 0.5
        self.ref_step = 0.5

        self.min_d_dd = -2.5
        self.max_d_dd = 2.5
        self.max_lat_acc = 2.5

        self.lateral_min_gap = 2.0
        self.offset_center_line = 0.0

        # keep already-traversed path fixed for this many seconds
        self.fix_seconds = 3.0

        self.evasion_lon_d_safe = 4
        self.evasion_lat_d_safe = 2.0
        self.evasion_lat_d_comf = 2.0
        self.evasion_sharpness = 20.0

        # Oncoming-traffic handling beyond the reference (which collides
        # in its own overtake-against-oncoming stress scenarios, see
        # PARITY.md): a larger lateral margin against oncoming hulls, and
        # a meeting-point estimate from the ego's MEASURED speed instead
        # of the map speed profile (path_optim.py:193-196 uses
        # path[0, 5]; when the ego drives slower than the map profile —
        # exactly what happens while yielding — that misplaces the carve
        # window beyond the true meeting zone and uncovers the near
        # field, letting the path nose into the oncoming corridor).
        self.evasion_lat_d_safe_oncoming = 2.5
        self.oncoming_v_scale_ego = True

        self.cost_func = CostFunctionParams()


class _Corridor:
    """Packed per-step corridor state during one prepare() pass."""

    def __init__(self, local_map, n, half_width):
        self.lower = -local_map.d_right[:n] + half_width
        self.upper = -local_map.d_left[:n] + half_width

    @property
    def mid(self):
        return self.lower + (-self.upper - self.lower) / 2.0

    def pin_head(self, fix, prev_lower, prev_upper, si):
        """Freeze the already-traversed head to last tick's bounds."""
        self.upper[:fix] = -prev_upper[si:si + fix]
        self.lower[:fix] = prev_lower[si:si + fix]

    def carve(self, lo, hi, side, reach):
        """Push one bound toward ``reach`` over the [lo, hi) window,
        never crossing the opposite bound."""
        if side == "left":
            mine, theirs = self.lower, self.upper
        else:
            mine, theirs = self.upper, self.lower
        win = slice(lo, hi)
        mine[win] = np.minimum(-theirs[win], np.maximum(mine[win], reach))


class PathOptim:

    def __init__(self, horizon_max=250):
        prob, spec = problems.lateral_profile(ref_capacity=512)
        self.opt = Solver(prob, spec, horizon_max=horizon_max)
        self.opt.lg_mult_limit = 0.0
        self.opt.barrier_weight[:] = 1000.0

        self.gate = ResetGate(watch_time=True)
        self.opt_path = np.zeros((1, 6))
        self.d_lower_constr = np.zeros((0, 1))
        self.d_upper_constr = np.zeros((0, 1))

    @property
    def reset_required(self):
        return self.gate.pending

    @reset_required.setter
    def reset_required(self, flag):
        self.gate.pending = bool(flag)

    # ------------------------------------------------------------------
    # corridor construction

    def _carve_object(self, corr, mid, obj, pred, path, local_map, params,
                      veh, l_veh, first_stop, step):
        """Decide the evade side for one predicted object and carve the
        corridor. One batched hull projection feeds every decision."""
        hull = util.project_many(path[:, :2], obj.hull)
        front = hull["arc_len"].argmin()
        back = hull["arc_len"].argmax()
        if hull["index"][front] > first_stop:
            return

        oncoming = pred.cos_angle_dist < 0.0

        # meeting-zone scale: the carve window stretches by the closing
        # speed ratio so it lands where ego and object actually meet
        v_ego = path[0, 5]
        if oncoming and params.oncoming_v_scale_ego:
            v_ego = min(v_ego, max(veh.v, 0.5))
        v_close = v_ego - obj.v * pred.cos_angle_dist
        zone = v_ego / max(0.001, abs(v_close))
        if v_close < 0.0:
            zone = -zone

        pad = params.evasion_lon_d_safe + l_veh / 2
        lo = int((hull["arc_len"][front] - pad) * zone / step)
        hi = int((hull["arc_len"][back] + pad) * zone / step)
        n = path.shape[0]
        lo, hi = max(0, min(n, lo)), max(0, min(n, hi))

        # hull vertices that are actually on the road decide the side
        idx = hull["index"]
        on_road = (hull["in_bounds"]
                   & (-local_map.d_right[idx] <= hull["distance"])
                   & (hull["distance"] <= local_map.d_left[idx]))
        if not on_road.any():
            return
        d_on = hull["distance"][on_road]
        mid_on = mid[hull["start"][on_road]]

        side = obj.evade if obj.evade in ("left", "right") else None
        if side is None and (obj.v < path[0, 5] * 0.75 or oncoming):
            # unforced evasion only when the object sits fully on one
            # side of the corridor center
            if (d_on < mid_on).all():
                side = "left"
            if (d_on > mid_on).all():
                side = "right"
        if side is None:
            return

        margin = params.evasion_lat_d_safe
        if oncoming:
            margin = max(margin, params.evasion_lat_d_safe_oncoming)

        # signed-extreme formulation: for either side the bound is pushed
        # to (most intruding hull vertex) + margin, measured toward the
        # evasion direction
        sign = 1.0 if side == "left" else -1.0
        reach = (sign * d_on).max() + margin + veh.width / 2.0
        corr.carve(lo, hi, side, reach)

    def prepare(self, env, params):
        """Corridor construction shared by the host and fused pipelines.

        Computes everything up to (but excluding) the solver-state
        mutations: window, corridor bounds, evade decisions, rampified
        reference profiles and warm-start intents.  Writes the final
        reference arrays into ``opt.params`` (the next tick's fix-region
        copy reads them back) and returns the solve inputs.
        (reference: path_optim.py:119-299)
        """
        local_map = env.local_map
        n = min(params.horizon, local_map.steps_ref)
        path = local_map.path[:n].copy()
        veh = env.vehicle_state
        proj_veh = util.project(path[:, :2], np.array([veh.x, veh.y]))
        l_veh = veh.rear_axis_to_front + veh.rear_axis_to_rear

        opt = self.opt
        opt.horizon = n
        opt.step = params.step
        opt.params.ref_step = local_map.step_size_ref
        opt.params.merge(vars(params.cost_func))

        corr = _Corridor(local_map, n, veh.width / 2.0)

        # warm start vs. cold start; freeze the traversed head
        si = local_map.shift_idx_start_ref
        hold = l_veh + veh.v * params.fix_seconds
        fix = int(np.ceil(hold / local_map.step_size_ref))
        reset = self.gate.fire(env, shift=si, n=n)
        if not reset:
            corr.pin_head(fix, opt.params.d_lower_constr,
                          opt.params.d_upper_constr, si)

        # dynamic objects: carve per object, batched per hull
        relevant = []
        for obj in env.predicted:
            preds = [p for p in obj.predictions
                     if p.uuid_assoc_map == env.local_map_behind.uuid]
            if preds:
                relevant.append((obj, preds[0]))

        first_stop = int(np.argmax(path[:, 5] < 0.1))
        if first_stop == 0 and path[0, 5] > 0.1:
            first_stop = 1000
        # the side decision measures against the pre-carve midline
        mid = corr.mid
        for obj, pred in relevant:
            self._carve_object(corr, mid, obj, pred, path, local_map,
                               params, veh, l_veh, first_stop, opt.step)

        self.d_lower_constr = corr.lower
        self.d_upper_constr = corr.upper

        # smoothed evasive reference profiles (path_optim.py:259-288)
        d_lower_ref = rampify_corridor(
            opt.step, opt.horizon, params.evasion_sharpness,
            proj_veh.distance, path, params.lateral_min_gap,
            corr.lower, -corr.upper)
        d_upper_ref = -rampify_corridor(
            opt.step, opt.horizon, params.evasion_sharpness,
            -proj_veh.distance, path, params.lateral_min_gap,
            corr.upper, -corr.lower)

        # target offset: comfortable distance above the lower ramp,
        # snapping to the centerline wherever it is free
        d_trg = d_lower_ref + np.minimum(
            (d_upper_ref - d_lower_ref) / 2, params.evasion_lat_d_comf)
        center = params.offset_center_line
        d_trg[(d_lower_ref < center) & (d_upper_ref > center)] = center

        # final reference arrays; the next tick's fix-region copy reads
        # these back from opt.params
        opt.params.merge(dict(
            k_ref=path[:, 4], d_lower_constr=d_lower_ref,
            d_upper_constr=d_upper_ref, d_offset=d_trg))

        return dict(
            path=path, path_len=n, proj_veh=proj_veh,
            d_lower_ref=d_lower_ref, d_upper_ref=d_upper_ref, d_trg=d_trg,
            si=si, fix=fix, reset=reset,
            x0=np.array([proj_veh.distance, 0.0]))

    # ------------------------------------------------------------------

    @runtime
    def update(self, env, params):
        prep = self.prepare(env, params)

        opt = self.opt
        opt.u_min[:] = -params.max_d_dd
        opt.u_max[:] = params.max_d_dd

        if prep["reset"]:
            opt.x[0, :] = prep["x0"]
            opt.u[:] = 0.0
        else:
            opt.shift(prep["si"])
            # zero-width control bounds pin the traversed head
            opt.u_max[:prep["fix"]] = 0.0
            opt.u_min[:prep["fix"]] = 0.0

        opt.integrator_type = opt.EULER
        opt.update()

        # bend the window path by the lateral profile, then re-grid
        path = prep["path"]
        d, dd = opt.x[:-1, 0], opt.x[:-1, 1]
        path[:, 0] -= np.sin(path[:, 2]) * d
        path[:, 1] += np.cos(path[:, 2]) * d
        path[:, 2] += np.arctan(dd)
        self.opt_path = util.resample_path(path, opt.step, opt.horizon)
