"""
IDM sampling rollout planner kernel: closed-loop forward simulation of
lateral-offset candidates with Stanley lateral control and IDM longitudinal
control, evaluated for collisions, interactions and comfort.
(reference: library/src/idm_sampling.cpp; the JAX package's form is
tpl_tpu/planning/idm_sampling/idm_kernel.py)

Two device entries live here, each a hand-written kernel on a CUDA tensor
and a plain PyTorch version on a CPU tensor:

- the closed-loop rollout of every candidate (:func:`rollout`; kernel
  ``idm_rollout`` of ``csrc/idm_rollout.cu``, one warp per candidate, two
  where the candidates are at most 512; plain :func:`rollout_reference`,
  the JAX package's ``rollout_lanes``);
- the screens and costs of every candidate (:func:`evaluate`; kernel
  ``idm_evaluate`` of ``csrc/idm_evaluate.cu``, persistent blocks walking
  batches of candidates, a thread per (candidate, step); plain
  :func:`evaluate_reference`, the JAX package's ``evaluate_lanes``).

Everything is float32, as the JAX program casts it, except the road-edge
margin of the evaluation, which the JAX package computes in float64 (a
NumPy float64 scalar under x64).  The plain versions keep the JAX lanes
form's operations and their order; where the JAX form contracts a one-hot
or two-hot weight vector with a table, they gather the one or two rows
(the same value, but for the rounding of XLA's contracted sums; a two-hot
whose two indices coincide weighs the row by ``(1 - a) + a``, as the
contraction does).  Running sums (the ref line's arc lengths, the costs)
are taken in float64 and rounded once (arc lengths) or in index order in
float32 (costs), the kernels' order.

The objects are a dict of float32 tensors (:data:`OBJ_KEYS`, the masks
``valid`` / ``on_local_map`` as 0.0 / 1.0), the parameters one float32
vector (:data:`PP_KEYS`, in the order of ``csrc/idm_common.cuh``, which the
first launch checks).  ``rollout_launches`` / ``evaluate_launches`` count
each entry's kernel launches.
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.planning.dyn_prog.latlon_action_min import div_const
from tpl_tpu_torch.planning.dyn_prog.lon_kernel import _check, fma32

rollout_launches = 0    # kernel launches since import (reset freely)
evaluate_launches = 0


class IdmSamplingParams:
    """(reference: idm_sampling.hpp:4-55)"""

    def __init__(self):
        self.steps_t = 100
        self.dt = 0.1

        self.dead_time = 0.0

        self.lat_steps = 2
        self.d_safe_lat = 0.25
        self.d_safe_lat_path = 0.5
        self.d_comf_lat = 1.0

        self.k_stanley = 1.0
        self.v_offset_stanley = 1.0

        self.steer_angle_max = 0.7
        self.steer_rate_max = 0.6

        self.t_vel_lookahead = 2.0
        self.d_safe_min = 1.0
        self.t_headway_desired = 1.0
        self.a_break_comf = 1.5

        self.idm_exp_dcc = 4.0
        self.idm_exp_acc = 4.0

        self.k_p_s = 1.0
        self.k_p_v = 1.0

        self.a_max = 2.0
        self.a_min = -3.0
        self.j_max = 1.5
        self.j_min = -1.5

        self.d_next_inters_point = 1.0e6

        self.width_veh = 0.0
        self.length_veh = 0.0
        self.radius_veh = 0.0
        self.dist_front_veh = 0.0
        self.dist_back_veh = 0.0
        self.wheel_base = 4.0

        self.l_trg = 0.0
        self.w_l = 1.0
        self.w_a = 1.0
        self.w_lat_dist = 1.0

        self.dt_decision = 0.2

        self.enable_reverse = False

    def dynamic_dict(self):
        return {k: np.float32(getattr(self, k)) for k in PP_KEYS}

    def packed(self):
        """The dynamic parameters as ONE float32 vector (:data:`PP_KEYS`)."""
        return np.array(list(self.dynamic_dict().values()), np.float32)


PP_KEYS = ("dt", "dead_time", "d_safe_lat", "d_safe_lat_path",
           "d_comf_lat", "k_stanley", "v_offset_stanley",
           "steer_angle_max", "steer_rate_max", "t_vel_lookahead",
           "d_safe_min", "t_headway_desired", "a_break_comf",
           "idm_exp_dcc", "idm_exp_acc", "k_p_s", "k_p_v", "a_max",
           "a_min", "j_max", "j_min", "width_veh", "length_veh",
           "radius_veh", "dist_front_veh", "dist_back_veh",
           "wheel_base", "l_trg", "w_l", "w_a", "w_lat_dist")

# the object tensors, (O, P), (O, P, 2), (O, P), (O, P), (O, P),
# (O, P, K, 2), (O, P, 4), (O,), (O,), (O,)
OBJ_KEYS = ("pred_t", "pred_xy", "pred_heading", "pred_v", "pred_dists",
            "hull_preds", "hull_projs", "radius_hull", "valid",
            "on_local_map")

# the rows of :func:`evaluate`'s result
COST_KEYS = ("cost", "cost_distance", "cost_interaction", "cost_collision",
             "invalid")

# ref state fields: t, x, y, heading, v, a, s, l, d_right, d_left
R_T, R_X, R_Y, R_H, R_V, R_A, R_S, R_L, R_DR, R_DL = range(10)
# vehicle state fields: t, x, y, heading, steer, v, a, s, l
V_T, V_X, V_Y, V_H, V_ST, V_V, V_A, V_S, V_L = range(9)

TWO_PI = float(np.float32(2 * np.pi))
# the kernels' limits (csrc/idm_rollout.cu, csrc/idm_evaluate.cu)
MAX_OBJS = MAX_PRED = MAX_HULL = 16


def objs_to_torch(objs, dev):
    """The object dict (numpy, the JAX package's dtypes: masks bool) as
    float32 tensors on ``dev``, masks 0.0 / 1.0."""
    return {k: torch.as_tensor(np.asarray(objs[k], np.float32), device=dev)
            for k in OBJ_KEYS}


def costs_dict(costs):
    """The (5, C) result of :func:`evaluate` as the JAX package's dict of
    (C,) numpy arrays (``invalid`` bool)."""
    c = costs.cpu().numpy() if isinstance(costs, torch.Tensor) else costs
    out = {k: c[i] for i, k in enumerate(COST_KEYS)}
    out["invalid"] = out["invalid"] != 0.0
    return out


# ---------------------------------------------------------------------
# the interpolation helpers (one object; the JAX package's forms)

def _bracket_by_t(ts, t):
    """Index and weight of the segment containing t on a sorted (P,) time
    grid (or on (..., P) grids, t of shape (...,))."""
    n = ts.shape[-1]
    t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
    i = torch.clamp(torch.sum((ts <= t[..., None]).to(torch.int64), dim=-1)
                    - 1, 0, n - 2)
    t0 = torch.gather(ts, -1, i[..., None])[..., 0]
    t1 = torch.gather(ts, -1, (i + 1)[..., None])[..., 0]
    a = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    return i, a


def _two_hot(n, i, a, dtype):
    """Weight vector with (1-a) at i and a at i+1."""
    ar = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=dtype, device=a.device)
    return (torch.where(ar == i, 1.0 - a, zero)
            + torch.where(ar == i + 1, a, zero)).to(dtype)


def _interp_by_t(ts, values, t):
    """Linear interp of (P, ...) values by times ts (P,): the two rows of
    the bracket, weighted."""
    i, a = _bracket_by_t(ts, t)
    a = a.reshape(a.shape + (1,) * (values.dim() - 1))
    return values[i] * (1.0 - a) + values[i + 1] * a


def _interp_hulls_by_t(ts, hulls, t):
    """Linear interp of (P, K, 2) hull sweeps by times ts (P,)."""
    return _interp_by_t(ts, hulls, t)


def _short_angle(a0, a1):
    """The JAX package's ``_short_angle``: jnp.mod by float32(2 pi), twice
    (torch.remainder is jnp.mod's floored modulo: fmod, plus the divisor
    where the remainder is negative)."""
    da = torch.remainder(a1 - a0, TWO_PI)
    return torch.remainder(2 * da, TWO_PI) - da


def _obj_at(objs, t):
    """The objects' hulls (S, O, K, 2), positions (S, O, 2), headings and
    speeds (S, O) and hull projections (S, O, 4) at the times t (S,)."""
    pt = objs["pred_t"]                                     # (O, P)
    S, O = t.shape[0], pt.shape[0]
    i, a = _bracket_by_t(pt[None].expand(S, -1, -1), t[:, None].expand(S, O))
    orow = torch.arange(O, device=t.device)[None].expand(S, O)

    def at(name):
        tab = objs[name]                                    # (O, P, ...)
        w = a.reshape(a.shape + (1,) * (tab.dim() - 2))
        return tab[orow, i] * (1.0 - w) + tab[orow, i + 1] * w

    return (at("hull_preds"), at("pred_xy"), at("pred_heading"),
            at("pred_v"), at("hull_projs"))


def step_times(t0, dt, n):
    """The n step times t0, t0 + dt, ... as the float32 running sum the
    rollout's carry performs (not t0 + i * dt)."""
    ts = []
    c = t0
    for _ in range(n):
        ts.append(c)
        c = c + dt
    return torch.stack(ts)


def _ref_lerp_2hot(ref_line, ref_step, s, ch):
    """Ref-line channel ``ch`` at stations s (the JAX package's two-hot
    lerp: where floor and ceil coincide, the row weighs (1 - a) + a)."""
    NR = ref_line.shape[0]
    q = s / ref_step
    i0 = torch.clamp(torch.floor(q), 0.0, NR - 1.0)
    i1 = torch.clamp(torch.ceil(q), 0.0, NR - 1.0)
    a = torch.clamp(q - i0, 0.0, 1.0)
    tab = ref_line[:, ch]
    t0, t1 = tab[i0.long()], tab[i1.long()]
    return torch.where(i0 == i1, t0 * ((1.0 - a) + a),
                       t0 * (1.0 - a) + t1 * a)


def _ref_ch_lerp(ref_line, ref_step, s, ch):
    """Ref-line channel ``ch`` at stations s, gather form."""
    NR = ref_line.shape[0]
    q = s / ref_step
    i0 = torch.clamp(torch.floor(q), 0, NR - 1)
    i1 = torch.clamp(torch.ceil(q), 0, NR - 1)
    a = torch.clamp(q - i0, 0.0, 1.0)
    tab = ref_line[:, ch]
    return tab[i0.long()] * (1.0 - a) + tab[i1.long()] * a


def _cumsum_f64(x, dim=-1):
    """The float32 running sum of ``x`` as the kernels take it: in
    float64, each partial sum rounded to float32."""
    return torch.cumsum(x.to(torch.float64), dim).to(torch.float32)


def _seg_tables(points):
    """Segment tables of an open polyline (..., N, 2): start points (x, y),
    vectors (x, y), squared lengths (>= 1e-12), start arc lengths,
    angles, each (..., N - 1)."""
    ax, ay = points[..., :-1, 0], points[..., :-1, 1]
    vx = points[..., 1:, 0] - ax
    vy = points[..., 1:, 1] - ay
    vv = torch.clamp(vx * vx + vy * vy, min=1e-12)
    ln = torch.sqrt(vv)
    arc0 = torch.cat([torch.zeros_like(ln[..., :1]),
                      _cumsum_f64(ln)[..., :-1]], dim=-1)
    return ax, ay, vx, vy, vv, arc0, torch.atan2(vy, vx)


def _project(tabs, px, py, seg_dim):
    """project_polyline of points (px, py) onto the polyline of ``tabs``
    (:func:`_seg_tables`, shaped to broadcast with the points over the
    segment axis ``seg_dim``).  Returns (arc_len, distance, q at the chosen
    segment, chosen segment, angle), the segment axis reduced."""
    ax, ay, vx, vy, vv, arc0, ang = tabs
    pvx, pvy = px - ax, py - ay
    q = (pvx * vx + pvy * vy) / vv
    qc = torch.clamp(q, 0.0, 1.0)
    fx = ax + vx * qc
    fy = ay + vy * qc
    d2 = (px - fx) ** 2 + (py - fy) ** 2
    best = torch.argmin(d2, dim=seg_dim, keepdim=True)

    def pick(x):
        return torch.gather(x.expand(d2.shape), seg_dim, best).squeeze(
            seg_dim)

    fx_b, fy_b = pick(fx), pick(fy)
    dist = torch.sqrt(pick(d2))
    arc = pick(arc0) + torch.sqrt((fx_b - pick(ax)) ** 2
                                  + (fy_b - pick(ay)) ** 2)
    an = pick(ang)
    ox, oy = fx_b - px.squeeze(seg_dim), fy_b - py.squeeze(seg_dim)
    on = torch.sqrt(ox ** 2 + oy ** 2)
    inv = 1.0 / torch.clamp(on, min=1e-12)
    sign_neg = (torch.cos(an) * (-oy * inv)
                + torch.sin(an) * (ox * inv)) <= 0.0
    dist = torch.where(sign_neg, -dist, dist)
    dist = torch.where(on < 1e-9, torch.zeros_like(dist), dist)
    return arc, dist, pick(q), best.squeeze(seg_dim), an


# ---------------------------------------------------------------------
# the rollout

def _pp(pp_vec):
    return {k: pp_vec[i] for i, k in enumerate(PP_KEYS)}


def rollout_reference(init_ref, init_con, l_trg, d_stop0, dt_replan,
                      ref_line, ref_step, objs, pp_vec, T):
    """The plain version of the rollout (the JAX package's
    ``rollout_lanes``, idm_kernel.py:444-743): every candidate's closed
    loop over T steps.  l_trg, d_stop0: (C,).  Returns ref_states
    (C, T, 10), states (C, T, 9)."""
    pp = _pp(pp_vec)
    dev = l_trg.device
    f32 = torch.float32
    C = l_trg.shape[0]
    NR = ref_line.shape[0]
    ref = init_ref[:, None].expand(10, C)
    con = init_con[:, None].expand(9, C)
    valid = objs["valid"] != 0.0
    valid_o = valid & (objs["on_local_map"] != 0.0)
    O, _, K, _ = objs["hull_preds"].shape
    db, df = pp["dist_back_veh"], pp["dist_front_veh"]
    half_w = pp["width_veh"] / 2.0

    # the object data on the common step times, shared by all candidates
    ts = step_times(init_ref[R_T], pp["dt"], T - 1)
    hulls_S, _, head_S, v_S, hp_S = _obj_at(objs, ts)

    # the next zero-v stop cell at or after each grid index
    ss_grid = torch.arange(NR, dtype=f32, device=dev) * ref_step
    inf = torch.full((), float("inf"), dtype=f32, device=dev)
    zero_pos = torch.where(ref_line[:, 4] == 0.0, ss_grid, inf)
    next_zero = torch.flip(torch.cummin(torch.flip(zero_pos, [0]), 0)[0],
                           [0])
    nz_inf = torch.isinf(next_zero)
    nz_fin = torch.where(nz_inf, torch.zeros_like(next_zero), next_zero)

    tabs = tuple(x[:, None] for x in _seg_tables(ref_line[:, :2]))

    refs, cons = [], []
    for k in range(T - 1):
        hx, hy = hulls_S[k, ..., 0], hulls_S[k, ..., 1]        # (O, K)
        head_o, v_o, hp = head_S[k], v_S[k], hp_S[k]

        # --- reference update ---
        x, y, h, s, l, v, a = (ref[R_X], ref[R_Y], ref[R_H], ref[R_S],
                               ref[R_L], ref[R_V], ref[R_A])
        v_trg_dist = v * pp["t_vel_lookahead"]
        v_trg = torch.full_like(v, float("inf"))
        for j in range(25):
            sk = s + float(j) * div_const(v_trg_dist, 25)
            v_trg = torch.minimum(
                v_trg, _ref_lerp_2hot(ref_line, ref_step, sk, 4))
        v_trg = torch.clamp(v_trg, min=0.001)

        # the leader (get_leader_lanes)
        dx, dy = torch.cos(h), torch.sin(h)
        p0x = x - dx * db
        p0y = y - dy * db
        ray_len = 200.0 + db
        rx = hx[..., None] - p0x
        ry = hy[..., None] - p0y                               # (O, K, C)
        arc = rx * dx + ry * dy
        lat = dx * ry - dy * rx
        in_bounds = (arc > 0.0) & (arc < ray_len)
        vmask = valid_o[:, None, None]
        on_left = torch.any((lat > 0.0) & vmask, dim=1)        # (O, C)
        on_right = torch.any((lat < 0.0) & vmask, dim=1)
        spans = on_left & on_right
        close_lat = torch.abs(lat) < half_w + pp["d_safe_lat"]
        lead_mask = in_bounds & vmask & (spans[:, None] | close_lat)
        dists = torch.where(lead_mask, arc - db, inf)
        flat = dists.reshape(O * K, C)
        idx = torch.argmin(flat, dim=0)
        d_lead = torch.amin(flat, dim=0)
        io = torch.div(idx, K, rounding_mode="floor")
        v_at = v_o[io] * torch.cos(head_o[io] - h)
        v_lead = torch.where(torch.isfinite(d_lead), v_at,
                             torch.zeros_like(v_at))
        front = in_bounds & vmask & (arc < df)
        nspan = ~spans[:, None]
        hundred = torch.full((), 100.0, dtype=f32, device=dev)
        d_right = torch.amin(torch.where(front & (lat < 0.0) & nspan,
                                         torch.abs(lat), hundred), dim=(0, 1))
        d_left = torch.amin(torch.where(front & (lat > 0.0) & nspan,
                                        torch.abs(lat), hundred), dim=(0, 1))
        span_front = torch.any((front & spans[:, None]).reshape(O * K, C),
                               dim=0)
        d_right = torch.where(span_front, torch.zeros_like(d_right), d_right)
        d_left = torch.where(span_front, torch.zeros_like(d_left), d_left)
        on_lane = ((l_trg > hp[:, 2:3] - half_w - pp["d_safe_lat"])
                   & (l_trg < hp[:, 3:4] + half_w + pp["d_safe_lat"])
                   & (s < hp[:, 1:2]) & valid[:, None])       # (O, C)
        lane_d = torch.where(on_lane, hp[:, 0:1] - s, inf)
        li = torch.argmin(lane_d, dim=0)
        lane_best = torch.amin(lane_d, dim=0)
        better = lane_best < d_lead
        v_lead = torch.where(better, v_o[li], v_lead)
        d_lead = torch.where(better, lane_best, d_lead)
        d_lead = torch.where(torch.isfinite(d_lead), d_lead,
                             torch.full_like(d_lead, 1e6))
        oncoming = v_lead < 0.0
        d_lead = torch.where(oncoming, d_lead - 10.0, d_lead)
        v_lead = torch.where(oncoming, v_lead * 2.0, v_lead)

        # the next stop point: the zero-v leg from the suffix table, the
        # off-road leg over every cell
        i0 = torch.clamp(torch.ceil(s / ref_step), 0.0, NR - 1.0).long()
        d_zero = torch.where(nz_inf[i0], inf, nz_fin[i0] - s)
        ahead = ss_grid[:, None] >= s
        off_road = (l < -ref_line[:, 6:7]) | (l > ref_line[:, 5:6])
        d_off = torch.amin(torch.where(ahead & off_road,
                                       ss_grid[:, None] - s
                                       - pp["d_safe_min"], inf), dim=0)
        d_stop = torch.minimum(d_zero, d_off)
        d_stop = torch.minimum(d_stop0 - s, d_stop)

        t_headway = pp["t_headway_desired"] * (
            1.0 - torch.tanh((l - l_trg) * 0.5) ** 2)
        t_headway = torch.clamp(t_headway, min=0.5)
        sq2 = 2 * torch.sqrt(pp["a_max"] * pp["a_break_comf"])
        s_net_stop = d_stop - df + 1.0
        s_star_stop = 1.0 + v * t_headway + v ** 2 / sq2
        inter_term = s_star_stop / s_net_stop
        s_net = d_lead - df
        s_star = pp["d_safe_min"] + v * t_headway + v * (v - v_lead) / sq2
        inter_term = torch.where(d_lead < d_stop,
                                 torch.maximum(s_star / s_net, inter_term),
                                 inter_term)
        v_rel = v / v_trg
        expo = torch.where(v_rel < 1.0, pp["idm_exp_acc"],
                           pp["idm_exp_dcc"])
        a_idm = pp["a_max"] * (1.0 - v_rel ** expo - inter_term ** 2)

        rp_h = _ref_lerp_2hot(ref_line, ref_step, s, 2)
        rp_k = _ref_lerp_2hot(ref_line, ref_step, s, 3)
        l_change = torch.clamp(l_trg - l, -1.5, 1.5)
        nl = l + l_change * pp["dt"]
        s_rate = v * torch.cos(h - rp_h) / (1.0 - l * rp_k)
        ns = s + s_rate * pp["dt"]
        nrp_x = _ref_lerp_2hot(ref_line, ref_step, ns, 0)
        nrp_y = _ref_lerp_2hot(ref_line, ref_step, ns, 1)
        nrp_h = _ref_lerp_2hot(ref_line, ref_step, ns, 2)
        heading_rel = _short_angle(h, rp_h) + s_rate * rp_k * pp["dt"]
        nh = nrp_h + heading_rel

        dt_control = dt_replan if k == 0 else pp["dt"]
        dtc = torch.clamp(dt_control, min=1e-6)
        lane_changing = ((torch.abs(l - l_trg) > 0.5) & (v > 1.0)
                         & (v < 5.0))
        a_idm = torch.where(lane_changing, torch.clamp(a_idm, max=0.0),
                            a_idm)
        j = (a_idm - a) / dtc
        j_standstill = torch.minimum(torch.maximum(j, pp["j_min"]), -a / dtc)
        j = torch.where((v == 0.0) & (a < 0.0), j_standstill,
                        torch.minimum(torch.maximum(j, pp["j_min"]),
                                      pp["j_max"]))
        a_new = torch.minimum(torch.maximum(fma32(j, dt_control, a),
                                            pp["a_min"]), pp["a_max"])

        ref_out = torch.stack([ref[R_T], x, y, h, v, a_new, s, l, d_right,
                               d_left])
        zeros = torch.zeros_like(nl)
        nref = torch.stack([
            ref[R_T] + pp["dt"],
            nrp_x - nl * torch.sin(nrp_h),
            nrp_y + nl * torch.cos(nrp_h),
            nh,
            torch.clamp(fma32(a_new, pp["dt"], v), min=0.0),
            a_new, ns, nl, zeros, zeros])

        # --- following controller (Stanley + PD) ---
        ct, cx, cy, ch, cst, cv, ca, cs, cl = (con[i] for i in range(9))
        k_con = _ref_lerp_2hot(ref_line, ref_step, cs, 3)
        k_adj = torch.where(torch.abs(k_con) > 1e-4,
                            1.0 / (1.0 / k_con + cl), k_con)
        steer_ref = torch.atan(k_adj * pp["wheel_base"])
        angle_diff = _short_angle(ch, h)
        lat_diff = l - cl
        steer_angle = steer_ref + angle_diff + torch.atan(
            pp["k_stanley"] * lat_diff / (pp["v_offset_stanley"] + cv))
        steer_angle = torch.minimum(torch.maximum(
            steer_angle, -pp["steer_angle_max"]), pp["steer_angle_max"])
        steer_rate = torch.minimum(torch.maximum(
            (steer_angle - cst) / dtc, -pp["steer_rate_max"]),
            pp["steer_rate_max"])
        do_steer = (cv > 1.0) | (ca > 0.5) | (torch.abs(lat_diff) > 0.1)
        new_steer = torch.where(do_steer, cst + steer_rate * dt_control, cst)
        err_s = s - cs
        err_v = v - cv
        a_con = a_new + err_s * pp["k_p_s"] + err_v * pp["k_p_v"]
        con_out = torch.stack([ct, cx, cy, ch, new_steer, cv, a_con, cs, cl])

        nv = torch.clamp(fma32(pp["dt"], a_con, cv), min=0.0)
        nheading = ch + pp["dt"] * nv * torch.tan(new_steer) \
            / pp["wheel_base"]
        nx = cx + pp["dt"] * nv * torch.cos(nheading)
        ny = cy + pp["dt"] * nv * torch.sin(nheading)
        arc_p, lat_p = _project(tabs, nx[None], ny[None], 0)[:2]
        ncon = torch.stack([ct + pp["dt"], nx, ny, nheading, new_steer, nv,
                            a_con, arc_p, lat_p])

        refs.append(ref_out)
        cons.append(con_out)
        ref, con = nref, ncon
    refs.append(ref)
    cons.append(con)
    return (torch.stack(refs).permute(2, 0, 1).contiguous(),
            torch.stack(cons).permute(2, 0, 1).contiguous())


# ---------------------------------------------------------------------
# the evaluation

def _rect_geom(pp):
    db, df = pp["dist_back_veh"], pp["dist_front_veh"]
    hw = pp["width_veh"] / 2.0
    return (torch.minimum(db, df), torch.maximum(db, df), hw,
            (db + df) / 2.0, torch.abs(df - db) / 2.0)


def _rect_sat_hit(cx, cy, ch, px, py, n_x, n_y, edge_ok, hmin, hmax, pp):
    """Ego rect at (cx, cy, ch) vs convex hulls with vertices (px, py)
    [(..., K, C)], edge normals, per-edge validity and hull
    self-projections [(..., K, C)] -> hit (..., C)."""
    x_lo, x_hi, hw, mid_x, half_x = _rect_geom(pp)
    ux, uy = torch.cos(ch), torch.sin(ch)
    rx, ry = px - cx, py - cy
    hx = rx * ux + ry * uy
    hy = -rx * uy + ry * ux
    kd = px.dim() - 2
    gap_rect = ((torch.amax(hx, dim=kd) < x_lo)
                | (torch.amin(hx, dim=kd) > x_hi)
                | (torch.amax(hy, dim=kd) < -hw)
                | (torch.amin(hy, dim=kd) > hw))
    cn = cx * n_x + cy * n_y
    un = ux * n_x + uy * n_y
    vn = -uy * n_x + ux * n_y
    ecen = cn + mid_x * un
    eext = half_x * torch.abs(un) + hw * torch.abs(vn)
    gap_edge = ((ecen + eext < hmin) | (hmax < ecen - eext)) & edge_ok
    return ~(gap_rect | torch.any(gap_edge, dim=kd))


def _hull_edges(px, py):
    """Edge normals, validity and self-projections (min / max over the
    vertices of p . n per edge) of convex hulls, the vertex axis at
    position 1 [(O, K, ...)]."""
    ex = torch.roll(px, -1, dims=1) - px
    ey = torch.roll(py, -1, dims=1) - py
    edge_ok = ex * ex + ey * ey > 1e-18
    n_x, n_y = -ey, ex
    q = n_x[:, :, None] * px[:, None, :] + n_y[:, :, None] * py[:, None, :]
    return n_x, n_y, edge_ok, torch.amin(q, dim=2), torch.amax(q, dim=2)


def _sum_rows(x):
    """The sum over axis 0 in index order (the kernels' order)."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def evaluate_reference(ref_states, states, l_trgs, objs, ref_line, ref_step,
                       pp_vec, l_trg_global):
    """The plain version of the evaluation (the JAX package's
    ``evaluate_lanes``, idm_kernel.py:928-1112).  ref_states (C, T, 10),
    states (C, T, 9), l_trgs (C,).  Returns (5, C) float32, the rows
    :data:`COST_KEYS` (``invalid`` 0.0 / 1.0)."""
    pp = _pp(pp_vec)
    dev = states.device
    f32 = torch.float32
    C, T = states.shape[:2]
    O, P = objs["pred_t"].shape
    valid = objs["valid"] != 0.0
    ts = states[0, :, V_T]                                  # shared grid

    hulls_T, pos_T, _, v_T, _ = _obj_at(objs, ts)           # (T, O, ...)
    cn_x, cn_y, cedge_ok, chmin, chmax = _hull_edges(
        hulls_T[..., 0].permute(1, 2, 0), hulls_T[..., 1].permute(1, 2, 0))
    path_tabs = tuple(x[..., None] for x in _seg_tables(objs["pred_xy"]))

    st = states.permute(1, 2, 0)                            # (T, 9, C)
    sx, sy, sh = st[:, V_X], st[:, V_Y], st[:, V_H]
    l_off = pp["length_veh"] / 2.0 - pp["dist_back_veh"]
    near_rad = pp["radius_veh"] + objs["radius_hull"][None, :] + v_T
    dists_o, pred_t = objs["pred_dists"], objs["pred_t"]
    hull_p = objs["hull_preds"]                             # (O, P, K, 2)
    orow = torch.arange(O, device=dev)[:, None].expand(O, C)

    colls, inters = [], []
    for t in range(T):
        cx, cy, ch = sx[t], sy[t], sh[t]
        # collision screen against the hulls at the shared step time
        hit = _rect_sat_hit(cx, cy, ch, hulls_T[t, ..., 0, None],
                            hulls_T[t, ..., 1, None], cn_x[..., t, None],
                            cn_y[..., t, None], cedge_ok[..., t, None],
                            chmin[..., t, None], chmax[..., t, None], pp)
        ccx = cx + l_off * torch.cos(ch)
        ccy = cy + l_off * torch.sin(ch)
        dist_o = torch.sqrt((pos_T[t, :, 0, None] - ccx) ** 2
                            + (pos_T[t, :, 1, None] - ccy) ** 2)  # (O, C)
        near = (dist_o <= near_rad[t][:, None]) & valid[:, None]
        colls.append(torch.any(hit & near, dim=0))

        # interaction screen: the ego position on each object's path
        arc, dist, q_b, best, ang = _project(
            path_tabs, cx[None, None, :], cy[None, None, :], 1)
        in_b = ~(((best == 0) & (q_b < 0.0))
                 | ((best == P - 2) & (q_b > 1.0)))
        ok = in_b & valid[:, None] & (
            torch.abs(dist) <= pp["radius_veh"] + objs["radius_hull"][:, None])
        # the prediction time at the matched station, the hull at it
        i_st, a_st = _bracket_by_t(dists_o[:, None, :].expand(O, C, P), arc)
        tt = pred_t[orow, i_st] * (1.0 - a_st) + pred_t[orow, i_st + 1] * a_st
        i_t, aa = _bracket_by_t(pred_t[:, None, :].expand(O, C, P), tt)
        w = aa[:, None, :, None]
        hp = (hull_p[orow, i_t].permute(0, 2, 1, 3) * (1.0 - w)
              + hull_p[orow, i_t + 1].permute(0, 2, 1, 3) * w)  # (O,K,C,2)
        hpx, hpy = hp[..., 0], hp[..., 1]
        inx, iny, ieok, ihmin, ihmax = _hull_edges(hpx, hpy)
        ihit = _rect_sat_hit(cx, cy, ch, hpx, hpy, inx, iny, ieok, ihmin,
                             ihmax, pp)
        oncoming = torch.cos(ch - ang) < 0.0
        term = torch.where(ok & ihit & oncoming, 1.0 / (1.0 + torch.abs(dist)),
                           torch.zeros_like(dist))
        inters.append(_sum_rows(term))
    colls = torch.stack(colls)                              # (T, C)
    inter = torch.stack(inters)

    any_coll = torch.any(colls, dim=0)
    first_coll = torch.argmax(colls.to(torch.uint8), dim=0)
    t_coll = ts[first_coll]
    invalid = any_coll & (t_coll < 3.0)
    zero = torch.zeros((), dtype=f32, device=dev)
    cost_collision = torch.where(any_coll, float(T) * pp["dt"] - t_coll, zero)
    first = torch.where(any_coll, first_coll, torch.full_like(first_coll, T))
    before = torch.arange(T, device=dev)[:, None] < first
    cost_interaction = _sum_rows(torch.where(before, inter, zero))

    seg = torch.sqrt(torch.diff(sx, dim=0) ** 2 + torch.diff(sy, dim=0) ** 2)
    cost_distance = 1000.0 - _sum_rows(seg)

    cost = pp["w_l"] * (l_trg_global - l_trgs) ** 2
    min_dl = torch.amin(ref_states[:, :-1, R_DL], dim=1)
    min_dr = torch.amin(ref_states[:, :-1, R_DR], dim=1)
    dc = pp["d_comf_lat"]
    cost = cost + torch.where(min_dl < dc,
                              pp["w_lat_dist"] * (dc - min_dl) / dc, zero)
    cost = cost + torch.where(min_dr < dc,
                              pp["w_lat_dist"] * (dc - min_dr) / dc, zero)
    cost = cost + _sum_rows(pp["w_a"] * torch.clamp(st[:, V_A], max=0.0) ** 2)

    # the road-edge count, its margin in float64 (a NumPy float64 scalar in
    # the JAX package)
    s_ct = states[:, :, V_S]
    dl_rp = _ref_ch_lerp(ref_line, ref_step, s_ct, 5).to(torch.float64)
    dr_rp = _ref_ch_lerp(ref_line, ref_step, s_ct, 6).to(torch.float64)
    margin = (pp["width_veh"] / 2.0).to(torch.float64) * np.sqrt(2.0)
    l_ct = states[:, :, V_L].to(torch.float64)
    edge = (torch.sum(l_ct > dl_rp - margin, dim=1)
            + torch.sum(l_ct < -dr_rp + margin, dim=1)).to(f32)

    cost_collision = cost_collision + torch.where(any_coll, zero, edge)
    cost = torch.where(any_coll, zero, cost)
    cost_distance = torch.where(any_coll, zero, cost_distance)
    return torch.stack([cost, cost_distance, cost_interaction,
                        cost_collision, invalid.to(f32)])


# ---------------------------------------------------------------------
# the wrappers

def _check_objs(objs, dev):
    O, P, K, _ = objs["hull_preds"].shape
    shapes = dict(pred_t=(O, P), pred_xy=(O, P, 2), pred_heading=(O, P),
                  pred_v=(O, P), pred_dists=(O, P), hull_preds=(O, P, K, 2),
                  hull_projs=(O, P, 4), radius_hull=(O,), valid=(O,),
                  on_local_map=(O,))
    for k in OBJ_KEYS:
        _check(k, objs[k], shapes[k], torch.float32, dev)
    if not (1 <= O <= MAX_OBJS and 2 <= P <= MAX_PRED and 1 <= K <= MAX_HULL):
        raise ValueError(f"objects ({O}, {P}, {K}): the kernels take at most "
                         f"({MAX_OBJS}, {MAX_PRED}, {MAX_HULL})")
    return O, P, K


def _check_ref(ref_line, ref_step, pp_vec, dev):
    if ref_line.dim() != 2 or ref_line.shape[1] != 7 or ref_line.shape[0] < 2:
        raise ValueError(f"ref_line must be (n, 7), got "
                         f"{tuple(ref_line.shape)}")
    _check("ref_line", ref_line, ref_line.shape, torch.float32, dev)
    _check("ref_step", ref_step.reshape(1), (1,), torch.float32, dev)
    _check("pp", pp_vec, (len(PP_KEYS),), torch.float32, dev)


def _obj_ptrs(objs):
    return [objs[k].data_ptr() for k in OBJ_KEYS]


def rollout(init_ref, init_con, l_trg, d_stop0, dt_replan, ref_line,
            ref_step, objs, pp_vec, T, out=None):
    """The rollout of every candidate: (ref_states (C, T, 10), states (C,
    T, 9)).  One launch of ``idm_rollout`` on a CUDA tensor,
    :func:`rollout_reference` on a CPU tensor.  ``init_ref`` (10,),
    ``init_con`` (9,), ``l_trg`` / ``d_stop0`` (C,), ``dt_replan`` and
    ``ref_step`` one element, ``ref_line`` (NR, 7), ``objs``
    (:data:`OBJ_KEYS`), ``pp_vec`` (:data:`PP_KEYS`); float32, contiguous,
    on one device.  ``out``: optional (ref_states, states) buffers."""
    global rollout_launches
    dev = l_trg.device
    f32 = torch.float32
    C = l_trg.shape[0]
    _check("init_ref", init_ref, (10,), f32, dev)
    _check("init_con", init_con, (9,), f32, dev)
    _check("l_trg", l_trg, (C,), f32, dev)
    _check("d_stop0", d_stop0, (C,), f32, dev)
    _check("dt_replan", dt_replan.reshape(1), (1,), f32, dev)
    _check_ref(ref_line, ref_step, pp_vec, dev)
    O, P, K = _check_objs(objs, dev)
    if C < 1 or T < 2:
        raise ValueError(f"{C} candidates of {T} steps: outside what the "
                         "rollout takes")
    if dev.type == "cpu":
        res = rollout_reference(init_ref, init_con, l_trg, d_stop0,
                                dt_replan.reshape(()), ref_line,
                                ref_step.reshape(()), objs, pp_vec, T)
        if out is not None:
            out[0].copy_(res[0])
            out[1].copy_(res[1])
            return out
        return res
    if dev.type != "cuda":
        raise ValueError(f"idm_kernel: unsupported device {dev}")
    if out is None:
        out = (torch.empty((C, T, 10), dtype=f32, device=dev),
               torch.empty((C, T, 9), dtype=f32, device=dev))
    _check("ref_states", out[0], (C, T, 10), f32, dev)
    _check("states", out[1], (C, T, 9), f32, dev)
    lib = _kernel()
    NR = ref_line.shape[0]
    if NR > lib.idm_rollout_max_ref():
        raise ValueError(f"{NR} ref line points: the rollout takes at most "
                         f"{lib.idm_rollout_max_ref()}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.idm_rollout(
            init_ref.data_ptr(), init_con.data_ptr(), l_trg.data_ptr(),
            d_stop0.data_ptr(), dt_replan.data_ptr(), ref_line.data_ptr(),
            ref_step.data_ptr(), *_obj_ptrs(objs), pp_vec.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), C, T, NR, O, P, K, stream)
    if err != 0:
        raise RuntimeError(f"idm_rollout launch failed: CUDA error {err}")
    rollout_launches += 1
    return out


def evaluate(ref_states, states, l_trgs, objs, ref_line, ref_step, pp_vec,
             l_trg_global, out=None):
    """The screens and costs of every candidate: (5, C) float32, the rows
    :data:`COST_KEYS`.  One launch of ``idm_evaluate`` on a CUDA tensor,
    :func:`evaluate_reference` on a CPU tensor.  ``ref_states`` (C, T, 10),
    ``states`` (C, T, 9), ``l_trgs`` (C,), ``l_trg_global`` one element,
    the rest as :func:`rollout`'s.  ``out``: an optional (5, C) buffer."""
    global evaluate_launches
    dev = states.device
    f32 = torch.float32
    C, T = states.shape[:2]
    _check("ref_states", ref_states, (C, T, 10), f32, dev)
    _check("states", states, (C, T, 9), f32, dev)
    _check("l_trgs", l_trgs, (C,), f32, dev)
    _check("l_trg_global", l_trg_global.reshape(1), (1,), f32, dev)
    _check_ref(ref_line, ref_step, pp_vec, dev)
    O, P, K = _check_objs(objs, dev)
    if C < 1 or T < 2:
        raise ValueError(f"{C} candidates of {T} steps: outside what the "
                         "evaluation takes")
    if dev.type == "cpu":
        res = evaluate_reference(ref_states, states, l_trgs, objs, ref_line,
                                 ref_step.reshape(()), pp_vec,
                                 l_trg_global.reshape(()))
        if out is not None:
            out.copy_(res)
            return out
        return res
    if dev.type != "cuda":
        raise ValueError(f"idm_kernel: unsupported device {dev}")
    if out is None:
        out = torch.empty((len(COST_KEYS), C), dtype=f32, device=dev)
    _check("costs", out, (len(COST_KEYS), C), f32, dev)
    lib = _kernel()
    if T > lib.idm_evaluate_max_steps():
        raise ValueError(f"{T} steps: the evaluation takes at most "
                         f"{lib.idm_evaluate_max_steps()}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.idm_evaluate(
            ref_states.data_ptr(), states.data_ptr(), l_trgs.data_ptr(),
            *_obj_ptrs(objs), ref_line.data_ptr(), ref_step.data_ptr(),
            pp_vec.data_ptr(), l_trg_global.data_ptr(), out.data_ptr(), C, T,
            ref_line.shape[0], O, P, K, stream)
    if err != 0:
        raise RuntimeError(f"idm_evaluate launch failed: CUDA error {err}")
    evaluate_launches += 1
    return out


def make_idm_kernel(spec):
    """spec: steps_t, n_ref, n_obj, n_pred, n_hull.  Returns ``run(init_ref,
    init_con, l_trgs, d_stops, dt_replan, ref_line, ref_step, objs, pp,
    l_trg_global)`` -> (ref_states, states, costs (5, C)) on the device of
    ``l_trgs``, with ``run.rollout`` and ``run.evaluate`` (the two entries
    alone, the JAX package's argument order)."""
    T = spec["steps_t"]

    def rollout_(init_ref, init_con, l_trgs, d_stops, dt_replan, ref_line,
                 ref_step, objs, pp):
        return rollout(init_ref, init_con, l_trgs, d_stops, dt_replan,
                       ref_line, ref_step, objs, pp, T)

    def evaluate_(ref_states, states, l_trgs, objs, ref_line, ref_step, pp,
                  l_trg_global):
        return evaluate(ref_states, states, l_trgs, objs, ref_line, ref_step,
                        pp, l_trg_global)

    def run(init_ref, init_con, l_trgs, d_stops, dt_replan, ref_line,
            ref_step, objs, pp, l_trg_global):
        refs, cons = rollout_(init_ref, init_con, l_trgs, d_stops, dt_replan,
                              ref_line, ref_step, objs, pp)
        return refs, cons, evaluate_(refs, cons, l_trgs, objs, ref_line,
                                     ref_step, pp, l_trg_global)

    run.rollout = rollout_
    run.evaluate = evaluate_
    return run


# ---------------------------------------------------------------------
# bounds

# Operations of one candidate's step of the rollout as the plain version
# defines them (float32): the leader search 22 per hull point, the lane
# search 14 per object, the stop scan 8 per ref cell, the projection 16 per
# segment, the 25 speed-limit lookups 12 each, the IDM law and the
# controller 120; transcendentals counted as one operation each.  The
# kernel's exact searches (csrc/idm_rollout.cu) add a box key of 8 per
# segment chunk and a test of 6 per cell chunk they look at.
ROLLOUT_OPS = dict(point=22, obj=14, cell=8, seg=16, lookup=12 * 25,
                   scalar=120, seg_chunk=8, cell_chunk=6)
# Operations of the evaluation: per (candidate, step, object) the collision
# gate 10, the path gate 8 and, where the path gate lets it through, the
# interaction screen's projection (16 per path segment), two brackets (4 per
# prediction point each) and term 12; per hull test that a gate lets through
# (:func:`evaluate_work`) the hull lerp 6 per vertex, the edges and
# self-projections 3 * K + 4 per edge, the rectangle 12 per vertex and 14 per
# edge; per (candidate, step) the sums, 12.
EVAL_OPS = dict(vertex=6 + 12, edge_k=3, edge=4 + 14, gate=10, path_gate=8,
                seg=16, pred=8, inter=12, step=12)
# the critical path of one candidate's rollout step (csrc/idm_rollout.cu):
# warp-wide reductions of five levels (the speed limit, the leader's two
# sides, its (value, index) minimum, its side distances, the lane search,
# the projection's best after the first chunk and its final (value, index)
# minimum), four ballots (the stop point's chunk and cell searches), the
# per-lane scans (6 hull points twice, one segment of the first chunk), the
# scalar chain of the IDM law and the controller
CHAIN_STEP = dict(f32_add=6 * 3 * 2 + 16 + 12 + 60 + 5 * 10, f32_mul=40,
                  f32_div=9, f32_sin=3, f32_cos=4, f32_atan=3,
                  smem_load=10 * 5 * 2 + 4 * 2 + 12)
# the evaluation of one (candidate, step): the O gates (collision and path)
# one after the other, one hull test of each screen (the hull's K x K
# self-projections dominate) and the projection of the interaction screen,
# then the per-candidate sums, T steps on one thread
CHAIN_EVAL_GATE = dict(f32_add=8, f32_mul=4, smem_load=6)
CHAIN_EVAL_OBJ = dict(f32_add=16 * 16 + 40, f32_mul=16 * 16, f32_div=3,
                      f32_cos=2, f32_sin=1, smem_load=40)
CHAIN_EVAL_STEP = dict(f32_add=4, smem_load=4)


def rollout_operations(C, T, NR, O, K, work=None):
    """Operations of one rollout: with ``work`` None, every step scanning
    every ref cell and segment (the full-scan bound of the plain version);
    with ``work`` (:func:`rollout_work`), the cells, segments and chunks an
    exact pruned search needs on these inputs."""
    per_step = (ROLLOUT_OPS["point"] * O * K + ROLLOUT_OPS["obj"] * O
                + ROLLOUT_OPS["lookup"] + ROLLOUT_OPS["scalar"])
    if work is None:
        return C * (T - 1) * (per_step + ROLLOUT_OPS["cell"] * NR
                              + ROLLOUT_OPS["seg"] * (NR - 1))
    return (C * (T - 1) * per_step + ROLLOUT_OPS["cell"] * work["cells"]
            + ROLLOUT_OPS["seg"] * work["segments"]
            + ROLLOUT_OPS["seg_chunk"] * work["seg_chunks"]
            + ROLLOUT_OPS["cell_chunk"] * work["cell_chunks"])


def rollout_bytes(C, T, NR, O, P, K):
    """Bytes one rollout must move: the ref line, the objects, the
    parameters and the candidates' inputs read once, both state arrays
    written once."""
    objs = O * P * (1 + 2 + 1 + 1 + 1 + 2 * K + 4) + 3 * O
    return 4 * (NR * 7 + objs + len(PP_KEYS) + 10 + 9 + 3 + 2 * C
                + C * T * 19)


def rollout_bound_ms(C, T, NR, O, P, K, work=None):
    """The roofline bound of one rollout, of the full scan (``work`` None)
    or of the work :func:`rollout_work` counts."""
    return _latency.roofline_ms(rollout_bytes(C, T, NR, O, P, K),
                                rollout_operations(C, T, NR, O, K, work),
                                "float32")


def rollout_chain_ms(T, cycles, sm_mhz):
    return _latency.chain_ms(_latency.add_ops({}, CHAIN_STEP, T - 1), cycles,
                             sm_mhz)


CHUNK = 32      # cells / segments a chunk of the kernels' exact searches
BOX_REL = 2.0 ** -20    # the kernels' box margin (csrc/idm_common.cuh)


def _grown_boxes(x, y, n_chunks):
    """The bounding boxes of consecutive CHUNK-segment chunks of the
    polyline (x, y) (..., N), grown by the kernels' rounding margin
    (csrc/idm_common.cuh box_grow): (..., n_chunks, 4)."""
    n_seg = x.shape[-1] - 1
    pad = n_chunks * CHUNK - n_seg
    inf = float("inf")

    def ends(v, fn, fill):
        lo = fn(v[..., :-1], v[..., 1:])
        lo = torch.nn.functional.pad(lo, (0, pad), value=fill)
        return lo.reshape(lo.shape[:-1] + (n_chunks, CHUNK))

    xlo = ends(x, torch.minimum, inf).amin(-1)
    xhi = ends(x, torch.maximum, -inf).amax(-1)
    ylo = ends(y, torch.minimum, inf).amin(-1)
    yhi = ends(y, torch.maximum, -inf).amax(-1)
    m = torch.maximum(torch.maximum(xlo.abs(), xhi.abs()),
                      torch.maximum(ylo.abs(), yhi.abs()))
    d = m * BOX_REL
    return torch.stack([xlo - d, xhi + d, ylo - d, yhi + d], -1)



def _box_key(box, px, py):
    """csrc/idm_common.cuh box_key: every segment in ``box`` has a squared
    distance to (px, py) above x wherever the key is above x."""
    dx = torch.clamp(torch.maximum(box[..., 0] - px, px - box[..., 1]),
                     min=0.0)
    dy = torch.clamp(torch.maximum(box[..., 2] - py, py - box[..., 3]),
                     min=0.0)
    lb = dx * dx + dy * dy
    return torch.where(lb > 1e-30, lb * (1.0 - BOX_REL),
                       torch.zeros_like(lb))


def rollout_work(refs, cons, ref_line, ref_step, pp_vec):
    """The work an exact pruned search needs on the rollout that gave
    ``refs`` (C, T, 10) and ``cons`` (C, T, 9) (the plain version's
    outputs): per step, the projection's segments in the CHUNK-segment
    chunks whose box key is not above the true minimum (the chunks no exact
    search may skip) and the box keys of every chunk; the stop point's cell
    chunks up to the first that can hold its zero-speed or off-road cell,
    and the cells of those it opens.  Returns a dict of totals
    (``segments``, ``seg_chunks``, ``cells``, ``cell_chunks``) for
    :func:`rollout_operations`."""
    pp = _pp(pp_vec)
    C, T = cons.shape[:2]
    NR = ref_line.shape[0]
    f32 = torch.float32
    dev = cons.device
    n_sch = (NR - 1 + CHUNK - 1) // CHUNK
    n_cch = (NR + CHUNK - 1) // CHUNK
    boxes = _grown_boxes(ref_line[:, 0], ref_line[:, 1], n_sch)  # (n_sch, 4)
    seg_of = torch.full((n_sch,), CHUNK, dtype=torch.int64, device=dev)
    seg_of[-1] = (NR - 1) - CHUNK * (n_sch - 1)
    tabs = tuple(x[:, None] for x in _seg_tables(ref_line[:, :2]))
    pad = n_cch * CHUNK - NR
    chunked = lambda v, fill: torch.nn.functional.pad(
        v, (0, pad), value=fill).reshape(n_cch, CHUNK)
    c_dl = chunked(ref_line[:, 5], float("inf")).amin(1)
    c_dr = chunked(ref_line[:, 6], float("inf")).amin(1)
    c_zero = chunked((ref_line[:, 4] == 0.0).to(f32), 0.0).amax(1) > 0
    last = torch.clamp(torch.arange(n_cch, device=dev) * CHUNK + CHUNK - 1,
                       max=NR - 1)
    ss_last = last.to(f32) * ref_step
    jj = torch.arange(n_cch, device=dev)
    segments = cells = cell_chunks = 0
    for k in range(T - 1):
        nx, ny = cons[:, k + 1, V_X], cons[:, k + 1, V_Y]
        ax, ay, vx, vy, vv = tabs[:5]
        q = ((nx - ax) * vx + (ny - ay) * vy) / vv
        qc = torch.clamp(q, 0.0, 1.0)
        ex, ey = nx - (ax + vx * qc), ny - (ay + vy * qc)
        best = torch.amin(ex * ex + ey * ey, 0)                      # (C,)
        key = _box_key(boxes[:, None], nx, ny)                      # (n_sch, C)
        segments += int((seg_of[:, None] * (key <= best)).sum())
        # the stop point: the chunks an exact search must look at
        s, l = refs[:, k, R_S], refs[:, k, R_L]
        i0 = torch.clamp(torch.ceil(s / ref_step), 0.0, NR - 1.0).long()
        cz = i0 // CHUNK
        zero_ok = c_zero[:, None] & (jj[:, None] >= cz)
        off_ok = (ss_last[:, None] >= s) & ((l < -c_dr[:, None])
                                            | (l > c_dl[:, None]))
        for ok, start in ((zero_ok, cz), (off_ok, torch.zeros_like(cz))):
            first = torch.where(ok.any(0), ok.to(torch.int64).argmax(0),
                                torch.full_like(cz, n_cch))
            cell_chunks += int((first - start + (first < n_cch).long())
                               .clamp(min=1).sum())
            cells += CHUNK * int((first < n_cch).sum())
    return dict(segments=segments, seg_chunks=(T - 1) * C * n_sch,
                cells=cells, cell_chunks=cell_chunks)


def evaluate_work(states, objs, pp_vec, projections=False):
    """The hull tests the evaluation's gates let through on these inputs:
    (collision tests, interaction tests), each a rectangle SAT against a
    K-vertex hull.  A collision test runs where the object is ``near`` the
    ego, an interaction test where the ego projects in bounds and close
    onto the object's path and the object is oncoming; the bound counts
    these, not every (candidate, step, object).  With ``projections`` a
    third count: the (candidate, step, object) projections onto a path that
    the path gate (the path's grown bounding box against the object's
    radius, csrc/idm_evaluate.cu) lets through."""
    pp = _pp(pp_vec)
    T = states.shape[1]
    valid = (objs["valid"] != 0.0)[:, None]
    _, pos_T, _, v_T, _ = _obj_at(objs, states[0, :, V_T])
    near_rad = pp["radius_veh"] + objs["radius_hull"][None, :] + v_T
    l_off = pp["length_veh"] / 2.0 - pp["dist_back_veh"]
    path_tabs = tuple(x[..., None] for x in _seg_tables(objs["pred_xy"]))
    P = objs["pred_t"].shape[1]
    rad = pp["radius_veh"] + objs["radius_hull"]                   # (O,)
    r2 = torch.clamp(rad * rad * (1.0 + BOX_REL), min=1e-17)
    xy = objs["pred_xy"]
    lo, hi = xy.amin(1), xy.amax(1)                                 # (O, 2)
    m = torch.maximum(lo.abs().amax(1), hi.abs().amax(1)) * BOX_REL
    boxes = torch.stack([lo[:, 0] - m, hi[:, 0] + m, lo[:, 1] - m,
                         hi[:, 1] + m], -1)                         # (O, 4)
    n_coll = n_inter = n_proj = 0
    for t in range(T):
        cx, cy, ch = (states[:, t, i] for i in (V_X, V_Y, V_H))
        ccx = cx + l_off * torch.cos(ch)
        ccy = cy + l_off * torch.sin(ch)
        dist_o = torch.sqrt((pos_T[t, :, 0, None] - ccx) ** 2
                            + (pos_T[t, :, 1, None] - ccy) ** 2)
        n_coll += int(((dist_o <= near_rad[t][:, None]) & valid).sum())
        _, dist, q_b, best, ang = _project(
            path_tabs, cx[None, None, :], cy[None, None, :], 1)
        in_b = ~(((best == 0) & (q_b < 0.0))
                 | ((best == P - 2) & (q_b > 1.0)))
        ok = in_b & valid & (torch.abs(dist) <= pp["radius_veh"]
                             + objs["radius_hull"][:, None])
        n_inter += int((ok & (torch.cos(ch - ang) < 0.0)).sum())
        if projections:
            key = _box_key(boxes[:, None], cx, cy)                  # (O, C)
            n_proj += int((~(key > r2[:, None])).sum())
    return (n_coll, n_inter, n_proj) if projections else (n_coll, n_inter)


def evaluate_operations(C, T, O, P, K, n_coll, n_inter, n_proj=None):
    """Operations of one evaluation with ``n_coll`` / ``n_inter`` hull tests
    (:func:`evaluate_work`): with ``n_proj`` None every (candidate, step,
    object) projected onto its path (the full-scan bound), else ``n_proj``
    projections the path gate lets through."""
    e = EVAL_OPS
    sat = e["vertex"] * K + (e["edge_k"] * K + e["edge"]) * K
    proj = e["seg"] * (P - 1) + e["pred"] * P + e["inter"]
    if n_proj is None:
        n_proj, gates = C * T * O, e["gate"]
    else:
        gates = e["gate"] + e["path_gate"]
    return (C * T * (O * gates + e["step"]) + n_proj * proj
            + (n_coll + n_inter) * sat)


def evaluate_bytes(C, T, NR, O, P, K):
    objs = O * P * (1 + 2 + 1 + 1 + 1 + 2 * K + 4) + 3 * O
    return 4 * (C * T * 19 + C + NR * 7 + objs + len(PP_KEYS) + 2
                + len(COST_KEYS) * C)


def evaluate_bound_ms(C, T, NR, O, P, K, n_coll, n_inter, n_proj=None):
    return _latency.roofline_ms(evaluate_bytes(C, T, NR, O, P, K),
                                evaluate_operations(C, T, O, P, K, n_coll,
                                                    n_inter, n_proj),
                                "float32")


def evaluate_chain_ms(T, O, cycles, sm_mhz):
    ops = _latency.add_ops({}, CHAIN_EVAL_GATE, 2 * O)
    ops = _latency.add_ops(ops, CHAIN_EVAL_OBJ, 2)
    ops = _latency.add_ops(ops, CHAIN_EVAL_STEP, T)
    return _latency.chain_ms(ops, cycles, sm_mhz)


_LIB = None


def _kernel():
    """Build (first call) and bind the two kernel libraries."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib_r = _build.load("idm_rollout")
        lib_e = _build.load("idm_evaluate")

        class _Libs:
            pass

        lib = _Libs()
        lib.idm_rollout = lib_r.idm_rollout
        lib.idm_rollout.restype = ctypes.c_int
        lib.idm_rollout.argtypes = (
            [ctypes.c_void_p] * (7 + len(OBJ_KEYS) + 3)
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.idm_evaluate = lib_e.idm_evaluate
        lib.idm_evaluate.restype = ctypes.c_int
        lib.idm_evaluate.argtypes = (
            [ctypes.c_void_p] * (3 + len(OBJ_KEYS) + 5)
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        for src, name in ((lib_r, "idm_rollout_max_ref"),
                          (lib_e, "idm_evaluate_max_steps")):
            fn = getattr(src, name)
            fn.restype = ctypes.c_int
            fn.argtypes = []
            setattr(lib, name, fn)
        for src, name in ((lib_r, "idm_rollout_blocks_per_sm"),
                          (lib_e, "idm_evaluate_blocks_per_sm")):
            fn = getattr(src, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 4
            setattr(lib, name, fn)
        for src, name in ((lib_r, "idm_rollout_param_keys"),
                          (lib_e, "idm_evaluate_param_keys")):
            fn = getattr(src, name)
            fn.restype = ctypes.c_char_p
            fn.argtypes = []
            if fn().decode().split(",")[:-1] != list(PP_KEYS):
                raise RuntimeError(f"{name}() (csrc/idm_common.cuh) and "
                                   "PP_KEYS disagree")
        lib.rollout_lib, lib.evaluate_lib = lib_r, lib_e
        _LIB = lib
    return _LIB
