"""
Lat/lon DP planner kernel: value iteration over the (s, ds, l) state grid
across time slices with (dds, dl) action sampling, plus the greedy forward
rollout, as PyTorch tensor programs on one device.

Re-design of the reference's CUDA value iteration (reference:
library/src/dyn_prog/lat_lon_planner.cu): each backward time slice is one
launch of the hand-written fused slice kernel (latlon_action_min.py
backward_slice_launch: the state costs, the forward distances and the
action-min of every cell) on a CUDA device and, as its plain version on the
CPU, a whole-grid evaluation of the state costs followed by the plain
action-min; the CUDA texture value lookups
(point for backward, trilinear for forward, arr_tex_surf.cuh:136-167)
become explicit round-index lookups / manual trilinear interpolation.
The whole solve runs in float32.

State trajectory layout (columns): t, s, ds, dds, ddds, l, dl, ddl, dddl,
cost, constr, flags (matching LatLonState, lat_lon_planner.cuh:82-110).
"""

import numpy as np
import torch

from tpl_tpu_torch.planning.dyn_prog import latlon_action_min as lam


# trajectory column indices
C_T, C_S, C_DS, C_DDS, C_DDDS, C_L, C_DL, C_DDL, C_DDDL, C_COST, \
    C_CONSTR, C_FLAGS = range(12)

CONSTR_OCCUPANCY = 1
CONSTR_VELOCITY = 2
CONSTR_ANGLE = 4


class LatLonParams:
    """(reference: lat_lon_planner.cuh:9-62)"""

    def __init__(self):
        self.s_min = 0.0
        self.s_max = 200.0
        self.ds_min = 0.0
        self.ds_max = 36.0
        self.l_min = -5.0
        self.l_max = 5.0

        self.dds_min = -2.0
        self.dds_max = 2.0
        self.dl_min = -2.0
        self.dl_max = 2.0

        self.t_steps = 10
        self.s_steps = 201
        self.ds_steps = 37
        self.l_steps = 21

        self.dt = 1.0
        self.dt_start = 1.0
        self.dt_smooth_traj = 0.1

        self.dds_start = 0.0
        self.w_dds_start = 10.0
        self.angle_start = 0.0
        self.w_angle_start = 10.0

        self.l_trg = 0.0

        self.w_progress = 1.0
        self.w_dds = 1.0
        self.w_ddds = 1.0
        self.w_l = 1.0
        self.w_dl = 1.0
        self.w_ddl = 1.0
        self.w_safety_dist = 10.0
        self.w_xing_slow = 1.0

        self.slope_abs_max = 0.8

        self.w_lat_dist = 0.0
        self.d_lat_comf = 2.0

        self.time_gap = 2.0
        self.gap_min = 2.0

        self.t_st_min = -1.0
        self.t_st_max = -1.0
        self.s_st = 0.0
        self.w_spatio_temporal = 10.0

        self.width_veh = 2.0
        self.length_veh = 6.0

    @classmethod
    def from_numpy(cls, vec):
        """Params from a packed vector in :data:`PP_KEYS` order (the
        layout of :meth:`packed`, and of the JAX package's
        ``LatLonParams.packed()``)."""
        vec = np.asarray(vec)
        if vec.shape != (len(PP_KEYS),):
            raise ValueError(f"packed params must be ({len(PP_KEYS)},), "
                             f"got {vec.shape}")
        p = cls()
        for k, v in zip(PP_KEYS, vec):
            setattr(p, k, float(v))
        return p

    @property
    def s_step(self):
        return (self.s_max - self.s_min) / (self.s_steps - 1)

    @property
    def ds_step(self):
        return (self.ds_max - self.ds_min) / (self.ds_steps - 1)

    @property
    def l_step(self):
        return (self.l_max - self.l_min) / (self.l_steps - 1)

    def packed(self):
        """All dynamic params as ONE f32 vector (one host->device copy
        per solve)."""
        return np.array([getattr(self, k) for k in PP_KEYS],
                        dtype=np.float32)


PP_KEYS = ("s_min", "s_max", "ds_min", "ds_max", "l_min", "l_max",
           "dds_min", "dds_max", "dl_min", "dl_max", "dt", "dt_start",
           "l_trg", "w_progress", "w_dds", "w_ddds", "w_l", "w_dl",
           "w_ddl", "w_safety_dist", "w_xing_slow", "slope_abs_max",
           "w_lat_dist", "d_lat_comf", "time_gap", "gap_min",
           "t_st_min", "t_st_max", "s_st", "w_spatio_temporal",
           "width_veh", "length_veh")


def unpack_pp(vec):
    """Expand a packed param vector into a dict of 0-d tensors."""
    return {k: vec[i] for i, k in enumerate(PP_KEYS)}


def latlon_dynamics_np(state, dds, dl, dt):
    """Host twin of the clamped double-integrator lon / rate lat dynamics
    (lat_lon_planner.cu:10-21). state: (12,) array."""
    res = np.array(state, dtype=np.float64).copy()
    res[C_T] = state[C_T] + dt
    res[C_S] = max(state[C_S],
                   state[C_S] + state[C_DS] * dt + 0.5 * dds * dt * dt)
    res[C_DS] = max(0.0, state[C_DS] + dds * dt)
    res[C_DDS] = dds
    res[C_L] = state[C_L] + dl * dt
    res[C_DL] = dl
    res[C_DDL] = 0.0
    res[C_DDDS] = 0.0
    res[C_DDDL] = 0.0
    return res


def _ref_tex(ref_line, ref_step, s):
    """Nearest-index ref line channels (RefLineGpu::texLerp)."""
    n = ref_line.shape[0]
    i = torch.clamp(torch.round(s / ref_step), 0, n - 1).long()
    return ref_line[i]


def _d_fwd_sweep(D_at, n2):
    """Incremental lateral-sweep min over center-out samples.

    D_at: (..., 2*n2+1) distances at the swept lateral offsets in
    center-out order. Returns same-shape cumulative mins per side.
    """
    center = D_at[..., :1]
    left = torch.cummin(torch.cat([center, D_at[..., 1:n2 + 1]], dim=-1),
                        dim=-1).values
    right = torch.cummin(torch.cat([center, D_at[..., n2 + 1:]], dim=-1),
                         dim=-1).values
    return torch.cat([center, left[..., 1:], right[..., 1:]], dim=-1)


def _first_true(cond):
    """Index of the first True along the last dim (0 when none)."""
    return torch.argmax(cond.to(torch.uint8), dim=-1)


def _take(x, idx):
    """x[idx] for a 0-d index tensor, without a host sync."""
    return torch.index_select(x, 0, idx.reshape(1))[0]


def make_latlon_solver(spec, device):
    """Build the DP solve for static grid sizes on ``device``.

    spec: dict with t_steps, s_steps, ds_steps, l_steps.
    Returns (solve, reeval):
      solve(dist_map_lon, ref_line, ref_step, pp, x0) ->
        (nodes (T, S, DS, L, 4), traj (T, 12)), float32 tensors on device;
      reeval(dist_map_lon, ref_line, ref_step, pp, traj) -> traj (N, 12).
    ``pp`` is a packed vector (:meth:`LatLonParams.packed`) or a dict.
    ``solve.batch(dist_maps (B, T, S, L, 2), ref_lines (B, n, 8), ref_step,
    pps, x0s (B, 12)) -> (nodes (B, T, S, DS, L, 4), trajs (B, T, 12))`` is
    the solve of a scenario batch (the JAX package's vmap of the solve):
    ``pps`` a dict of (B,) values by :data:`PP_KEYS` or a (B, n) packed
    array; ``ref_step`` shared; the reference lines of one row count (a
    list of them with another raises).  Its backward pass launches the
    fused slice kernel once per slice for the whole batch; its final slice
    and its forward pass run per scenario, as :func:`solve` runs them.
    """
    T = spec["t_steps"]
    S = spec["s_steps"]
    DS = spec["ds_steps"]
    L = spec["l_steps"]
    NB = lam.NB  # backward action samples per dim
    NF = 21      # forward action samples per dim

    f32 = torch.float32
    dev = torch.device(device)

    def ar(n):
        return torch.arange(n, dtype=f32, device=dev)

    def grids(pp):
        s_step = lam.div_const(pp["s_max"] - pp["s_min"], S - 1)
        ds_step = lam.div_const(pp["ds_max"] - pp["ds_min"], DS - 1)
        l_step = lam.div_const(pp["l_max"] - pp["l_min"], L - 1)
        ss = pp["s_min"] + ar(S) * s_step
        dss = pp["ds_min"] + ar(DS) * ds_step
        lls = pp["l_min"] + ar(L) * l_step
        return ss, dss, lls, s_step, ds_step, l_step

    def mid_from_bounds(foundL, foundR, l_left, l_right, pp):
        l_left = torch.where(foundL, l_left, 0.0)
        l_right = torch.where(foundR, l_right, 0.0)
        mid = l_right + (l_left - l_right) * 0.5
        y = torch.minimum(l_right + pp["d_lat_comf"], mid)
        z = torch.maximum(l_left - pp["d_lat_comf"], mid)
        x = torch.where(pp["l_trg"] < l_right, y,
                        torch.where(pp["l_trg"] > l_left, z, pp["l_trg"]))
        return x, y, z

    # ---- grid-wide getMid (lat_lon_planner.cu:80-117) ----

    def get_mid_grid(D_t, mean_dist, lls, l_step, pp):
        """D_t: (S, L) dist-ahead slice; mean_dist: (S, DS, L).
        Returns (x, y, z) each (S, DS, L)."""
        offs = torch.arange(L, device=dev)
        idxL = torch.clamp(offs[None, :] + offs[:, None], 0, L - 1)
        idxR = torch.clamp(offs[:, None] - offs[None, :], 0, L - 1)

        DL_ = D_t[:, idxL]                      # (S, L, Loff)
        DR_ = D_t[:, idxR]

        condL = DL_[:, None, :, :] < mean_dist[..., None]   # (S,DS,L,Loff)
        condR = DR_[:, None, :, :] < mean_dist[..., None]

        iL = _first_true(condL).to(f32)
        iR = _first_true(condR).to(f32)
        l_g = lls[None, None, :]
        return mid_from_bounds(torch.any(condL, dim=-1),
                               torch.any(condR, dim=-1),
                               l_g + iL * l_step, l_g - iR * l_step, pp)

    def eval_state_grid(t, ss, dss, lls, rl_tex, mid_x, mid_y, mid_z, pp):
        """(lat_lon_planner.cu:119-158). Returns cost, constr (S, DS, L)."""
        s_g = ss[:, None, None]
        ds_g = dss[None, :, None]
        l_g = lls[None, None, :]

        v_max_ref = rl_tex[:, 4][:, None, None]
        d_left_ref = (rl_tex[:, 5] - pp["width_veh"] * 0.5)[:, None, None]
        d_right_ref = -(rl_tex[:, 6] - pp["width_veh"] * 0.5)[:, None, None]

        cost = 1000.0 * torch.clamp(l_g - d_left_ref, min=0.0)
        cost = cost + 1000.0 * torch.clamp(d_right_ref - l_g, min=0.0)

        cost = cost + pp["w_l"] * (mid_x - l_g) ** 2
        cost = cost + torch.where(l_g < mid_y,
                                  pp["w_lat_dist"] * (mid_y - l_g) ** 2,
                                  0.0)
        cost = cost + torch.where(l_g > mid_z,
                                  pp["w_lat_dist"] * (mid_z - l_g) ** 2,
                                  0.0)

        cost = cost + pp["w_progress"] * (1000.0 - s_g)

        vel_viol = ds_g > v_max_ref
        constr = torch.where(vel_viol, ds_g - v_max_ref, 0.0)

        cost = cost + torch.where(
            t < pp["t_st_min"],
            pp["w_spatio_temporal"] * torch.clamp(s_g - pp["s_st"], min=0.0),
            0.0)
        cost = cost + torch.where(
            t > pp["t_st_max"],
            pp["w_spatio_temporal"] * torch.clamp(pp["s_st"] - s_g, min=0.0),
            0.0)

        cost = torch.broadcast_to(cost, (S, DS, L)).contiguous()
        constr = torch.broadcast_to(constr, (S, DS, L)).contiguous()
        return cost, constr

    def slice_state(D_t, t, ref_line, ref_step, pp):
        """State costs of one time slice + the mid-lane grid."""
        ss, dss, lls, _s_step, _ds_step, l_step = grids(pp)
        rl_tex = _ref_tex(ref_line, ref_step, ss)
        mean_dist = torch.clamp(dss[None, :, None] * pp["dt"],
                                min=pp["length_veh"] * 0.5)
        mean_dist = torch.broadcast_to(mean_dist, (S, DS, L))
        mid = get_mid_grid(D_t, mean_dist, lls, l_step, pp)
        cost, constr = eval_state_grid(t, ss, dss, lls, rl_tex, *mid, pp)
        return cost, constr, rl_tex, mid

    # ---- backward slice ----

    def slice_inputs(i, dist_x, ref_line, ref_step, pp):
        """State cost / constr (S, DS, L) and d_fwd (S, L, NB) of
        backward slice i: everything the action-min consumes besides the
        next slice's nodes and the action tables."""
        _ss, _dss, lls, _s_step, _ds_step, l_step = grids(pp)
        dt = pp["dt"]
        t = pp["dt_start"] + float(i - 1) * dt
        D_t = dist_x[min(max(i, 0), T - 1)]                     # (S, L)
        state_cost, state_constr, _, _ = slice_state(
            D_t, t, ref_line, ref_step, pp)

        # d_fwd per (S, L, dl): lateral sweep lookups, cumulative per side
        il2 = torch.clamp(torch.round(
            (lls[:, None] + lam.dl_samples(pp)[None, :] * dt - pp["l_min"])
            / l_step), 0, L - 1).long()                         # (L, NB)
        D_at = D_t[:, il2]                                      # (S, L, NB)
        d_fwd = _d_fwd_sweep(D_at, NB // 2) - pp["length_veh"] * 0.5
        return state_cost, state_constr, d_fwd.contiguous()

    def action_tables(pp):
        _ss, dss, _lls, s_step, ds_step, l_step = grids(pp)
        return lam.make_tables(pp, dss, s_step, ds_step, l_step, DS)

    def backward_slice_reference(nodes_next, i, dist_x, ref_line, ref_step,
                                 pp, tables):
        """Backward slice i from the next slice's nodes, as tensor
        operations: the plain version of :func:`backward_slice`."""
        return lam.action_min_reference(
            nodes_next, *slice_inputs(i, dist_x, ref_line, ref_step, pp),
            tables)

    def backward_slice_batch_reference(nodes_next, i, dist_x, ref_lines,
                                       ref_step, pps, tables):
        """Backward slice i of a scenario batch (nodes_next (B, S, DS, L,
        4), dist_x (B, T, S, L), ref_lines (B, n, 8), ``pps`` the B
        scenarios' param dicts, ``tables`` a ``BatchTables``): the plain
        version of :func:`backward_slice_batch`, the per-scenario plain
        slice stacked."""
        return torch.stack([
            backward_slice_reference(nodes_next[b], i, dist_x[b],
                                     ref_lines[b], ref_step, pps[b],
                                     tables.tables[b])
            for b in range(len(pps))])

    def backward_slice_batch(nodes_next, i, dist_x, ref_lines, ref_step, pps,
                             tables):
        """Backward slice i (B, S, DS, L, 4) of a scenario batch: one launch
        of the fused kernel for the whole batch on a CUDA device
        (``latlon_action_min.backward_slice_launch``), the plain version on
        the CPU."""
        if nodes_next.device.type == "cpu":
            return backward_slice_batch_reference(
                nodes_next, i, dist_x, ref_lines, ref_step, pps, tables)
        return lam.backward_slice_launch(
            nodes_next, dist_x[:, min(max(i, 0), T - 1)], ref_lines, ref_step,
            i, tables)

    def backward_slice(nodes_next, i, dist_x, ref_line, ref_step, pp,
                       tables):
        """Backward slice i (S, DS, L, 4) from the next slice's nodes: one
        launch of the fused kernel on a CUDA device
        (``latlon_action_min.backward_slice_launch``), the plain version on
        the CPU."""
        if nodes_next.device.type == "cpu":
            return backward_slice_reference(nodes_next, i, dist_x, ref_line,
                                            ref_step, pp, tables)
        return lam.backward_slice_launch(
            nodes_next[None], dist_x[min(max(i, 0), T - 1)][None],
            ref_line[None], ref_step, i, tables)[0]

    def final_slice(dist_x, ref_line, ref_step, pp):
        """Slice T-1: state cost + finalState (lat_lon_planner.cu:66-78)."""
        _ss, _dss, lls, _s_step, _ds_step, _l_step = grids(pp)
        t = pp["dt_start"] + float(T - 2) * pp["dt"]
        state_cost, state_constr, rl_tex, mid = slice_state(
            dist_x[T - 1], t, ref_line, ref_step, pp)

        on_xing = (torch.round(rl_tex[:, 7]) == 1.0)[:, None, None]
        fin_cost = torch.where(on_xing, pp["w_xing_slow"], 0.0)
        fin_cost = fin_cost + pp["w_l"] * (mid[0] - lls[None, None, :]) ** 2

        z = torch.zeros((S, DS, L), dtype=f32, device=dev)
        return torch.stack([state_cost + fin_cost,
                            state_constr + torch.zeros_like(state_constr),
                            z, z], dim=-1)

    # ---- single-state evaluation (forward pass, reeval) ----

    def trilerp(nodes, s, ds, l, pp, s_step, ds_step, l_step):
        """Manual trilinear interp of (S, DS, L, 4) at continuous coords."""
        x = torch.clamp((s - pp["s_min"]) / s_step, 0.0, S - 1.0)
        y = torch.clamp((ds - pp["ds_min"]) / ds_step, 0.0, DS - 1.0)
        z = torch.clamp((l - pp["l_min"]) / l_step, 0.0, L - 1.0)
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        z0 = torch.floor(z).long()
        x1 = torch.clamp(x0 + 1, max=S - 1)
        y1 = torch.clamp(y0 + 1, max=DS - 1)
        z1 = torch.clamp(z0 + 1, max=L - 1)
        ax = (x - x0)[..., None]
        ay = (y - y0)[..., None]
        az = (z - z0)[..., None]

        c000 = nodes[x0, y0, z0]
        c100 = nodes[x1, y0, z0]
        c010 = nodes[x0, y1, z0]
        c110 = nodes[x1, y1, z0]
        c001 = nodes[x0, y0, z1]
        c101 = nodes[x1, y0, z1]
        c011 = nodes[x0, y1, z1]
        c111 = nodes[x1, y1, z1]
        c00 = c000 * (1 - ax) + c100 * ax
        c10 = c010 * (1 - ax) + c110 * ax
        c01 = c001 * (1 - ax) + c101 * ax
        c11 = c011 * (1 - ax) + c111 * ax
        c0 = c00 * (1 - ay) + c10 * ay
        c1 = c01 * (1 - ay) + c11 * ay
        return c0 * (1 - az) + c1 * az

    def get_mid_points(dist_x, t_idx, s_idx, l, mean_dist, pp, l_step):
        """getMid for N single states. All args (N,); returns (N,) x3."""
        offs = ar(L)
        lL = l[:, None] + offs[None, :] * l_step                 # (N, L)
        lR = l[:, None] - offs[None, :] * l_step
        ilL = torch.clamp(torch.round((lL - pp["l_min"]) / l_step),
                          0, L - 1).long()
        ilR = torch.clamp(torch.round((lR - pp["l_min"]) / l_step),
                          0, L - 1).long()
        DL_ = dist_x[t_idx[:, None], s_idx[:, None], ilL]
        DR_ = dist_x[t_idx[:, None], s_idx[:, None], ilR]
        condL = DL_ < mean_dist[:, None]
        condR = DR_ < mean_dist[:, None]
        l_left = torch.gather(lL, 1, _first_true(condL)[:, None])[:, 0]
        l_right = torch.gather(lR, 1, _first_true(condR)[:, None])[:, 0]
        return mid_from_bounds(torch.any(condL, dim=-1),
                               torch.any(condR, dim=-1), l_left, l_right, pp)

    def eval_state_points(tp, rl_row, mid, pp):
        """tp (N, 12), rl_row (N, 8). Returns cost, constr, flags (N,)."""
        s, ds, l, t = tp[:, C_S], tp[:, C_DS], tp[:, C_L], tp[:, C_T]
        mid_x, mid_y, mid_z = mid
        v_max_ref = rl_row[:, 4]
        d_left_ref = rl_row[:, 5] - pp["width_veh"] * 0.5
        d_right_ref = -(rl_row[:, 6] - pp["width_veh"] * 0.5)

        cost = 1000.0 * torch.clamp(l - d_left_ref, min=0.0)
        cost = cost + 1000.0 * torch.clamp(d_right_ref - l, min=0.0)
        cost = cost + pp["w_l"] * (mid_x - l) ** 2
        cost = cost + torch.where(l < mid_y,
                                  pp["w_lat_dist"] * (mid_y - l) ** 2, 0.0)
        cost = cost + torch.where(l > mid_z,
                                  pp["w_lat_dist"] * (mid_z - l) ** 2, 0.0)
        cost = cost + pp["w_progress"] * (1000.0 - s)

        vel_viol = ds > v_max_ref
        constr = torch.where(vel_viol, ds - v_max_ref, 0.0)
        flags = vel_viol.to(torch.int32) * CONSTR_VELOCITY

        cost = cost + torch.where(
            t < pp["t_st_min"],
            pp["w_spatio_temporal"] * torch.clamp(s - pp["s_st"], min=0.0),
            0.0)
        cost = cost + torch.where(
            t > pp["t_st_max"],
            pp["w_spatio_temporal"] * torch.clamp(pp["s_st"] - s, min=0.0),
            0.0)
        return cost, constr, flags

    def t_index(t, pp):
        t_idx = torch.where(t < pp["dt_start"], 0.0,
                            torch.round((t - pp["dt_start"]) / pp["dt"])
                            + 1.0).to(torch.int32)
        return torch.clamp(t_idx, 0, T - 1).long()

    def s_index(s, pp, s_step):
        return torch.clamp(torch.round((s - pp["s_min"]) / s_step),
                           0, S - 1).long()

    # ---- forward pass (single state per step, NFxNF interp actions) ----

    def forward_step(tp, nodes_next, dist_x, ref_line, ref_step, pp, dt,
                     is_last):
        _ss, _dss, _lls, s_step, ds_step, l_step = grids(pp)
        s, ds, l = tp[C_S], tp[C_DS], tp[C_L]

        t_idx = t_index(tp[C_T:C_T + 1], pp)                      # (1,)
        s_idx = s_index(tp[C_S:C_S + 1], pp, s_step)              # (1,)
        rl_row = _ref_tex(ref_line, ref_step, tp[C_S:C_S + 1])    # (1, 8)

        mean_dist = torch.clamp(ds * dt, min=pp["length_veh"] * 0.5)
        mid = get_mid_points(dist_x, t_idx, s_idx, tp[C_L:C_L + 1],
                             mean_dist[None], pp, l_step)
        st_cost, st_constr, st_flags = (
            v[0] for v in eval_state_points(tp[None], rl_row, mid, pp))

        # action search: NF x NF with trilinear value lookup
        n2 = NF // 2
        dds_s = pp["dds_min"] + lam.div_const(
            (pp["dds_max"] - pp["dds_min"]) * ar(NF), NF - 1)
        step_dl = lam.div_const(pp["dl_max"] - pp["dl_min"], NF - 1)
        kk = torch.arange(1, n2 + 1, dtype=f32, device=dev)
        dl_s = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                          step_dl * kk, -step_dl * kk])

        il2 = torch.clamp(torch.round((l + dl_s * dt - pp["l_min"])
                                      / l_step), 0, L - 1).long()
        D_at = dist_x[t_idx, s_idx, il2]                          # (NF,)
        d_fwd = _d_fwd_sweep(D_at, n2) - pp["length_veh"] * 0.5   # (NF,)
        d_safety = d_fwd - pp["gap_min"] - ds * pp["time_gap"]

        s_change = torch.clamp(ds * dt + 0.5 * dds_s * dt * dt, min=0.0)
        sn = s + s_change
        dsn = torch.clamp(ds + dds_s * dt, min=0.0)
        ln = l + dl_s * dt

        nn = trilerp(nodes_next,
                     torch.broadcast_to(sn[:, None], (NF, NF)),
                     torch.broadcast_to(dsn[:, None], (NF, NF)),
                     torch.broadcast_to(ln[None, :], (NF, NF)),
                     pp, s_step, ds_step, l_step)                 # (NF,NF,4)
        cost_next = nn[..., 0]
        constr_next = nn[..., 1]
        tn_dds = nn[..., 2]
        tn_dl = nn[..., 3]

        l_change = dl_s * dt
        slope = torch.abs(l_change[None, :] / s_change[:, None])
        angle_c = torch.where(slope > pp["slope_abs_max"],
                              torch.abs(slope - pp["slope_abs_max"]) * 1000.0,
                              0.0)
        angle_c = torch.nan_to_num(angle_c, nan=0.0)
        occ_c = torch.clamp(s_change[:, None] - d_fwd[None, :], min=0.0)
        constr_a = angle_c + occ_c
        constr_all = constr_a + constr_next

        cost_a = pp["w_safety_dist"] * torch.clamp(
            s_change[:, None] - d_safety[None, :], min=0.0)
        cost_a = cost_a + pp["w_dds"] * (dds_s[:, None] * dt) ** 2
        cost_a = cost_a + pp["w_ddds"] * (tn_dds - dds_s[:, None]) ** 2
        cost_a = cost_a + pp["w_dl"] * (dl_s[None, :] * dt) ** 2
        cost_a = cost_a + pp["w_ddl"] * (tn_dl - dl_s[None, :]) ** 2
        cost_all = cost_a + cost_next

        cost_o = cost_all.T.reshape(-1)      # dl outer, dds inner
        constr_o = constr_all.T.reshape(-1)
        cmin = torch.amin(constr_o)
        cost_m = torch.where(constr_o == cmin, cost_o,
                             float("inf"))
        aidx = torch.argmin(cost_m)
        dds_best = _take(dds_s, aidx % NF)
        dl_best = _take(dl_s, aidx // NF)

        tp = tp.clone()
        if is_last:
            tp[C_COST] = st_cost
            tp[C_CONSTR] = st_constr
            tp[C_FLAGS] = st_flags.to(f32)
        else:
            a_cost = _take(cost_a.T.reshape(-1), aidx)
            a_constr = _take(constr_a.T.reshape(-1), aidx)
            a_flags = ((_take(angle_c.T.reshape(-1), aidx) > 0)
                       .to(torch.int32) * CONSTR_ANGLE
                       | (_take(occ_c.T.reshape(-1), aidx) > 0)
                       .to(torch.int32) * CONSTR_OCCUPANCY)
            tp[C_COST] = st_cost + a_cost
            tp[C_CONSTR] = st_constr + a_constr
            tp[C_FLAGS] = (st_flags | a_flags).to(f32)
            tp[C_DDS] = dds_best
            tp[C_DL] = dl_best

        # next state (dynamics, lat_lon_planner.cu:10-21)
        tn = torch.zeros_like(tp)
        tn[C_T] = tp[C_T] + dt
        tn[C_S] = torch.maximum(s, s + ds * dt + 0.5 * dds_best * dt * dt)
        tn[C_DS] = torch.clamp(ds + dds_best * dt, min=0.0)
        tn[C_DDS] = dds_best
        tn[C_L] = l + dl_best * dt
        tn[C_DL] = dl_best
        return tp, tn

    def f32_on_dev(v):
        if isinstance(v, np.ndarray):
            v = np.require(v, requirements="W")    # torch wants writable
        return torch.as_tensor(v, dtype=f32, device=dev)

    def _inputs(dist_map_lon, ref_line, ref_step, pp):
        if not isinstance(pp, dict):
            pp = unpack_pp(f32_on_dev(pp))
        pp = {k: f32_on_dev(v) for k, v in pp.items()}
        dist_x = f32_on_dev(dist_map_lon)[..., 0].contiguous()
        return dist_x, f32_on_dev(ref_line), f32_on_dev(ref_step), pp

    def forward(nodes, dist_x, ref_line, ref_step, pp, x0):
        """The forward pass of one scenario: (T, 12) from its nodes."""
        tp = x0
        traj = []
        for i in range(T):
            dt_i = pp["dt_start"] if i == 0 else pp["dt"]
            tp_out, tp = forward_step(tp, nodes[min(i + 1, T - 1)], dist_x,
                                      ref_line, ref_step, pp, dt_i,
                                      i == T - 1)
            traj.append(tp_out)
        return torch.stack(traj)

    def solve(dist_map_lon, ref_line, ref_step, pp, x0):
        dist_x, ref_line, ref_step, pp = _inputs(dist_map_lon, ref_line,
                                                 ref_step, pp)
        x0 = f32_on_dev(x0)

        # backward pass: slice T-1 (final), then T-2 .. 1
        tables = action_tables(pp)
        slices = [final_slice(dist_x, ref_line, ref_step, pp)]
        for i in range(T - 2, 0, -1):
            slices.append(backward_slice(slices[-1], i, dist_x, ref_line,
                                         ref_step, pp, tables))
        slices.append(torch.zeros((S, DS, L, 4), dtype=f32, device=dev))
        nodes = torch.stack(slices[::-1])             # (T, S, DS, L, 4)
        return nodes, forward(nodes, dist_x, ref_line, ref_step, pp, x0)

    def batch_inputs(dist_maps, ref_lines, ref_step, pps):
        """:func:`solve.batch`'s inputs on the device: dist_x (B, T, S, L),
        ref_lines (B, n, 8), ref_step, the B scenarios' param dicts."""
        if isinstance(pps, dict):
            cols = {k: f32_on_dev(v).reshape(-1) for k, v in pps.items()}
        else:
            packed = f32_on_dev(pps)
            if packed.dim() != 2 or packed.shape[1] != len(PP_KEYS):
                raise ValueError(f"packed params must be (B, {len(PP_KEYS)})"
                                 f", got {tuple(packed.shape)}")
            cols = {k: packed[:, j] for j, k in enumerate(PP_KEYS)}
        dist_x = f32_on_dev(dist_maps)[..., 0].contiguous()
        if isinstance(ref_lines, (list, tuple)):
            if len({len(r) for r in ref_lines}) != 1:
                raise ValueError("the batch's reference lines must have one "
                                 "row count")
            ref_lines = torch.stack([f32_on_dev(r) for r in ref_lines])
        ref_lines = f32_on_dev(ref_lines).contiguous()
        B = dist_x.shape[0]
        if dist_x.shape[1:] != (T, S, L) or ref_lines.dim() != 3 \
                or ref_lines.shape[0] != B:
            raise ValueError(f"dist_maps (B, {T}, {S}, {L}, 2) and ref_lines"
                             f" (B, n, 8), got {tuple(dist_maps.shape)} and "
                             f"{tuple(ref_lines.shape)}")
        if any(v.shape != (B,) for v in cols.values()):
            raise ValueError(f"every param needs one value per scenario "
                             f"({B})")
        pps = [{k: v[b] for k, v in cols.items()} for b in range(B)]
        return dist_x, ref_lines, f32_on_dev(ref_step), pps

    def solve_batch(dist_maps, ref_lines, ref_step, pps, x0s):
        dist_x, ref_lines, ref_step, pps = batch_inputs(dist_maps, ref_lines,
                                                        ref_step, pps)
        x0s = f32_on_dev(x0s)
        B = dist_x.shape[0]

        tables = lam.BatchTables([action_tables(pp) for pp in pps])
        slices = [torch.stack([
            final_slice(dist_x[b], ref_lines[b], ref_step, pps[b])
            for b in range(B)])]
        for i in range(T - 2, 0, -1):
            slices.append(backward_slice_batch(slices[-1], i, dist_x,
                                               ref_lines, ref_step, pps,
                                               tables))
        slices.append(torch.zeros((B, S, DS, L, 4), dtype=f32, device=dev))
        nodes = torch.stack(slices[::-1], dim=1)      # (B, T, S, DS, L, 4)
        trajs = torch.stack([
            forward(nodes[b], dist_x[b], ref_lines[b], ref_step, pps[b],
                    x0s[b]) for b in range(B)])
        return nodes, trajs

    def reeval(dist_map_lon, ref_line, ref_step, pp, traj):
        """Re-evaluate a stored trajectory against a fresh environment on
        the device (reference: lat_lon_planner.cu:358-402 reevalTraj)."""
        dist_x, ref_line, ref_step, pp = _inputs(dist_map_lon, ref_line,
                                                 ref_step, pp)
        traj = f32_on_dev(traj)

        _, _, _, s_step, _ds_step, l_step = grids(pp)
        N = traj.shape[0]
        t = traj[:, C_T]
        s = traj[:, C_S]
        ds = traj[:, C_DS]
        l = traj[:, C_L]
        dl = traj[:, C_DL]
        dds = traj[:, C_DDS]

        last = torch.arange(N, device=dev) == N - 1
        dt = torch.where(last, 0.0, torch.roll(t, -1) - t)

        t_idx = t_index(t, pp)
        s_idx = s_index(s, pp, s_step)
        rl_rows = _ref_tex(ref_line, ref_step, s)                 # (N, 8)

        mean_dist = torch.clamp(ds * dt, min=pp["length_veh"] * 0.5)
        mid = get_mid_points(dist_x, t_idx, s_idx, l, mean_dist, pp, l_step)
        st_cost, st_constr, st_flags = eval_state_points(traj, rl_rows, mid,
                                                         pp)

        # lateral sweep toward l + dt * dl (HostEval.reeval)
        l_dist = dl * dt
        steps = torch.ceil(torch.abs(l_dist) / l_step)
        n_sweep = torch.clamp(steps, min=1.0)
        step_size = torch.where(steps > 0,
                                l_dist / torch.clamp(steps, min=1.0), 0.0)
        ks = ar(L)                                                # (L,)
        l_k = l[:, None] + ks[None, :] * step_size[:, None]       # (N, L)
        il_k = torch.clamp(torch.round((l_k - pp["l_min"]) / l_step),
                           0, L - 1).long()
        d_k = dist_x[t_idx[:, None], s_idx[:, None], il_k]        # (N, L)
        d_k = torch.where(ks[None, :] < n_sweep[:, None], d_k,
                          float("inf"))
        d_fwd = torch.amin(d_k, dim=1) - pp["length_veh"] * 0.5
        d_safety = d_fwd - pp["gap_min"] - ds * pp["time_gap"]

        # pairwise terms vs the next node (zeroed on the last node)
        s_change = torch.roll(s, -1) - s
        l_change = torch.roll(l, -1) - l
        slope = torch.abs(l_change / s_change)
        angle_viol = torch.isfinite(slope) & (slope > pp["slope_abs_max"]) \
            & ~last
        constr = st_constr
        constr = constr + torch.where(
            angle_viol, torch.abs(slope - pp["slope_abs_max"]) * 1000.0, 0.0)
        occ_viol = (s_change > d_fwd) & ~last
        constr = constr + torch.where(occ_viol, s_change - d_fwd, 0.0)

        cost = st_cost
        cost = cost + torch.where(
            last, 0.0,
            pp["w_safety_dist"] * torch.clamp(s_change - d_safety, min=0.0))
        ddds = torch.roll(dds, -1) - dds
        ddl = torch.roll(dl, -1) - dl
        pair_cost = (pp["w_dds"] * (dds * dt) ** 2
                     + pp["w_ddds"] * ddds ** 2
                     + pp["w_dl"] * (dl * dt) ** 2
                     + pp["w_ddl"] * ddl ** 2)
        cost = cost + torch.where(last, 0.0, pair_cost)

        flags = (st_flags
                 | angle_viol.to(torch.int32) * CONSTR_ANGLE
                 | occ_viol.to(torch.int32) * CONSTR_OCCUPANCY)

        traj = traj.clone()
        traj[:, C_COST] = cost
        traj[:, C_CONSTR] = constr
        traj[:, C_FLAGS] = flags.to(f32)
        return traj

    # stage access for kernel checks: prepare() converts solve's inputs,
    # final_slice(...) is slice T-1, slice_inputs(i, ...) and
    # action_tables(pp) are what action_min takes for slice i,
    # backward_slice(...) is what solve runs per slice (the fused kernel on
    # a CUDA device) and backward_slice_reference(...) its plain version;
    # batch_inputs() converts solve.batch's inputs, backward_slice_batch(...)
    # is what it runs per slice and backward_slice_batch_reference(...) its
    # plain version; spec and device rebuild the solver elsewhere
    solve.prepare = _inputs
    solve.spec = dict(spec)
    solve.device = dev
    solve.batch = solve_batch
    solve.batch_inputs = batch_inputs
    solve.backward_slice_batch = backward_slice_batch
    solve.backward_slice_batch_reference = backward_slice_batch_reference
    solve.final_slice = final_slice
    solve.slice_inputs = slice_inputs
    solve.action_tables = action_tables
    solve.backward_slice = backward_slice
    solve.backward_slice_reference = backward_slice_reference
    return solve, reeval


def make_latlon_replan(spec, device):
    """Env-build + DP solve chained on the device with no host sync in
    between; the caller pulls only the (T, 12) trajectory.

    Returns (replan, solve, reeval); replan(*env_inputs, ppv, x0) ->
    (occ_map, dist_map_lon, traj) with env_inputs from
    DpEnvironment.device_inputs().
    """
    from tpl_tpu_torch.planning.dyn_prog import dp_environment as dpe

    solve, reeval = make_latlon_solver(spec, device)
    T, S, L = spec["t_steps"], spec["s_steps"], spec["l_steps"]

    def replan(ref_line, ref_step, quads, tbit, stat, valid, dilation,
               s_min, s_step, l_min, l_step, ppv, x0):
        occ, dist_lon = dpe._build_grids(
            ref_line, ref_step, quads, tbit, stat, valid, dilation,
            s_min, s_step, l_min, l_step, T, S, L)
        _, traj = solve(dist_lon, ref_line, ref_step, ppv, x0)
        return occ, dist_lon, traj

    return replan, solve, reeval


# ---------------------------------------------------------------------
# Host-side evaluator for trajectory re-evaluation against a fresh
# environment (reference: lat_lon_planner.cu:358-402 reevalTraj) and the
# smoothing / cartesian post-processing (lat_lon_planner.cu:645-825).
# ---------------------------------------------------------------------

class HostEval:
    """Numpy twin of the device evaluator over pulled grids (numpy arrays,
    or tensors moved to the host): the host oracle of the solver's
    ``reeval`` (``make_latlon_solver``)."""

    def __init__(self, dist_map_lon, ref_line, ref_step, params):
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
                np.asarray(a)
        self.dist_x = host(dist_map_lon)[..., 0]
        self.ref_line = host(ref_line)
        self.ref_step = ref_step
        self.p = params

    def t_index(self, t):
        p = self.p
        if t < p.dt_start:
            return 0
        return int(min(self.dist_x.shape[0] - 1,
                       round((t - p.dt_start) / p.dt) + 1))

    def ref_tex(self, s):
        i = int(np.clip(round(s / self.ref_step), 0, len(self.ref_line) - 1))
        return self.ref_line[i]

    def dist(self, t, s, l):
        p = self.p
        S = self.dist_x.shape[1]
        L = self.dist_x.shape[2]
        si = int(np.clip(round((s - p.s_min) / p.s_step), 0, S - 1))
        li = int(np.clip(round((l - p.l_min) / p.l_step), 0, L - 1))
        return self.dist_x[self.t_index(t), si, li]

    def get_mid(self, t, s, l, ds, dt):
        p = self.p
        L = self.dist_x.shape[2]
        mean_dist = max(p.length_veh * 0.5, ds * dt)
        l_left = 0.0
        l_right = 0.0
        for i in range(L):
            if self.dist(t, s, l + i * p.l_step) < mean_dist:
                l_left = l + i * p.l_step
                break
        for i in range(L):
            if self.dist(t, s, l - i * p.l_step) < mean_dist:
                l_right = l - i * p.l_step
                break
        mid = l_right + (l_left - l_right) * 0.5
        y = min(l_right + p.d_lat_comf, mid)
        z = max(l_left - p.d_lat_comf, mid)
        if p.l_trg < l_right:
            x = y
        elif p.l_trg > l_left:
            x = z
        else:
            x = p.l_trg
        return x, y, z, l_left, l_right

    def eval_state(self, tp, dt):
        p = self.p
        t, s, ds, l = tp[C_T], tp[C_S], tp[C_DS], tp[C_L]
        rl = self.ref_tex(s)
        cost = 0.0
        constr = 0.0
        flags = 0

        d_left_ref = rl[5] - p.width_veh * 0.5
        d_right_ref = -(rl[6] - p.width_veh * 0.5)
        cost += 1000.0 * max(0.0, l - d_left_ref)
        cost += 1000.0 * max(0.0, d_right_ref - l)

        mid_x, mid_y, mid_z, _, _ = self.get_mid(t, s, l, ds, dt)
        cost += p.w_l * (mid_x - l) ** 2
        if l < mid_y:
            cost += p.w_lat_dist * (mid_y - l) ** 2
        if l > mid_z:
            cost += p.w_lat_dist * (mid_z - l) ** 2

        cost += p.w_progress * (1000.0 - s)

        if ds > rl[4]:
            constr += ds - rl[4]
            flags |= CONSTR_VELOCITY

        if t < p.t_st_min:
            cost += p.w_spatio_temporal * max(0.0, s - p.s_st)
        if t > p.t_st_max:
            cost += p.w_spatio_temporal * max(0.0, p.s_st - s)
        return cost, constr, flags

    def reeval(self, traj):
        """traj: (N, 12) numpy; returns re-evaluated copy.
        (lat_lon_planner.cu:358-402)"""
        p = self.p
        traj = np.array(traj, dtype=np.float64)
        n = len(traj)
        for i in range(n):
            tp = traj[i]
            dt = 0.0 if i == n - 1 else traj[i + 1][C_T] - tp[C_T]
            cost, constr, flags = self.eval_state(tp, dt)

            l_next = tp[C_L] + dt * tp[C_DL]
            l_dist = l_next - tp[C_L]
            steps = int(np.ceil(abs(l_dist) / p.l_step))
            d_fwd = self.dist(tp[C_T], tp[C_S], tp[C_L])
            if steps > 0:
                step_size = l_dist / steps
                for k in range(steps):
                    d_fwd = min(d_fwd, self.dist(
                        tp[C_T], tp[C_S], tp[C_L] + k * step_size))
            d_fwd -= p.length_veh * 0.5
            d_safety = d_fwd - p.gap_min - tp[C_DS] * p.time_gap

            if i < n - 1:
                tn = traj[i + 1]
                s_change = tn[C_S] - tp[C_S]
                l_change = tn[C_L] - tp[C_L]
                with np.errstate(divide="ignore", invalid="ignore"):
                    slope = abs(l_change / s_change)
                if np.isfinite(slope) and slope > p.slope_abs_max:
                    constr += abs(slope - p.slope_abs_max) * 1000.0
                    flags |= CONSTR_ANGLE
                if s_change > d_fwd:
                    constr += s_change - d_fwd
                    flags |= CONSTR_OCCUPANCY
                cost += p.w_safety_dist * max(0.0, s_change - d_safety)
                ddds = tn[C_DDS] - tp[C_DDS]
                ddl = tn[C_DL] - tp[C_DL]
                cost += p.w_dds * (tp[C_DDS] * dt) ** 2
                cost += p.w_ddds * ddds ** 2
                cost += p.w_dl * (tp[C_DL] * dt) ** 2
                cost += p.w_ddl * ddl ** 2

            traj[i][C_COST] = cost
            traj[i][C_CONSTR] = constr
            traj[i][C_FLAGS] = float(flags)
        return traj
