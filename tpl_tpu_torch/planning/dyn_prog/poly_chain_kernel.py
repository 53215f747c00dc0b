"""
The device replan chain of the PolyLatDpLonPlanner (FAS-2025 family) and
the lattice planner: per replan,

  1. env grid build          (dp_environment._build_grids, tensor ops)
  2. lateral stage: candidate sweep and sequential best-path selection
     (one kernel launch; the selection the exact twin of the host
     ``select_path``) -> winner expansion -> near-path splice with the previous lateral
     trajectory -> resampling into the lon planner's path ->
     curvature-limited velocity profile -> jerk-limited ramp (kernel)
  3. longitudinal stage: projection of the previous trajectory point ->
     path distance map -> lon DP solve (T - 1 backward-slice launches and
     one forward-pass launch)

with one upload of the replan's host inputs and one download of its
results at the end.  (reference: library/src/dyn_prog/
poly_lat_planner.cu:365-440 update + lon_planner.cu:328 updateTraj; the
JAX package's form is tpl_tpu/planning/dyn_prog/poly_chain_kernel.py)

On CPU tensors every kernel entry runs its plain PyTorch version.  The glue
between the kernels stays tensor operations: the winner expansion, the
splice, the resampling, the curvature limit, the projection, the path
resample and the distance map.
"""

import warnings

import numpy as np
import torch

from tpl_tpu_torch.ops.interp import short_angle_dist_t
from tpl_tpu_torch.ops.jgeometry import project_polyline
from tpl_tpu_torch.ops.splines import PolyQuintic
from tpl_tpu_torch.planning.dyn_prog import dp_environment as dpe
from tpl_tpu_torch.planning.dyn_prog import lon_kernel as lk
from tpl_tpu_torch.planning.dyn_prog import poly_lat_kernel as plk
from tpl_tpu_torch.planning.dyn_prog.latlon_action_min import div_const
from tpl_tpu_torch.planning.dyn_prog.lon_kernel import (
    LC_S, PC_K, PC_VMAX, PC_S, PC_L, LON_PP_KEYS, axis_points, unpack_lon_pp,
)
from tpl_tpu_torch.planning.dyn_prog.poly_lat_kernel import (
    PL_PP_KEYS, ENV_PP_KEYS,
    TC_T, TC_L, TC_DL, TC_DDL, TC_DDDL, TC_S, TC_V, TC_X, TC_Y, TC_H,
    TC_DIST, TC_K,
)
from tpl_tpu_torch.planning.path_vel_decomp import rstp_rampify

f32 = torch.float32

# capacity for the spliced previous-trajectory prefix (points with
# s < splice station); the station is dist_path_fix_min + dist_path_fix
# * v <= ~41 m at ~1 m spacing, so 128 rows is ample headroom.  Kept as
# in the JAX package (a longer prefix keeps its last KEEP_CAP rows); the
# first cut warns once per process (:func:`splice_prefix`).
KEEP_CAP = 128
_warned_keep_cap = False

PATH_COLS = (TC_X, TC_Y, TC_S, TC_L, TC_K, TC_V, TC_DIST)


def splice_prefix(points, s0, x_off, y_off):
    """The splice prefix of a replan: the previous lateral trajectory's
    points below the station ``s0`` (the predicate of
    ``PolyLatTraj.insert_after_station``), the last KEEP_CAP of them, in the
    env's offset frame.  Returns ((KEEP_CAP, 12) float32, n_keep)."""
    global _warned_keep_cap
    old_pts = np.zeros((KEEP_CAP, 12), np.float32)
    if points is None:
        return old_pts, 0
    keep = points[points[:, TC_S] < s0]
    if len(keep) > KEEP_CAP:
        if not _warned_keep_cap:
            _warned_keep_cap = True
            warnings.warn(f"poly chain: the splice prefix has {len(keep)} "
                          f"rows, only the last KEEP_CAP={KEEP_CAP} are kept "
                          "(as in the JAX package)", RuntimeWarning,
                          stacklevel=2)
        keep = keep[-KEEP_CAP:]
    kp = keep.astype(np.float32)
    kp[:, TC_X] -= x_off
    kp[:, TC_Y] -= y_off
    old_pts[:len(keep)] = kp
    return old_pts, len(keep)


def _lerp_xs_dev(x, dx, ys, angle=False):
    """Device twin of ops.interp.lerp_xs over an equally spaced grid
    starting at 0: floor index clamped to [0, n-2], UNclamped alpha
    (linear extrapolation beyond the grid, like the host expansion)."""
    n = ys.shape[0]
    q = x / dx
    i0f = torch.clamp(torch.floor(q), 0, n - 2)
    i1 = torch.clamp(torch.ceil(q), 0, n - 1).long()
    a = q - i0f
    i0 = i0f.long()
    if angle:
        return ys[i0] + short_angle_dist_t(ys[i0], ys[i1]) * a
    return ys[i0] * (1.0 - a) + ys[i1] * a


def _expand_winner(il, isd, start, ref_line, ref_step, pp, s_steps,
                   l_dst_steps, s_dst_steps):
    """Winner expansion into (S, 12) float32 lateral trajectory points, in
    the env's offset frame (device twin of PolyLatPlanner.update's host
    expansion; reference: poly_lat_planner.cu:440-485)."""
    S = s_steps
    dev = ref_line.device
    l0, dl0, ddl0, s0 = start[0], start[1], start[2], start[3]

    l_dst = axis_points(pp["l_dst_min"], pp["l_dst_max"], il.to(f32),
                        max(l_dst_steps - 1, 1))
    s_dst = axis_points(pp["s_dst_min"], pp["s_dst_max"], isd.to(f32),
                        max(s_dst_steps - 1, 1))

    zero = torch.zeros((), dtype=f32, device=dev)
    poly = PolyQuintic(s0, l0, dl0, ddl0, s0 + s_dst, l_dst, zero, zero)
    ss = plk.sample_stations(pp, s0, S)

    past = ss >= s0 + s_dst
    # the float64 Hermite inverse promotes the quintic; pinned to float32
    l = torch.where(past, l_dst, poly.f(ss)).to(f32)
    dl = torch.where(past, zero, poly.df(ss)).to(f32)
    ddl = torch.where(past, zero, poly.ddf(ss)).to(f32)
    dddl = torch.where(past, zero, poly.dddf(ss)).to(f32)

    rp_x = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_X])
    rp_y = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_Y])
    rp_h = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_H], angle=True)
    rp_v = _lerp_xs_dev(ss, ref_step, ref_line[:, dpe.RL_V])

    pts = torch.zeros((S, 12), dtype=f32, device=dev)
    pts[:, TC_S] = ss
    pts[:, TC_L] = l
    pts[:, TC_DL] = dl
    pts[:, TC_DDL] = ddl
    pts[:, TC_DDDL] = dddl
    pts[:, TC_X] = rp_x - torch.sin(rp_h) * l
    pts[:, TC_Y] = rp_y + torch.cos(rp_h) * l
    pts[:, TC_H] = torch.atan(dl) + rp_h
    pts[:, TC_V] = rp_v
    return pts


def _merge_and_time(old_pts, n_keep, new_pts):
    """Near-path splice: rows [0:n_keep] of the previous lateral
    trajectory followed by the freshly expanded points, then the masked
    twin of PolyLatTraj.update_time_dist_curv (reference:
    poly_lat_planner.cu:297-333).  Invalid tail rows get +inf DIST so the
    downstream distance-keyed resampling never selects them.  ``n_keep``
    is a host integer."""
    KP = old_pts.shape[0]
    S = new_pts.shape[0]
    M = KP + S
    dev = new_pts.device
    idx = torch.arange(M, device=dev)
    valid = idx < n_keep + S
    old_idx = torch.clamp(idx, 0, KP - 1)
    new_idx = torch.clamp(idx - n_keep, 0, S - 1)
    merged = torch.where((idx < n_keep)[:, None], old_pts[old_idx],
                         new_pts[new_idx])

    last_valid = n_keep + S - 1
    # treat the last VALID row as its own successor (diffs become 0)
    nxt = torch.clamp(torch.clamp(idx + 1, 0, M - 1), max=last_valid)
    cur = torch.clamp(idx, max=last_valid)
    p_cur = merged[cur]
    p_nxt = merged[nxt]

    dx = p_nxt[:, TC_X] - p_cur[:, TC_X]
    dy = p_nxt[:, TC_Y] - p_cur[:, TC_Y]
    d = torch.hypot(dx, dy)
    k = short_angle_dist_t(p_cur[:, TC_H], p_nxt[:, TC_H]) \
        / torch.clamp(d, min=1e-9)
    # last row copies its predecessor's curvature (host twin)
    prv = torch.clamp(idx - 1, 0, M - 1)
    k = torch.where(idx == last_valid, k[prv], k)
    zero = torch.zeros((), dtype=f32, device=dev)
    merged[:, TC_K] = torch.where(valid, k, zero)

    seg = torch.where(idx < last_valid, d, zero)
    dist = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                      torch.cumsum(seg, 0)[:-1]])
    dt_seg = torch.where(idx < last_valid,
                         d / torch.clamp(p_cur[:, TC_V], min=1e-9), zero)
    t = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                   torch.cumsum(dt_seg, 0)[:-1]])
    merged[:, TC_DIST] = torch.where(valid, dist, float("inf"))
    merged[:, TC_T] = torch.where(valid, t, zero)
    return merged


def _traj_lerp(points, distance):
    """Device twin of PolyLatTraj.lerp: interpolation keyed on the DIST
    column (clamped, angle-aware heading)."""
    d = points[:, TC_DIST].contiguous()
    n = points.shape[0]
    idx = torch.clamp(torch.searchsorted(d, distance, right=True) - 1,
                      0, n - 2)
    j = torch.clamp(idx + 1, max=n - 1)
    denom = torch.clamp(d[j] - d[idx], min=1e-9)
    a = torch.clamp((distance - d[idx]) / denom, 0.0, 1.0)[:, None]
    res = points[idx] * (1.0 - a) + points[j] * a
    res[:, TC_H] = points[idx, TC_H] + short_angle_dist_t(
        points[idx, TC_H], points[j, TC_H]) * a[:, 0]
    return res


def curv_vel_device(k, lim_v, a_lat_max, k_eps=1e-6):
    """Device twin of ops.profile.curv_to_vel_profile."""
    ka = torch.abs(k)
    v_curv = torch.sqrt(a_lat_max / torch.clamp(ka, min=1e-30))
    return torch.where(ka > k_eps, torch.minimum(lim_v, v_curv), lim_v)


def rampify_device(lim_v, a_min, a_max, j_min, j_max, v_min, step):
    """Device twin of ops.profile.rampify_profile with v0=a0=None: the
    jerk/acc-limited backward + forward spatial velocity integration, whose
    forward pass starts from the backward pass's end (the start mode of
    ``csrc/rstp_rampify.cu``).  The scalars are one-element float32
    tensors on the device of ``lim_v``.  Returns the velocity channel."""
    return rstp_rampify.scan_start(lim_v, a_min, a_max, j_min, j_max, v_min,
                                   step)[:, 0]


def make_poly_chain(spec):
    """Build the lateral and longitudinal stages.

    spec keys: s_steps, l_dst_steps, s_dst_steps (lateral);
    t_steps_env, s_steps_env, l_steps_env (env grid); t_steps, s_steps_lon,
    v_steps, a_steps, path_steps (longitudinal); rampify_step_path.

    Returns (lat_stage, lon_stage), on the device of their tensors:

    lat_stage(occ_map, ref_line, ref_step, ppl, env_pp, ppn, start,
              old_pts, n_keep, consts)
        -> (new_pts, merged, path, il, isd, cost)
    lon_stage(occ_map, path, env_scalars, ppn, x0, prev_pt)
        -> (traj, arc_len)

    ``ppl`` / ``env_pp`` / ``ppn`` are the packed float32 parameter vectors
    (PolyLatParams.packed(), pack_env_pp(), LonParams.packed()), ``consts``
    the rampify's (v_min, step) as a float32 pair, ``n_keep`` a host
    integer; the rest float32 tensors.
    """
    S_LAT = spec["s_steps"]
    LD = spec["l_dst_steps"]
    SD = spec["s_dst_steps"]
    P = spec["path_steps"]
    S_LON = spec["s_steps_lon"]
    # the FAS-2025 planner rampifies over a unit step (reference parity);
    # the lattice planner uses the path step
    rampify_step_path = bool(spec.get("rampify_step_path", False))

    lon_solve, _ = lk.make_lon_solver(dict(
        t_steps=spec["t_steps"], s_steps=S_LON, v_steps=spec["v_steps"],
        a_steps=spec["a_steps"], path_steps=P))

    def lat_stage(occ_map, ref_line, ref_step, ppl, env_pp, ppn, start,
                  old_pts, n_keep, consts):
        """Candidate sweep -> selection -> expansion -> splice -> path
        resampling -> velocity profile."""
        ppd = {k: ppl[i] for i, k in enumerate(PL_PP_KEYS)}
        ppn_d = unpack_lon_pp(ppn)

        best, cost = plk.sweep_select(occ_map, ref_line, ref_step, ppl,
                                      env_pp, start, LD, SD, S_LAT)[2:]
        il, isd = best // SD, best % SD
        new_pts = _expand_winner(il, isd, start, ref_line, ref_step, ppd,
                                 S_LAT, LD, SD)
        merged = _merge_and_time(old_pts, n_keep, new_pts)

        dists = torch.arange(P, dtype=f32, device=occ_map.device) \
            * ppn_d["path_step_size"]
        lat = _traj_lerp(merged, dists)
        path = lat[:, list(PATH_COLS)]
        v_prof = curv_vel_device(path[:, PC_K], path[:, PC_VMAX],
                                 ppd["a_lat_abs_max"])
        i_pss = LON_PP_KEYS.index("path_step_size")
        ramp_step = ppn[i_pss:i_pss + 1] if rampify_step_path \
            else consts[1:2]

        def one(key):
            i = LON_PP_KEYS.index(key)
            return ppn[i:i + 1]

        v_prof = rampify_device(v_prof.contiguous(), one("a_min"),
                                one("a_max"), one("j_min"), one("j_max"),
                                consts[0:1], ramp_step)
        path[:, PC_VMAX] = v_prof
        return new_pts, merged, path, il, isd, cost

    def lon_stage(occ_map, path, env_scalars, ppn, x0, prev_pt):
        """Projection of the previous trajectory point -> path distance
        map -> lon DP solve.  env_scalars: packed f32 [s_min,
        s_step_size, l_min, l_step_size] of the ENV grid."""
        ppn_d = unpack_lon_pp(ppn)
        arc = project_polyline(path[:, :2], prev_pt)["arc_len"]
        x0 = x0.clone()
        x0[LC_S] = arc

        s_step_lon = div_const(ppn_d["s_max"] - ppn_d["s_min"], S_LON - 1)
        dists = torch.arange(S_LON, dtype=f32, device=path.device) \
            * s_step_lon
        a = dists / ppn_d["path_step_size"]
        i0f = torch.clamp(torch.floor(a), 0, P - 1)
        i1 = torch.clamp(torch.ceil(a), 0, P - 1).long()
        al = torch.clamp(a - i0f, 0.0, 1.0)[:, None]
        interp = path[i0f.long()] * (1.0 - al) + path[i1] * al
        path_sl = interp[:, [PC_S, PC_L]]

        dist_path = dpe._dist_map_path(
            occ_map, path_sl, env_scalars[0], env_scalars[1],
            env_scalars[2], env_scalars[3]).contiguous()
        _nodes, traj = lon_solve(dist_path, path.contiguous(), ppn, x0)
        return traj, arc

    return lat_stage, lon_stage


# the replan's one upload, in this order (lengths per spec)
def _upload_layout(KP):
    return (("start", 5), ("old_pts", KP * 12), ("x0", 7), ("prev_pt", 2),
            ("ppl", len(PL_PP_KEYS)), ("env_pp", len(ENV_PP_KEYS)),
            ("ppn", len(LON_PP_KEYS)), ("ref_step", 1), ("env_scalars", 4),
            ("consts", 2))


class ChainRunner:
    """Shared planner-side front end over the chain: stages cached on the
    grid spec, one upload of the replan's host inputs, the two stages, and
    one download of the results.  Used by both the FAS-2025 and lattice
    planners (their replans differ only in the splice prefix, the projection
    point and the rampify step)."""

    def __init__(self, rampify_step_path=False):
        self.rampify_step_path = rampify_step_path
        self._lat_stage = None
        self._lon_stage = None
        self._spec = None

    def get(self, cpp_lat, cpp_lon, env_params):
        spec = dict(s_steps=cpp_lat.s_steps,
                    l_dst_steps=cpp_lat.l_dst_steps,
                    s_dst_steps=cpp_lat.s_dst_steps,
                    t_steps_env=env_params.t_steps,
                    s_steps_env=env_params.s_steps,
                    l_steps_env=env_params.l_steps,
                    t_steps=cpp_lon.t_steps,
                    s_steps_lon=cpp_lon.s_steps,
                    v_steps=cpp_lon.v_steps, a_steps=cpp_lon.a_steps,
                    path_steps=cpp_lon.path_steps,
                    rampify_step_path=self.rampify_step_path)
        if self._spec != spec:
            self._lat_stage, self._lon_stage = make_poly_chain(spec)
            self._spec = spec
        return self._lat_stage, self._lon_stage

    def replan(self, cppe, cpp_lat, cpp_lon, start_vec, old_pts, n_keep,
               x0, prev_pt):
        """Run the replan against a DpEnvironment whose env grid has been
        built (cppe.update()).  Returns (new_pts, path, il, isd, cost,
        traj, arc) as numpy."""
        lat_stage, lon_stage = self.get(cpp_lat, cpp_lon, cppe.params)
        occ = cppe.grid.occ_map
        dev = occ.device
        pe = cppe.params
        host = dict(
            start=np.asarray(start_vec, np.float32),
            old_pts=np.asarray(old_pts, np.float32),
            x0=np.asarray(x0, np.float32), prev_pt=np.asarray(prev_pt,
                                                              np.float32),
            ppl=cpp_lat.packed(), env_pp=plk.pack_env_pp(pe),
            ppn=cpp_lon.packed(), ref_step=np.float32(cppe.ref_step),
            env_scalars=np.array([pe.s_min, pe.s_step_size, pe.l_min,
                                  pe.l_step_size], np.float32),
            consts=np.array([1.0, 1.0], np.float32))
        KP = old_pts.shape[0]
        layout = _upload_layout(KP)
        buf = torch.from_numpy(np.concatenate(
            [np.ravel(host[k]) for k, _ in layout])).to(dev)
        views, o = {}, 0
        for k, n in layout:
            views[k] = buf[o:o + n]
            o += n

        new_pts, _m, path, il, isd, cost = lat_stage(
            occ, cppe.grid.ref_line, views["ref_step"], views["ppl"],
            views["env_pp"], views["ppn"], views["start"],
            views["old_pts"].reshape(KP, 12), int(n_keep), views["consts"])
        traj, arc = lon_stage(occ, path, views["env_scalars"], views["ppn"],
                              views["x0"], views["prev_pt"])

        # the one download of the replan
        out = torch.cat([new_pts.reshape(-1), path.reshape(-1),
                         torch.stack([il.to(f32), isd.to(f32), cost, arc]),
                         traj.reshape(-1)]).cpu().numpy()
        S, P = new_pts.shape[0], path.shape[0]
        o = 0
        new_np = out[o:o + S * 12].reshape(S, 12)
        o += S * 12
        path_np = out[o:o + P * 7].reshape(P, 7)
        o += P * 7
        il_v, isd_v, cost_v, arc_v = out[o:o + 4]
        o += 4
        traj_np = out[o:].reshape(-1, 7)
        return (new_np, path_np, int(il_v), int(isd_v), cost_v, traj_np,
                arc_v)
