"""Seeded inputs on which the hand-written kernels are held against their
plain versions: ``chip_smoke.py``, the card tests
(``tests/test_torch_kernel_cuda.py``) and the CPU rehearsal of the kernel
bodies (``tests/test_torch_kernel_rehearsal.py``) all draw from here."""

import numpy as np
import torch

from .planning.dyn_prog import dp_environment as dpe
from .planning.dyn_prog import lon_kernel as tlk
from .planning.dyn_prog import poly_planner_kernel as ppk
from .planning.dyn_prog import poly_lat_kernel as plk
from .planning.idm_sampling import idm_kernel as idk
from .planning.poly_sampling import poly_sampling_planner as psp

# the demo planning set's lon grid
LON_DEMO = dict(T=10, S=201, V=37, A=20, P=200)
# lon grids (T, S, V, A, P) of lon_scene (1 m s cells, 3 m/s v cells) where
# the backward kernel's edges are in play: the fastest v shifts past the
# last s row, the next v and a clamp at both ends of V and A, and the
# kernel's tiles do not divide S
LON_EDGE = ((4, 23, 7, 20, 40), (5, 41, 13, 5, 90), (3, 29, 11, 9, 60))


def rampify_args(dev, H, T, seed):
    """Seeded arguments of ``rstp_rampify.scan`` on ``dev``: start v and a,
    a random-walk limit (H,) with a slow stretch, T and the six scalars."""
    rng = np.random.default_rng(seed)
    lim = np.maximum(1.0, 10.0 + np.cumsum(rng.normal(0.0, 1.0, H)))
    lim[H // 6:H // 6 + 5] = 2.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return (f32(rng.uniform(0.0, 12.0)), f32(rng.normal(0.0, 0.5)), f32(lim),
            T, f32(-2.5), f32(2.5), f32(-1.5), f32(1.5), f32(1.0), f32(0.5))


def lon_scene(S, V, A, P, T, seed, demo=False):
    """A seeded lon DP scene: (pp vector, path (P, 7), dist_path (T, S),
    start state (7,)), float32.  ``demo``: the demo planning set's lon
    block (200 m, 0..36 m/s, a in [-3, 1.5], j in [-3, 2], a 1 m path
    step); else a grid of 1 m s cells and 3 m/s v cells."""
    rng = np.random.default_rng(seed)
    p = tlk.LonParams()
    p.t_steps, p.s_steps, p.v_steps, p.a_steps, p.path_steps = T, S, V, A, P
    if demo:
        p.s_max, p.v_max = 200.0, 36.0
        p.a_min, p.a_max, p.j_min, p.j_max = -3.0, 1.5, -3.0, 2.0
        p.time_gap, p.w_progress, p.w_a, p.w_j = 1.0, 0.1, 1.0, 1.0
        p.path_step_size, p.length_veh = 1.0, 4.895
    else:
        p.s_max = float(S - 1)
        p.v_max = 3.0 * (V - 1)
        p.path_step_size = 0.5
    path = np.zeros((P, 7), np.float32)
    dists = np.arange(P, dtype=np.float32) * np.float32(p.path_step_size)
    path[:, tlk.PC_X] = dists
    path[:, tlk.PC_S] = dists
    path[:, tlk.PC_VMAX] = np.clip(
        11.0 + np.cumsum(rng.normal(0.0, 0.4, P)), 3.0, 20.0)
    path[:, tlk.PC_DIST] = dists
    s = np.linspace(0.0, p.s_max, S)
    dist = np.maximum(0.0, 0.8 * p.s_max - s)[None, :] \
        + 2.5 * np.arange(T)[:, None]
    dist += rng.uniform(0.0, 0.5, (T, S))
    dist[:, -3:] = 10000.0
    x0 = np.array([0.0, 0.3, 6.0, 0.5, 0.0, 0.0, 0.0], np.float32)
    return (p.packed(), path, dist.astype(np.float32), x0)


def lon_shifted_start(x0):
    """``x0`` as a replan's start state: the head of the previous plan as
    the planner's ``shift_trajectory`` keeps it, with that plan's cost (3)
    and constraint (0.5), which no row of the new pass may take over."""
    x = np.array(x0, np.float32)
    x[tlk.LC_COST], x[tlk.LC_CONSTR] = 3.0, 0.5
    return x


# the value inputs that the NaN cases poison (the terms keep the NaN, no
# index takes it)
NAN_VALUES = ("dist_path", "v_max")


def lon_nan_values(path, dist, where):
    """Copies of the path and the distance map of ``lon_scene(41, 13, 5,
    90, 5, 46)`` with NaN in a value input: s cells 12-14 of every row of
    the distance map (``where`` "dist_path": the forward pass's state 2
    and the nodes of those rows), or the path's v_max at rows 37-38
    ("v_max": state 3, and the actions of step 2 that reach it)."""
    path, dist = path.copy(), dist.copy()
    if where == "dist_path":
        dist[:, 12:15] = np.nan
    else:
        path[37:39, tlk.PC_VMAX] = np.nan
    return path, dist


def poly_lat_nan_bounds(ref_line):
    """A copy of a sweep's reference line (``poly_lat_scene``) with NaN
    lane bounds: the left (dl) at rows 30-33 (s 15-16.5 m), the right (dr)
    at rows 50-51 (s 25-25.5 m); every candidate whose polynomial reaches
    them costs NaN."""
    rl = ref_line.copy()
    rl[30:34, 5] = np.nan
    rl[50:52, 6] = np.nan
    return rl


SELECT_EDGES = ("empty", "infeasible", "nan_init", "nan_all")


def poly_lat_select_edge(scene, SD, case):
    """A copy of a sweep's scene (``poly_lat_scene``, SD > 1) that drives
    the selection into an edge: "empty" no obstacle (every collision
    distance 1000, all tied); "infeasible" the left lane bound at -10 m
    (every cost past the feasibility limit: the first pass takes no
    update); "nan_init" NaN left lane bounds past the second-longest
    candidates' end (the longest candidates cost NaN, the first update's
    among them); "nan_all" every left lane bound NaN (every cost NaN: the
    winner stays the first update's index, its cost inf)."""
    occ, rl, step, pp, env, start = scene
    occ, rl = occ.copy(), rl.copy()
    if case == "empty":
        occ[...] = 0.0
    elif case == "infeasible":
        rl[:, 5] = -10.0
    elif case == "nan_all":
        rl[:, 5] = np.nan
    else:
        k = plk.PL_PP_KEYS.index
        ends = start[3] + np.linspace(pp[k("s_dst_min")],
                                      pp[k("s_dst_max")], SD)
        # the rows a sample within the second-longest candidates reads lie
        # at most one row past their end
        at = np.arange(len(rl)) * step
        rl[(at > ends[-2] + step) & (at <= ends[-1]), 5] = np.nan
    return occ, rl, step, pp, env, start


def lon_nodes(pp, path, dist, T, S, V, A, dev="cpu"):
    """Every slice of a solve by the plain version (nodes[0] zeros), on
    ``dev``."""
    args = tuple(torch.from_numpy(a).to(dev) for a in (pp, path, dist))
    nodes = torch.zeros((T, S, V, A, 4), dtype=torch.float32, device=dev)
    nodes[T - 1] = tlk.backward_slice_reference(nodes[T - 1], *args, T - 1,
                                                True)
    for i in range(T - 2, 0, -1):
        nodes[i] = tlk.backward_slice_reference(nodes[i + 1], *args, i, False)
    return nodes


def poly_lat_scene(LD, SD, S, seed):
    """A seeded lateral sweep: (occ (5, SE, LE), ref_line (n, 8), ref_step,
    pp, env_pp, start), float32; a gently curved road with obstacles."""
    rng = np.random.default_rng(seed)
    TE, SE, LE = 5, S, 21
    occ = np.zeros((TE, SE, LE), np.float32)
    for _ in range(6):
        t, s, l = rng.integers(0, TE), rng.integers(5, SE - 4), \
            rng.integers(3, LE - 3)
        occ[t:, s:s + 4, l - 2:l + 2] = rng.uniform(0.5, 2.0)
    n_ref = 2 * S + 60
    s_ref = np.arange(n_ref) * 0.5
    k = 0.01 * np.sin(s_ref / 15.0)
    h = np.cumsum(k) * 0.5
    rl = np.zeros((n_ref, 8), np.float32)
    rl[:, 0] = np.cumsum(np.cos(h)) * 0.5
    rl[:, 1] = np.cumsum(np.sin(h)) * 0.5
    rl[:, 2] = h
    rl[:, 3] = k
    rl[:, 4] = 12.0 - 4.0 * (s_ref > S * 0.6)
    rl[:, 5] = 3.5
    rl[:, 6] = 3.0
    p = plk.PolyLatParams()
    p.s_max, p.s_steps = float(S - 1), S
    p.l_dst_steps, p.s_dst_steps = LD, SD
    p.s_dst_min, p.s_dst_max = 6.0, 0.7 * (S - 1)
    env = np.array([1.0, 1.0, 0.0, float(SE - 1), -5.0, 5.0], np.float32)
    start = np.array([0.4, 0.05, 0.01, 1.0, 8.0], np.float32)
    return occ, rl, np.float32(0.5), p.packed(), env, start


def _idm_pp(**kw):
    """The scenes' IDM parameters (the JAX package's tests and bench)."""
    pp = idk.IdmSamplingParams()
    pp.width_veh = 2.0
    pp.length_veh = 5.0
    pp.radius_veh = 2.7
    pp.dist_front_veh = 3.8
    pp.dist_back_veh = -1.1
    for k, v in kw.items():
        setattr(pp, k, v)
    return pp


def idm_scene(stop_cell=False, collider=False, oncoming=False):
    """The seeded scene of tests/test_idm_kernel.py (NR=201, O=4, P=8,
    K=8): (ref_line (201, 7), objs (numpy, masks bool), pp
    (IdmSamplingParams), init_ref (10,), init_con (9,)).  ``stop_cell``: the
    ref speed 0 from cell 150 on; ``collider``: object 0 parked on the ego
    path, so that the screens hit; ``oncoming``: object 3 a car driving
    toward the ego at 10 m/s (heading near pi, 1 m to the left of the ego's
    start, drifting toward it), so that the interaction screen's hull test
    runs and hits and the rollout's leader has a negative speed."""
    rng = np.random.default_rng(0)
    NR = 201
    rl = np.zeros((NR, 7), np.float32)
    rl[:, 0] = np.arange(NR) * 0.5 - 50.0
    rl[:, 4] = 12.0
    rl[:, 5] = 4.0
    rl[:, 6] = 4.0
    if stop_cell:
        rl[150:, 4] = 0.0
    O, P, K = 4, 8, 8
    objs = dict(
        pred_t=np.tile(np.arange(P, dtype=np.float32), (O, 1)),
        pred_xy=np.zeros((O, P, 2), np.float32),
        pred_heading=np.zeros((O, P), np.float32),
        pred_v=np.zeros((O, P), np.float32),
        pred_dists=np.tile(np.arange(P, dtype=np.float32), (O, 1)),
        hull_preds=np.zeros((O, P, K, 2), np.float32),
        hull_projs=np.full((O, P, 4), -1000.0, np.float32),
        radius_hull=np.ones(O, np.float32),
        valid=np.ones(O, bool),
        on_local_map=np.ones(O, bool))
    box = rng.normal(scale=0.5, size=(K, 2)).astype(np.float32)
    for i in range(O):
        objs["pred_xy"][i, :, 0] = 20.0 + 8 * i + np.arange(P) * 1.5
        objs["pred_xy"][i, :, 1] = (i % 3 - 1) * 2.0
        objs["hull_preds"][i] = objs["pred_xy"][i][:, None, :] + box[None]
    if collider:
        objs["pred_xy"][0, :, 0] = 8.0
        objs["pred_xy"][0, :, 1] = 0.0
        objs["pred_v"][0] = 0.0
        b0 = objs["hull_preds"][0][0] - objs["hull_preds"][0][0].mean(0)
        objs["hull_preds"][0] = objs["pred_xy"][0][:, None, :] + b0[None]
    if oncoming:
        xy = np.stack([60.0 - 10.0 * np.arange(P),
                       2.5 - 0.1 * np.arange(P)], -1).astype(np.float32)
        seg = np.diff(xy, axis=0)
        head = np.arctan2(seg[:, 1], seg[:, 0])
        head = np.append(head, head[-1]).astype(np.float32)
        objs["pred_xy"][3] = xy
        objs["pred_heading"][3] = head
        objs["pred_v"][3] = 10.0
        objs["pred_dists"][3] = np.concatenate(
            [[0.0], np.cumsum(np.hypot(seg[:, 0], seg[:, 1]))])
        objs["radius_hull"][3] = 2.5
        # a 4.6 m x 1.8 m car: corners and edge midpoints, counterclockwise
        u = np.array([[-1, -1], [0, -1], [1, -1], [1, 0], [1, 1], [0, 1],
                      [-1, 1], [-1, 0]], np.float32) * [2.3, 0.9]
        c, s_ = np.cos(head), np.sin(head)
        objs["hull_preds"][3, :, :, 0] = (xy[:, None, 0] + c[:, None] * u[:, 0]
                                          - s_[:, None] * u[:, 1])
        objs["hull_preds"][3, :, :, 1] = (xy[:, None, 1] + s_[:, None] * u[:, 0]
                                          + c[:, None] * u[:, 1])
    init_ref = np.zeros(10, np.float32)
    init_ref[4] = 8.0
    init_con = np.zeros(9, np.float32)
    init_con[5] = 8.0
    return rl, objs, _idm_pp(), init_ref, init_con


def idm_hairpin_scene(start_s=0.0):
    """A ref line that doubles back (NR=201, step 0.5 m): 40 m along +x,
    a half circle of radius 4 m, then back along -x, the two legs 8 m
    apart, so that a candidate between them lies near both and the
    projection's chunk boxes cannot exclude the far leg.  The ref speed is
    0 over cells 170-179 (a zero-speed stretch), and d_left / d_right fall
    to 1.2 m over cells 60-89 (a narrowing that takes candidates with
    |l| > 1.2 off the road).  Four objects (O=4, P=8, K=8): one slow ahead
    on the first leg, one oncoming on it (the interaction screen's hull
    tests run), one on the second leg and one parked on the half circle.
    The ego starts on the first leg at station ``start_s`` (<= 40 m) at 8
    m/s.  Returns (ref_line (201, 7), objs, pp, init_ref, init_con), as
    :func:`idm_scene`."""
    NR, step, rad = 201, 0.5, 4.0
    s = np.arange(NR, dtype=np.float64) * step
    arc_len = np.pi * rad
    x, y = np.empty(NR), np.empty(NR)
    head, k = np.zeros(NR), np.zeros(NR)
    for n, sn in enumerate(s):
        if sn <= 40.0:
            x[n], y[n] = sn - 20.0, 0.0
        elif sn <= 40.0 + arc_len:
            a = (sn - 40.0) / rad - np.pi / 2
            x[n], y[n] = 20.0 + rad * np.cos(a), rad + rad * np.sin(a)
            head[n], k[n] = a + np.pi / 2, 1.0 / rad
        else:
            x[n], y[n] = 20.0 - (sn - 40.0 - arc_len), 2 * rad
            head[n] = np.pi
    rl = np.zeros((NR, 7), np.float32)
    rl[:, 0], rl[:, 1], rl[:, 2], rl[:, 3] = x, y, head, k
    rl[:, 4] = 12.0
    rl[170:180, 4] = 0.0
    rl[:, 5] = 4.0
    rl[:, 6] = 4.0
    rl[60:90, 5] = 1.2
    rl[60:90, 6] = 1.2
    O, P, K = 4, 8, 8
    t = np.arange(P, dtype=np.float32)
    # (x0, y0, heading, speed) of each object
    motion = [(5.0, 0.0, 0.0, 3.0), (40.0, 2.5, np.pi, 8.0),
              (10.0, 8.0, np.pi, 6.0), (24.0, 4.0, np.pi / 2, 0.0)]
    objs = dict(
        pred_t=np.tile(t, (O, 1)),
        pred_xy=np.zeros((O, P, 2), np.float32),
        pred_heading=np.zeros((O, P), np.float32),
        pred_v=np.zeros((O, P), np.float32),
        pred_dists=np.zeros((O, P), np.float32),
        hull_preds=np.zeros((O, P, K, 2), np.float32),
        hull_projs=np.full((O, P, 4), -1000.0, np.float32),
        radius_hull=np.full(O, 2.5, np.float32),
        valid=np.ones(O, bool),
        on_local_map=np.ones(O, bool))
    u = np.array([[-1, -1], [0, -1], [1, -1], [1, 0], [1, 1], [0, 1],
                  [-1, 1], [-1, 0]], np.float32) * [2.3, 0.9]
    for i, (x0, y0, h, v) in enumerate(motion):
        c, s_ = np.cos(h), np.sin(h)
        xy = np.stack([x0 + c * v * t, y0 + s_ * v * t], -1)
        objs["pred_xy"][i] = xy
        objs["pred_heading"][i] = h
        objs["pred_v"][i] = v
        objs["pred_dists"][i] = v * t if v > 0 else t
        objs["hull_preds"][i, :, :, 0] = (xy[:, None, 0] + c * u[:, 0]
                                          - s_ * u[:, 1])
        objs["hull_preds"][i, :, :, 1] = (xy[:, None, 1] + s_ * u[:, 0]
                                          + c * u[:, 1])
    init_ref = np.zeros(10, np.float32)
    init_ref[1] = start_s - 20.0
    init_ref[4] = 8.0
    init_ref[6] = start_s
    init_con = np.zeros(9, np.float32)
    init_con[1] = start_s - 20.0
    init_con[5] = 8.0
    init_con[7] = start_s
    return rl, objs, _idm_pp(), init_ref, init_con


def idm_through_states(C, T):
    """Fabricated (ref_states (C, T, 10), states (C, T, 9)) that drive
    straight through the collider scene, fanned out laterally (the JAX
    package's tests/test_idm_kernel.py: a real rollout brakes for the
    parked car and never collides)."""
    rng = np.random.default_rng(3)
    cons = np.zeros((C, T, 9), np.float32)
    ts = np.arange(T, dtype=np.float32) * 0.1
    for c in range(C):
        y = np.float32(-4.0 + 8.0 * c / (C - 1))
        cons[c, :, 0] = ts
        cons[c, :, 1] = ts * 8.0
        cons[c, :, 2] = y
        cons[c, :, 3] = rng.normal(scale=0.1)
        cons[c, :, 5] = 8.0
        cons[c, :, 6] = rng.normal(scale=0.5)
        cons[c, :, 7] = ts * 8.0 + 50.0 * 0.5
        cons[c, :, 8] = y
    refs = np.zeros((C, T, 10), np.float32)
    refs[:, :, 8] = 4.0 - np.abs(cons[:, :, 2])
    refs[:, :, 9] = 4.0 + cons[:, :, 2]
    return refs, cons


def idm_bench_scene(C=16384):
    """The JAX package's IDM throughput scene (bench.py _idm_setup): NR=801,
    O=12, P=16, K=16, T=100; returns (ref_line, objs, pp, init_ref,
    init_con, l_trgs (C,) = linspace(-3, 3), d_stops (C,) = 1e6)."""
    NR = 801
    rl = np.zeros((NR, 7), np.float32)
    rl[:, 0] = np.arange(NR) * 0.5 - 200.0
    rl[:, 4] = 12.0
    rl[:, 5] = 4.0
    rl[:, 6] = 4.0
    objs = dict(
        pred_t=np.tile(np.arange(16, dtype=np.float32), (12, 1)),
        pred_xy=np.zeros((12, 16, 2), np.float32),
        pred_heading=np.zeros((12, 16), np.float32),
        pred_v=np.zeros((12, 16), np.float32),
        pred_dists=np.tile(np.arange(16, dtype=np.float32), (12, 1)),
        hull_preds=np.zeros((12, 16, 16, 2), np.float32),
        hull_projs=np.full((12, 16, 4), -1000.0, np.float32),
        radius_hull=np.ones(12, np.float32),
        valid=np.ones(12, bool),
        on_local_map=np.ones(12, bool))
    box = np.array([[-2, -1], [2, -1], [2, 1], [-2, 1]] * 4, np.float32)
    for i in range(12):
        objs["pred_xy"][i, :, 0] = 30.0 + 10 * i + np.arange(16) * 2.0
        objs["pred_xy"][i, :, 1] = (i % 3 - 1) * 2.5
        objs["hull_preds"][i] = objs["pred_xy"][i][:, None, :] + box[None]
    init_ref = np.zeros(10, np.float32)
    init_ref[4] = 8.0
    init_con = np.zeros(9, np.float32)
    init_con[5] = 8.0
    return (rl, objs, _idm_pp(), init_ref, init_con,
            np.linspace(-3, 3, C).astype(np.float32),
            np.full(C, 1e6, np.float32))


def idm_args(rl, objs, pp, init_ref, init_con, l_trgs, d_stops, dev,
             dt_replan=0.1, ref_step=0.5):
    """The rollout's tensor arguments on ``dev``: (init_ref, init_con,
    l_trgs, d_stops, dt_replan, ref_line, ref_step, objs, pp_vec)."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return (f32(init_ref), f32(init_con), f32(l_trgs), f32(d_stops),
            f32([dt_replan]), f32(rl), f32([ref_step]),
            idk.objs_to_torch(objs, dev), f32(pp.packed()))


def poly_scene(obstacles=True, bench=False):
    """The poly-sampling scenes: tests/test_poly_kernel.py's (a 200-point
    straight path, two obstacles; C=30 candidates of 25 steps) or, with
    ``bench``, the JAX package's bench scene (bench.py
    bench_poly_sampling: 500 points, 8 box obstacles).  Returns (start,
    path, obstacles, PolySamplingParams)."""
    N = 500 if bench else 200
    path = np.zeros((N, 6))
    path[:, 0] = np.arange(N) * 0.5
    path[:, 3] = path[:, 0]
    path[:, 5] = 10.0
    start = dict(d=0.5, d_d=0.1, d_dd=0.0, s=0.0, s_d=8.0, s_dd=0.0)
    if bench:
        obs = [dict(hull=np.array(
            [[30. + 12 * i, -1.], [34. + 12 * i, -1.],
             [34. + 12 * i, 1.], [30. + 12 * i, 1.]])) for i in range(8)]
    elif obstacles:
        obs = [dict(hull=np.array([[30., -1.], [34., -1.], [34., 1.],
                                   [30., 1.]])),
               dict(hull=np.array([[18., 1.5], [21., 1.5], [21., 3.5],
                                   [18., 3.5], [19.5, 4.0]]))]
    else:
        obs = []
    pp = psp.PolySamplingParams()
    pp.lane_width = 3.0
    pp.v_samples = 2
    pp.rear_axis_to_rear = 1.0
    pp.rear_axis_to_front = 4.0
    pp.width_ego = 2.5
    return start, path, obs, pp


def dp_poly_env(obstacle=True):
    """tests/test_dp_poly_planner.py's ``_env`` scene on the port's
    ``DpEnvironment`` (grids on ``tpl_tpu_torch.device()``): the demo env
    grid (10 x 201 x 21, 21 directions) over a straight 200 m road, 10 m/s,
    4 m to each side; with ``obstacle`` a stationary 4 x 2 m block at s
    58-62 m on the centre line in every slice.  The directional field is
    not computed."""
    env = dpe.DpEnvironment()
    env.reinit_buffers(dpe.DpEnvParams())
    rl = np.zeros((401, 9))
    rl[:, 0] = np.arange(401) * 0.5
    rl[:, 3] = rl[:, 0]
    rl[:, 5] = 10.0
    rl[:, 6] = 4.0
    rl[:, 7] = 4.0
    env.set_ref_line(rl, 0.5)
    if obstacle:
        quad = np.array([[58., -1.], [62., -1.], [62., 1.], [58., 1.]])
        env.insert_geometry([(quad, t) for t in np.arange(10.0)],
                            stationary=True)
    env.update()
    return env


def dp_batch_scenes(B, T, S, L, seed=0, nan=True):
    """B seeded scenes of the DP lat/lon planner for its scenario-batched
    solve: a distance-ahead map with a leader and a parked car (the kernel
    phase's scene, scaled to the grid) whose leader starts, lanes and
    parked length differ per scenario, plus seeded noise; reference lines
    of one row count whose speed limit and lane bounds vary per scenario;
    per-scenario ``l_trg`` (-1.5 .. 1.5 m) and start speeds; with ``nan``
    one scenario (index 1, or 0 in a batch of one) with NaN distance cells
    in every slice.  Returns numpy float32 (dist (B, T, S, L, 2), ref_lines
    (B, 2 S + 40, 8), pps (B, len(PP_KEYS)) packed, x0s (B, 12)); the
    reference step is 0.5 m and the params otherwise the defaults."""
    from .planning.dyn_prog import lat_lon_kernel as llk

    rng = np.random.default_rng(seed)
    n_ref = 2 * S + 40
    dist = np.full((B, T, S, L, 2), 10000.0, np.float32)
    dist[..., 0] = 10000.0 + (S - np.arange(S))[None, None, :, None]
    rls = np.zeros((B, n_ref, 8), np.float32)
    pps = np.zeros((B, len(llk.PP_KEYS)), np.float32)
    x0s = np.zeros((B, 12), np.float32)
    mid = L // 2
    for b in range(B):
        d = dist[b, ..., 0]
        shift = int(rng.integers(-1, 2)) if L > 4 else 0
        lead0 = S // 6 + int(rng.integers(0, S // 8 + 1))
        for t in range(T):
            lead = min(S - 1, lead0 + (S // 25 + 1) * t)
            lo, hi = max(mid - 2 + shift, 0), min(mid + 3 + shift, L)
            d[t, :lead, lo:hi] = (lead - np.arange(lead))[:, None]
            park = (3 * S) // 5 - int(rng.integers(0, S // 5 + 1))
            d[t, :park, 1:max(2, L // 4)] = np.minimum(
                d[t, :park, 1:max(2, L // 4)],
                (park - np.arange(park))[:, None])
        d[:, :, [0, L - 1]] = 0.0
        d += rng.uniform(0, 0.5, (T, S, L)).astype(np.float32)
        rl = rls[b]
        rl[:, 0] = np.arange(n_ref) * 0.5
        rl[:, 4] = 14.0 - rng.uniform(2.0, 8.0) * (np.arange(n_ref)
                                                   > n_ref // 2)
        rl[:, 5] = 4.0 - 1.5 * (np.arange(n_ref) % (40 + 10 * b) > 30)
        rl[:, 6] = 4.0 - 2.0 * (np.arange(n_ref) % 70 > 50)
        p = llk.LatLonParams()
        p.l_trg = -1.5 + 3.0 * b / max(B - 1, 1)
        pps[b] = p.packed()
        x0s[b, llk.C_DS] = 4.0 + 0.5 * b
    if nan:
        b = min(1, B - 1)
        dist[b, :, S // 3:S // 3 + 2, mid + 1, 0] = np.nan
    return dist, rls, pps, x0s


def genopt_mpc_config(sx=None, go=None):
    """The spatial tracking MPC as a user would define it with the sympy
    front end (the JAX package's tests/test_genopt.py ``mpc_config``, the
    reference's config_trajectory_tracking_mpc shape), with the ``symext``
    and ``genopt`` modules ``sx`` / ``go`` (the port's unless given)."""
    import sympy as sp

    if sx is None:
        from .optim import symext as sx
    if go is None:
        from .optim import genopt as go
    g = {n: sp.Symbol(n) for n in (
        "x y phi delta v s_r a j delta_dot "
        "ref_step l v_ch max_delta max_acc min_acc a_offset "
        "pd pv pdelta min_pdelta_dot pdelta_dot min_p_phi_dot p_phi_dot "
        "pa pj p_phi p_phi_ref_dot_diff").split()}
    arrs = {n: sx.ArraySymbol(n) for n in
            ["ref_x", "ref_y", "ref_phi", "ref_k", "ref_v"]}

    s_r = g["s_r"]
    r_x = sx.lerp(0.0, g["ref_step"], s_r, arrs["ref_x"])
    r_y = sx.lerp(0.0, g["ref_step"], s_r, arrs["ref_y"])
    r_phi = sx.lerp_angle(0.0, g["ref_step"], s_r, arrs["ref_phi"])
    r_k = sx.lerp(0.0, g["ref_step"], s_r, arrs["ref_k"])
    v_trg = sx.lerp(0.0, g["ref_step"], sx.fixed(s_r), arrs["ref_v"])

    v, phi, delta = g["v"], g["phi"], g["delta"]
    phi_dot = v / (g["l"] * (1 + (v / g["v_ch"]) ** 2)) * sp.tan(delta)
    d_r = sp.cos(r_phi) * (g["y"] - r_y) - sp.sin(r_phi) * (g["x"] - r_x)
    s_dot = v * sp.cos(phi - r_phi) / (1 - d_r * r_k)

    dynamics = sp.Matrix([
        v * sp.cos(phi), v * sp.sin(phi), phi_dot, g["delta_dot"],
        g["a"] + g["a_offset"], s_dot, g["j"]])

    costs = sp.Matrix([
        (g["min_pdelta_dot"] + g["pdelta_dot"] * v ** 2) * g["delta_dot"] ** 2
        + (g["min_p_phi_dot"] + g["p_phi_dot"] * v ** 2) * phi_dot ** 2
        + g["pa"] * g["a"] ** 2 + g["pj"] * g["j"] ** 2
        + g["pv"] * (v - v_trg) ** 2 + g["pd"] * d_r ** 2
        + g["p_phi"] * (1 - sp.cos(phi - r_phi))
        + g["p_phi_ref_dot_diff"] * (phi_dot - s_dot * r_k) ** 2 * v ** 2])

    constraints = [
        delta - g["max_delta"], -g["max_delta"] - delta,
        g["a"] - g["max_acc"], g["min_acc"] - g["a"]]

    params = {g[n]: None for n in
              ["ref_step", "l", "v_ch", "max_delta", "max_acc", "min_acc",
               "a_offset", "pd", "pv", "pdelta", "min_pdelta_dot",
               "pdelta_dot", "min_p_phi_dot", "p_phi_dot", "pa", "pj",
               "p_phi", "p_phi_ref_dot_diff"]}
    params.update({arrs[n]: None for n in arrs})
    params[g["l"]] = 2.7

    return go.Config(
        states=[g[n] for n in "x y phi delta v s_r a".split()],
        actions=[g["j"], g["delta_dot"]],
        params=params,
        dynamics=dynamics, costs=costs, constraints=constraints,
        name="mpc_sympy", array_capacity=128)


def genopt_mpc_solve_inputs():
    """The course, weights and start of tests/test_genopt.py's full solve
    (a parabola of 100 samples every 0.5 m, 8 m/s): (params dict, x0)."""
    n = 100
    s = np.arange(n) * 0.5
    params = dict(ref_x=s, ref_y=0.02 * s ** 2, ref_phi=np.arctan(0.04 * s),
                  ref_k=np.full(n, 0.01), ref_v=np.full(n, 8.0),
                  pd=1.0, pv=0.3, pa=0.1, pj=0.05, min_pdelta_dot=0.2,
                  pdelta_dot=0.01, min_p_phi_dot=0.1, p_phi_dot=0.01,
                  p_phi=2.0, p_phi_ref_dot_diff=0.1, ref_step=0.5,
                  l=2.7, v_ch=30.0, max_delta=0.7, max_acc=2.5,
                  min_acc=-3.0, a_offset=0.0)
    return params, [0.0, 0.5, 0.1, 0.0, 5.0, 0.0, 0.0]


def dp_random_occ(seed, T=10, S=201, L=21, density=0.1):
    """A seeded occupancy grid (T, S, L) float32 of the four cell values
    (0 free, 1 moving, 2 blocked, 3 stationary), ``density`` of it
    occupied."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(1, 4, (T, S, L)).astype(np.float32)
    return np.where(rng.random((T, S, L)) < density, occ,
                    np.float32(0.0)).astype(np.float32)


def dp_moving_occ(seed, T, S=41, L=21):
    """Occupancy (T, S, L) float32 that changes over t: seeded cells (4 %
    of them), and the stationary block of :func:`dp_poly_env`'s stretch
    around it moved a station a slice."""
    occ = dp_random_occ(seed, T=T, S=S, L=L, density=0.04)
    block = np.zeros((S, L), np.float32)
    block[S // 2 - 2:S // 2 + 3, L // 2 - 2:L // 2 + 3] = 3.0
    for t in range(T):
        occ[t] = np.maximum(occ[t], np.roll(block, t - T // 2, axis=0))
    return occ


def dp_poly_near_horizon(p, seed=4):
    """A graph DP level whose start points lie near the horizon of the
    params ``p`` (8 to 9 s of 9 at the demo widths): (start points (5, 8),
    edge starts (E,) int32, end specs (E, 3) float32), end times a step or
    two after the start, at the horizon and past it."""
    rng = np.random.default_rng(seed)
    horizon = np.float32((p.t_steps - 1) * p.dt)
    t0 = horizon - np.array([1.0, 0.7, 0.25, 0.1, 0.0], np.float32)
    pts = np.zeros((len(t0), 8), np.float32)
    pts[:, ppk.PP_T] = t0
    pts[:, ppk.PP_S] = rng.uniform(40, 120, len(t0))
    pts[:, ppk.PP_DS] = rng.uniform(2, 14, len(t0))
    pts[:, ppk.PP_DDS] = rng.uniform(-1, 1, len(t0))
    pts[:, ppk.PP_L] = rng.uniform(-3, 3, len(t0))
    pts[:, ppk.PP_DL] = rng.uniform(-0.5, 0.5, len(t0))
    starts, specs = [], []
    for i, t in enumerate(t0):
        for te in (t + 0.1, t + 0.25, t + 0.5, horizon, t + 1.5):
            if te > t:
                starts.append(i)
                specs.append([te, rng.uniform(0, 15), rng.uniform(-4, 4)])
    return pts, np.array(starts, np.int32), np.array(specs, np.float32)


def dp_poly_keys():
    """The four (ds, l) start indices the graph DP's checks take at the
    demo widths (15 ds x 21 l): slow and centred, a level-2 cap at ds 3 and
    7 (469,335 and 577,838 edges uncapped), fast and off centre."""
    return [(1, 10), (3, 10), (7, 10), (12, 4)]


def dp_poly_propagation_case(seed, n1=40, e2=300, ties=True, nan=True,
                             levels=2, e3=600):
    """A seeded graph for the propagation: a root with ``n1`` edges, level
    1's nodes with ``e2`` edges among them (some nodes have none), float32
    points; with ``ties`` the costs take few values (equal least costs in a
    node's range), with ``nan`` a NaN cost among level 2's and one among
    level 1's.  ``levels`` 1 keeps the root's edges alone, 3 adds ``e3``
    edges from level 2's nodes (some without), with a NaN cost among them
    too.  Returns (node point arrays (float64, one per level), edge start
    arrays (int32, one per level))."""
    rng = np.random.default_rng(seed)
    with_edges = rng.permutation(n1)[:n1 * 3 // 4]
    starts2 = np.sort(rng.choice(with_edges, e2)).astype(np.int32)
    counts = [1, n1, e2]
    pts = []
    for n in counts:
        p = rng.normal(0.0, 5.0, (n, 8)).astype(np.float32)
        if ties:
            p[:, ppk.PP_COST] = rng.integers(0, 4, n).astype(np.float32)
        pts.append(p.astype(np.float64))
    if nan:
        pts[2][rng.integers(0, e2), ppk.PP_COST] = np.nan
        pts[1][rng.integers(0, n1), ppk.PP_COST] = np.nan
    edges = [np.zeros(n1, np.int32), starts2]
    if levels == 1:
        return pts[:2], edges[:1]
    if levels == 3:
        with_edges = rng.permutation(e2)[:e2 * 3 // 4]
        edges.append(np.sort(rng.choice(with_edges, e3)).astype(np.int32))
        p = rng.normal(0.0, 5.0, (e3, 8)).astype(np.float32)
        if ties:
            p[:, ppk.PP_COST] = rng.integers(0, 4, e3).astype(np.float32)
        if nan:
            p[rng.integers(0, e3), ppk.PP_COST] = np.nan
        pts.append(p.astype(np.float64))
    return pts, edges


def dp_poly_buffers(node_pts, edge_steps, dev):
    """The device buffers of :func:`poly_planner_kernel.
    propagate_and_backtrack` for a graph given as per-level point arrays:
    (pts, node_cost, best, seg, node_off, seg_off, traj)."""
    node_off, seg, seg_off = ppk.graph_layout([len(p) for p in node_pts],
                                              edge_steps)
    N, K = node_off[-1], len(edge_steps)
    pts = torch.from_numpy(np.concatenate(node_pts).astype(np.float32))
    return (pts.to(dev),
            torch.zeros(N, dtype=torch.float64, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev),
            torch.from_numpy(seg).to(dev), node_off, seg_off,
            torch.zeros((K + 1, 8), dtype=torch.float64, device=dev))


# the time-indexed tracking MPC's cases: the demo control set's solve (H=60
# capacity, T=40 active, step 0.05 s, 20 iterations, HEUN) on references
# sampled every 0.1 s, centred on their first point as the controller
# centres them
MPC_TIME_KINDS = ("utm_straight", "curved", "warm", "short")


def mpc_time_case(kind, seed=1):
    """Packed inputs and launch arguments of one time-MPC update
    (``optim.ilqr_tracking_mpc_time``): ``utm_straight`` a straight
    reference laid at UTM magnitude (571172, 5364663) and centred, cold;
    ``curved`` a weaving one, cold, with a 0.05 s reference offset;
    ``warm`` the curved one from seeded controls and multipliers, mu_step 2
    and two multiplier rounds; ``short`` a reference of 12 samples (1.1 s,
    shorter than the horizon's 2 s), edge-padded to the table as the
    solver pads it."""
    from .optim import ilqr, ilqr_tracking_mpc_time as itt

    rng = np.random.default_rng(seed)
    H, T, n_ref = 60, 40, 128
    tt = np.arange(n_ref) * 0.1
    v = 8.0 + 0.5 * np.sin(tt * 0.3)
    if kind == "utm_straight":
        v = np.full(n_ref, 10.0)
        yaw = np.full(n_ref, 0.3)
        x = 571172.0 + np.cos(yaw) * v * tt
        y = 5364663.0 + np.sin(yaw) * v * tt
    else:
        yaw = 0.2 * np.sin(tt * 0.4)
        x = np.cumsum(v * np.cos(yaw)) * 0.1
        y = np.cumsum(v * np.sin(yaw)) * 0.1
    x0 = [x[0] + 0.3, y[0] - 0.4, yaw[0] + 0.05, 0.02, v[0] - 0.5, 0.2]
    ref = dict(ref_x=x - x[0], ref_y=y - y[0], ref_phi=yaw, ref_v=v)
    x0[0] -= x[0]
    x0[1] -= y[0]
    if kind == "short":
        ref = {k: np.concatenate([a[:12], np.full(n_ref - 12, a[11])])
               for k, a in ref.items()}
    params = dict(pd=5.0, pv=5.0, pdelta=0.0, min_pdelta_dot=0.1,
                  pdelta_dot=0.1, min_p_phi_dot=0.0, p_phi_dot=0.05,
                  p_phi=0.5, pa=2.0, pj=0.5, l=2.7, v_ch=32.0, cog_pos=0.5,
                  ref_dt=0.1, ref_t_offset=0.05 if kind == "curved" else 0.0,
                  max_delta=0.7, max_acc=3.0, min_acc=-3.0, a_offset=0.1,
                  **ref)
    X = np.zeros((H + 1, 6))
    X[0] = x0
    u, lam, mu, lg = np.zeros((H, 2)), np.zeros((H, 4)), 0, 1
    if kind == "warm":
        u = rng.normal(0.0, 0.3, (H, 2))
        lam = rng.uniform(0.0, 1e-3, (H, 4))
        mu, lg = 2, 2
    inputs = dict(
        x=X, u=u, lam=lam,
        u_lims=np.tile(np.array([[[-3.0, 1.5], [-1.0, 1.0]]]), (H, 1, 1)),
        bw_lim=np.stack([np.full(4, 1e4), np.full(4, 1e30)], -1),
        cfg_f=np.array([0.05, 1e-6]))
    return (itt.pack_inputs(inputs, params),
            (H, n_ref, T, 20, lg, mu, ilqr.HEUN))


def mpc_time_generic_case(H, seed, warm=False, n_ref=128):
    """The time-indexed tracking MPC's solve inputs at any horizon up to
    300 steps of 0.05 s for the generic kernel (``mpc_time_case``'s weaving
    reference, sampled every 0.125 s so that its 128 samples outlast the
    horizon; HEUN): (inputs, params, mu_step)."""
    rng = np.random.default_rng(seed)
    ref_dt = 0.125
    tt = np.arange(n_ref) * ref_dt
    v = 8.0 + 0.5 * np.sin(tt * 0.3)
    yaw = 0.2 * np.sin(tt * 0.4)
    x = np.cumsum(v * np.cos(yaw)) * ref_dt
    y = np.cumsum(v * np.sin(yaw)) * ref_dt
    ref = dict(ref_x=x - x[0], ref_y=y - y[0], ref_phi=yaw, ref_v=v)
    params = dict(pd=5.0, pv=5.0, pdelta=0.0, min_pdelta_dot=0.1,
                  pdelta_dot=0.1, min_p_phi_dot=0.0, p_phi_dot=0.05,
                  p_phi=0.5, pa=2.0, pj=0.5, l=2.7, v_ch=32.0, cog_pos=0.5,
                  ref_dt=ref_dt, ref_t_offset=0.05, max_delta=0.7,
                  max_acc=3.0, min_acc=-3.0, a_offset=0.1, **ref)
    x0 = [0.3, -0.4, yaw[0] + 0.05, 0.02, v[0] - 0.5, 0.2]
    inputs, mu = generic_inputs(6, 2, 4, H, H, rng, warm,
                                [[-3.0, 1.5], [-1.0, 1.0]], 1e4, 1e30, 0.05,
                                x0, 0.1)
    return inputs, params, mu


def generic_inputs(nx, nu, ncl, H, T, rng, warm, u_lim, bw, lg_limit, dt, x0,
                   u_scale):
    """The per-update solver inputs (x, u, lam, u_lims, bw_lim, cfg_f) of a
    problem with nx states, nu actions and ncl multiplier columns, and its
    mu_step: start x0, the limits ``u_lim`` ((nu, 2) or (2,)) on every
    step, barrier weight ``bw``, multiplier limit ``lg_limit``; warm: seeded
    controls, multipliers and mu_step on the first T steps."""
    u, lam, mu = np.zeros((H, nu)), np.zeros((H, ncl)), 0
    if warm:
        u[:T] = rng.normal(0.0, u_scale, (T, nu))
        lam[:T] = (rng.uniform(0.0, 0.05, (T, ncl))
                   * (rng.uniform(size=(T, ncl)) < 0.3))
        mu = int(rng.integers(0, 4))
    x = np.zeros((H + 1, nx))
    x[0] = x0
    lims = np.asarray(u_lim, float).reshape(nu, 2)
    return dict(x=x, u=u, lam=lam, u_lims=np.tile(lims, (H, 1, 1)),
                bw_lim=np.stack([np.full(ncl, bw), np.full(ncl, lg_limit)],
                                -1),
                cfg_f=np.array([dt, 1e-6])), mu


GENERIC_NATIVE = ("ref_line_smoother_k", "ref_line_smoother_dk",
                  "velocity_profile_time")
# the RSTP profiles, which the generic kernel solves in a batch
GENERIC_RSTP = ("lateral_profile", "velocity_profile_space")


def generic_native_case(name, H, T, warm, seed, n_ref=512):
    """Seeded inputs of a native problem of the generic AL-iLQR kernel
    (``GENERIC_NATIVE``, ``GENERIC_RSTP``) at ``n_ref``: (inputs, params,
    mu_step, max_iterations).  The smoothers follow a gentle curve from its
    start (the curvature-rate smoother from near its solution: its
    quadruple integrator turns a larger start error into an orbit that
    leaves the curve); the time-indexed velocity profile drives under a
    limit over s and a corridor over t; the lateral profile keeps to a
    corridor that narrows ahead, the spatial velocity profile under a limit
    that drops and crossing times."""
    rng = np.random.default_rng(seed)
    s = np.arange(n_ref) * 0.5
    path_y = 0.8 * np.sin(s / 25.0) + rng.normal(0.0, 0.02, n_ref)
    path_x = s + rng.normal(0.0, 0.05, n_ref)
    if name in ("ref_line_smoother_k", "ref_line_smoother_dk"):
        params = dict(w_pos=1.0, w_k=0.5, w_dk=10.0, s_start=1.3,
                      ref_step=0.5, ref_x=path_x, ref_y=path_y)
        heading = np.arctan2(path_y[1] - path_y[0], path_x[1] - path_x[0])
        x0 = [path_x[0] + rng.normal(0.0, 0.1), path_y[0]
              + rng.normal(0.0, 0.1), heading + rng.normal(0.0, 0.02)]
        lim, u_scale, nx = [-1.0, 1.0], 0.01, 3
        if name == "ref_line_smoother_dk":
            x0.append(rng.normal(0.0, 0.001))
            lim, u_scale, nx = [-0.05, 0.05], 2e-5, 4
        inputs, mu = generic_inputs(nx, 1, 1, H, T, rng, warm, lim, 1000.0,
                                    0.1, 0.5, x0, u_scale)
    elif name == "velocity_profile_time":
        k = np.arange(n_ref)
        v_max = np.full(n_ref, 12.0)
        v_max[200:260] = 6.0
        s_max = np.where(k % 90 > 60, 3.0 * k * 0.1 + 20.0, 0.0)
        s_min = np.where(k % 70 > 55, 2.0 * k * 0.1 - 5.0, 0.0)
        params = dict(w_v=0.05, w_a=2.0, ref_step=0.5, ref_v=v_max,
                      ref_s_max=s_max, ref_s_min=s_min)
        inputs, mu = generic_inputs(2, 1, 4, H, T, rng, warm, [-3.0, 2.0],
                                    100.0, 10.0, 0.1,
                                    [0.0, rng.uniform(2.0, 10.0)], 0.3)
    elif name == "lateral_profile":
        lower = np.full(n_ref, -2.0)
        lower[8:14] = 0.4
        params = dict(k_ref=0.01 * np.sin(np.arange(n_ref) * 0.1),
                      d_offset=np.zeros(n_ref), d_lower_constr=lower,
                      d_upper_constr=np.full(n_ref, 2.0), ref_step=0.5,
                      w_d=0.5, w_v_d=0.5, w_a_d=0.5, w_k=0.5)
        inputs, mu = generic_inputs(2, 1, 2, H, T, rng, warm, [-2.5, 2.5],
                                    1000.0, 0.1, 0.5,
                                    [rng.normal(0.0, 0.5), 0.0], 0.05)
    elif name == "velocity_profile_space":
        k = np.arange(n_ref)
        v_max = np.full(n_ref, 14.0)
        v_max[120:160] = 8.0
        params = dict(p_v=0.1, p_a=1.0, max_a_total=5.0, ref_step=0.5,
                      ref_v=v_max, ref_k=0.002 * np.sin(k * 0.05),
                      ref_t_max=np.full(n_ref, 1e10),
                      ref_t_min=np.where(k % 100 > 80, 0.05 * k, 0.0),
                      ref_t_offset=np.ones(n_ref),
                      ref_v_weight=np.ones(n_ref))
        inputs, mu = generic_inputs(2, 1, 5, H, T, rng, warm, [-5.0, 3.0],
                                    1000.0, 0.1, 0.5,
                                    [rng.uniform(6.0, 10.0), 0.0], 0.2)
    else:
        raise ValueError(f"no generic case for {name!r}")
    return inputs, params, mu, 5


def genopt_mpc_case(warm, seed, H=60):
    """The genopt MPC's solve inputs (``genopt_mpc_solve_inputs``' course
    edge-padded to its capacity of 128), seeded warm starts: (inputs, params,
    mu_step)."""
    rng = np.random.default_rng(seed)
    params, x0 = genopt_mpc_solve_inputs()
    params = {k: (np.resize(np.asarray(v, float), 128) if np.ndim(v) else v)
              for k, v in params.items()}
    for k in ("ref_x", "ref_y", "ref_phi", "ref_k", "ref_v"):
        params[k][100:] = params[k][99]
    params["pdelta"] = 0.0
    inputs, mu = generic_inputs(7, 2, 4, H, H, rng, warm,
                                [[-3.0, 1.5], [-1.0, 1.0]], 1e4, 1e30, 0.05,
                                x0, 0.1)
    return inputs, params, mu


def genopt_every_function_config(sx=None, go=None):
    """A sympy config whose functions span the front end's CUDA printer
    (``genopt.CUDA_FUNCTIONS`` but ``genopt.PORT_FUNCTIONS``): every
    trigonometric, hyperbolic and exponential function, sqrt and
    integer / real / symbolic powers, Abs, sign, atan2, Max, Min, a
    Piecewise, ``fixed``, and each 1-D lookup at a step- or state-dependent
    query; with the ``symext`` and ``genopt`` modules ``sx`` / ``go`` (the
    port's unless given)."""
    import sympy as sp

    if sx is None:
        from .optim import symext as sx
    if go is None:
        from .optim import genopt as go
    x, v, a = sp.symbols("x v a")
    c, w, step = sp.symbols("c w step")
    ref, ang, xs, arr = (sx.ArraySymbol(n) for n in
                         ("ref", "ang", "xs", "arr"))
    t, dt = sp.Symbol("t"), sp.Symbol("dt")
    costs = [
        (x - sx.lerp(0.0, step, t * dt, ref)) ** 2,
        w * (v - sx.lerp_angle(0.0, step, x, ang)) ** 2,
        0.05 * a ** 2 + 0.01 * sp.exp(0.1 * a) + 0.01 * sp.tan(0.1 * a) ** 2,
        0.02 * sp.cosh(0.1 * v) + 0.01 * sp.sinh(0.05 * x) ** 2,
        0.01 * sp.log(2 + x ** 2) + 0.01 * sp.sqrt(1 + v ** 2),
        0.01 * sp.Abs(x - 100) + 0.001 * sp.sign(v) * v,
        0.01 * sp.atan2(v, 2 + x ** 2) + 0.01 * sp.atan(v) ** 2,
        0.01 * sp.asin(0.5 * sp.tanh(v)) + 0.01 * sp.acos(
            0.5 * sp.tanh(0.1 * x)) + 0.01 * sp.sin(x) * sp.cos(v),
        0.001 * sp.Max(v - 3, 0) ** 2 + 0.001 * sp.Min(x, 0) ** 2,
        sp.Piecewise((0.01 * v ** 2, v > 1), (0.01 * v, True)),
        0.01 * sx.lerp_wrap(30.0, step, x, xs, arr) * v,
        0.01 * sx.box_interp(step, x, arr) * v
        + 0.001 * sx.get_array_value(arr, t) * v,
        0.001 * (1 + v ** 2) ** sp.Rational(3, 4)
        + 0.001 * (2 + x ** 2) ** (0.1 * c) + 0.01 * sx.fixed(v) * v,
        0.01 / (1 + v ** 2) + 0.01 * (1 + a ** 2) ** -2,
    ]
    return go.Config(
        states=[x, v], actions=[a],
        params={c: 0.5, w: 0.2, step: 0.5, ref: None, ang: None, xs: None,
                arr: None},
        dynamics=[v, a - 0.05 * sp.sin(x) * sp.tanh(v)], costs=costs,
        end_costs=[0.1 * (x - 12) ** 2, 0.01 * v ** 2],
        constraints=[v - 4, -v - 4, sp.Max(a, -1) - 2 * c],
        name="every_function", array_capacity=64)


def genopt_every_function_case(seed, H=40):
    """Seeded inputs of ``genopt_every_function_config``: (inputs, params,
    mu_step)."""
    rng = np.random.default_rng(seed)
    n = 64
    s = np.arange(n) * 0.5
    params = dict(c=0.5, w=0.2, step=0.5,
                  ref=np.minimum(0.6 * s, 12.0) + rng.normal(0.0, 0.05, n),
                  ang=np.arctan(np.sin(0.3 * s)) + rng.normal(0.0, 0.01, n),
                  xs=s + 1.0, arr=np.cos(0.2 * s) + rng.normal(0.0, 0.1, n))
    inputs, mu = generic_inputs(2, 1, 3, H, H, rng, True, [-1.5, 1.5], 100.0,
                                5.0, 0.1, [0.5, 1.2], 0.2)
    return inputs, params, mu


# ---------------------------------------------------------------------
# two user problems written in plain torch, for the tracer
# (tpl_tpu_torch/optim/trace.py) and the generic AL-iLQR kernel: their
# captured tensors, products, reductions and elementwise functions are what
# jax.jit takes from a problem in the JAX package.  tests/test_torch_trace*.py
# write each again in jnp for the JAX package's ilqr / batched programs.

USER_PROBLEMS = ("quadratic_tracking_mpc", "cost_map_vehicle")


def quadratic_tracking_data(H=100, seed=0):
    """The captured tensors of :func:`quadratic_tracking_problem` (numpy,
    float64): the state weight ``Q`` (4 x 4, symmetric positive definite),
    the action weight ``R`` (2 x 2), the end weight ``QF``, the action
    scales ``U_SCALE`` and the reference ``REF`` (H, 4) of (x, y, heading,
    speed) of a vehicle driving a seeded curve at about 8 m/s, 0.1 s a
    step."""
    rng = np.random.default_rng(seed)
    steps = np.arange(H)
    kappa = 0.02 * np.sin(0.05 * steps + rng.uniform(0.0, 2 * np.pi))
    v = 8.0 + 0.5 * np.sin(0.03 * steps)
    phi = np.cumsum(kappa * v * 0.1)
    xy = np.cumsum(np.stack([v * np.cos(phi), v * np.sin(phi)], -1) * 0.1, 0)
    a = rng.normal(0.0, 1.0, (4, 4))
    Q = np.diag([1.0, 1.0, 2.0, 0.3]) + 0.02 * (a + a.T)
    b = rng.normal(0.0, 1.0, (2, 2))
    R = np.diag([0.2, 2.0]) + 0.02 * (b + b.T)
    return dict(Q=Q, R=R, QF=5.0 * Q, U_SCALE=np.array([3.0, 0.5]),
                REF=np.column_stack([xy, phi, v]))


def quadratic_tracking_problem(H=100, seed=0, dtype=torch.float64,
                               device="cpu"):
    """A quadratic tracking MPC of a kinematic vehicle (states x, y, phi, v;
    actions acc, steer): step cost ``(x - REF[t]) Q (x - REF[t]) + u R u``
    (``einsum`` and ``@`` over the captured Q, R; the reference read by the
    step index), the end cost ``d^T QF d`` at the reference's last row, and
    two constraints, the distance to the reference within ``corridor``
    (``linalg.vector_norm``) and the scaled actions' 1-norm within
    ``effort_max``.  Returns (Problem, param spec)."""
    from .optim.ilqr import Problem

    data = quadratic_tracking_data(H, seed)
    Q, R, QF, U_SCALE, REF = (torch.as_tensor(data[k], dtype=dtype,
                                              device=device)
                              for k in ("Q", "R", "QF", "U_SCALE", "REF"))

    def dynamics(x, u, t, dt, p):
        phi, v = x[..., 2], x[..., 3]
        vel = v.unsqueeze(-1) * torch.stack([torch.cos(phi), torch.sin(phi)],
                                            -1)
        yaw = v * torch.tan(u[..., 1]) * torch.reciprocal(p["wheel_base"])
        return torch.cat([vel, torch.stack([yaw, u[..., 0]], -1)], -1)

    def cost(x, u, t, dt, p):
        d = x - REF[t]
        return (torch.einsum("...i,ij,...j->...", d, Q, d)
                + (u @ R * u).sum(-1))

    def constraints(x, u, t, dt, p):
        off = x[..., :2] - REF[t][..., :2]
        return torch.stack([
            torch.linalg.vector_norm(off, dim=-1) - p["corridor"],
            torch.linalg.vector_norm(u / U_SCALE, ord=1, dim=-1)
            - p["effort_max"]], -1)

    def end_cost(x, t, dt, p):
        d = (x - REF[-1]).unsqueeze(-1)
        return (d.transpose(-1, -2) @ QF @ d).squeeze(-1).squeeze(-1)

    prob = Problem("quadratic_tracking_mpc", nx=4, nu=2, nc=2,
                   dynamics=dynamics, cost=cost, constraints=constraints,
                   end_cost=end_cost)
    return prob, dict(wheel_base=2.7, corridor=2.0, effort_max=1.5)


def cost_map_data(seed=0, n=200):
    """The captured tensors of :func:`cost_map_vehicle_problem` (numpy,
    float64): a cost map ``GRID`` (n x n cells of 0.5 m, rows along y, its
    first cell at ``ORIGIN``) of seeded Gaussian hills, two obstacles
    ``OBS`` (2 x 2), the goal ``GOAL`` and the action weights ``U_W``."""
    rng = np.random.default_rng(seed)
    step = 0.5
    origin = np.array([-10.0, -0.5 * step * n])
    xs = origin[0] + step * np.arange(n)
    ys = origin[1] + step * np.arange(n)
    gx, gy = np.meshgrid(xs, ys)
    grid = np.zeros((n, n))
    for cx, cy, h, r in zip(rng.uniform(5.0, 80.0, 12),
                            rng.uniform(-30.0, 30.0, 12),
                            rng.uniform(0.5, 2.0, 12),
                            rng.uniform(2.0, 6.0, 12)):
        grid += h * np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2) / (2 * r * r))
    return dict(GRID=grid, ORIGIN=origin, STEP=np.array(step),
                OBS=np.array([[30.0, 3.0], [50.0, -4.0]]),
                GOAL=np.array([70.0, 5.0]), U_W=np.array([0.5, 20.0]),
                U_OFF=np.array([0.0, 0.01]))


def cost_map_vehicle_problem(seed=0, dtype=torch.float64, device="cpu"):
    """A vehicle (states x, y, phi, v; actions acc, curvature) crossing a
    2-D cost map to a goal: the map read by ``blerp`` from the captured 200
    x 200 grid, a ``softplus`` barrier on the speed limit, the goal
    distance by ``hypot`` in a pseudo-Huber pull (``rsqrt``) weighted by a
    ``sigmoid``, a saturating speed reward (``neg`` of ``erf``), the
    lateral acceleration through ``log1p``, an ``expm1`` acceleration cost,
    a ``relu`` curvature limit, the two obstacles' clearance (``expand``,
    ``permute``, ``amin``), the larger scaled action's square (``amax``),
    the actions' product (``prod``) and their cumulated weights
    (``cumsum``, ``mean``), and the speed kept non-negative.  No term has a
    kink at zero actions, the solver's cold start.  Returns (Problem, param
    spec)."""
    import torch.nn.functional as F
    from .ops import interp
    from .optim.ilqr import Problem

    data = cost_map_data(seed)
    GRID, ORIGIN, STEP, OBS, GOAL, U_W, U_OFF = (
        torch.as_tensor(data[k], dtype=dtype, device=device)
        for k in ("GRID", "ORIGIN", "STEP", "OBS", "GOAL", "U_W", "U_OFF"))

    def dynamics(x, u, t, dt, p):
        phi, v = x[..., 2], x[..., 3]
        vel = v.unsqueeze(-1) * torch.stack([torch.cos(phi), torch.sin(phi)],
                                            -1)
        rates = torch.stack([v * u[..., 1], u[..., 0]], -1)
        return torch.cat([vel, rates], -1).view(x.shape)

    def goal_distance(x):
        return torch.hypot(x[..., 0] - GOAL[0], x[..., 1] - GOAL[1])

    def cost(x, u, t, dt, p):
        px, py, phi, v = x.unbind(-1)
        a, kappa = u.unbind(-1)
        cmap = interp.blerp(ORIGIN[0], ORIGIN[1], STEP, STEP, px, py, GRID)
        goal = goal_distance(x)
        pull = goal * goal * torch.rsqrt(1.0 + 0.01 * goal * goal)
        near = torch.sigmoid(0.5 * (goal - 10.0))
        pos = x[..., :2].unsqueeze(-2)
        diff = pos.expand(*pos.shape[:-2], 2, 2) - OBS
        dist2 = (diff * diff).permute(*range(diff.dim() - 2), -1, -2).sum(-2)
        clear = torch.amin(dist2.reshape(*dist2.shape[:-1], 2), -1)
        scaled = (u / torch.stack([p["a_max"], p["kappa_max"]])).flatten(-1)
        return (p["w_map"] * cmap
                + F.softplus(v - p["v_max"], beta=4.0)
                + p["w_goal"] * pull * near
                + torch.neg(torch.erf(v / 8.0))
                + 0.1 * torch.log1p((v * v * kappa) ** 2)
                + 0.1 * torch.expm1(0.125 * a * a)
                + 10.0 * torch.relu(kappa.abs() - 0.15) ** 2
                + 5.0 * torch.exp(-0.05 * clear)
                + 0.1 * torch.amax(scaled.square() + U_OFF, -1)
                + 0.1 * (u * u).prod(-1)
                + torch.cumsum(u * u * U_W, dim=-1).mean(-1))

    def constraints(x, u, t, dt, p):
        return (-x[..., 3]).unsqueeze(-1)

    def end_cost(x, t, dt, p):
        return p["w_goal_end"] * goal_distance(x)

    prob = Problem("cost_map_vehicle", nx=4, nu=2, nc=1, dynamics=dynamics,
                   cost=cost, constraints=constraints, end_cost=end_cost)
    return prob, dict(v_max=10.0, w_map=2.0, w_goal=0.05, w_goal_end=5.0,
                      a_max=3.0, kappa_max=0.3)


def user_problem(name, dtype=torch.float64, device="cpu", H=None, seed=0):
    """(Problem, param spec) of one of USER_PROBLEMS (H: the tracking MPC's
    reference length, its horizon)."""
    if name == "quadratic_tracking_mpc":
        return quadratic_tracking_problem(H or 100, seed, dtype, device)
    return cost_map_vehicle_problem(seed, dtype, device)


# the solver settings of USER_PROBLEMS: horizon, step, iterations, the
# integrator (HEUN = 1), the action limits, the start; and the iterations
# over which solves in another rounding order stay well within 1e-12 of
# the largest |x| and of the cost in float64 (it_exact, single and in a
# batch of spread starts) and within 5e-3 in float32 (it_f32).  On the CPU,
# the plain float64 solves against the JAX package's: the cost map's from
# the cold start 2e-12 apart in x after 4 iterations, 8e-11 after 6, 8e-6
# after its 8 (the rounding grows ~10 x an iteration), and over 64 spread
# starts (x 1e-11 of the largest |x| after 4 iterations, 1e-12 after 3,
# 7e-15 after 2); the tracking MPC's cost 2e-15 after 5 iterations, 9e-13
# after 10, 1e-11 after 20, and over 64 spread starts 3e-13 after 5, 1e-14
# after 3; plain float32 against float64: 8e-5 of the largest |x| after 4
# iterations of the cost map (6e-2 after 5), 8e-7 after 5 of the tracking
# MPC (7e-5 after 10; on an NVIDIA H100, the traced kernel against its
# plain float32 iLQR after 10: 1.4e-1 in x, 3e-3 in cost).
USER_SETTINGS = {
    "quadratic_tracking_mpc": dict(H=100, dt=0.1, it=20, integ=1,
                                   u_lim=[[-3.0, 2.0], [-0.5, 0.5]],
                                   x0=[0.0, 1.0, 0.05, 6.0], it_exact=3,
                                   it_f32=5),
    "cost_map_vehicle": dict(H=80, dt=0.1, it=20, integ=1,
                             u_lim=[[-3.0, 2.0], [-0.3, 0.3]],
                             x0=[0.0, 0.0, 0.0, 6.0], it_exact=2, it_f32=4),
}


def user_solver(name, dtype=torch.float64, device="cpu", H=None,
                max_iterations=None):
    """A :class:`~tpl_tpu_torch.optim.solver.Solver` of one of
    USER_PROBLEMS in ``dtype`` on ``device``, its settings
    (USER_SETTINGS) applied; ``H`` cuts the horizon (and the tracking MPC's
    reference), ``max_iterations`` the iterations."""
    from .optim.solver import Solver

    st = USER_SETTINGS[name]
    H = H or st["H"]
    prob, spec = user_problem(name, dtype, device, H)
    opt = Solver(prob, spec, horizon_max=H, integrator_type=st["integ"],
                 dtype=dtype, device=device)
    opt.horizon = H
    opt.step = st["dt"]
    opt.max_iterations = max_iterations or st["it"]
    for i, (lo, hi) in enumerate(st["u_lim"]):
        opt.u_min[:, i] = lo
        opt.u_max[:, i] = hi
    opt.x[0] = st["x0"]
    return opt


def user_case(name, H=None, seed=0, warm=False):
    """Seeded solve inputs of one of USER_PROBLEMS at horizon H: (inputs,
    params, mu_step)."""
    st = USER_SETTINGS[name]
    H = H or st["H"]
    prob, spec = user_problem(name, H=H)
    rng = np.random.default_rng(seed)
    inputs, mu = generic_inputs(4, 2, prob.nc, H, H, rng, warm, st["u_lim"],
                                1.0, 1e4, st["dt"], st["x0"], 0.1)
    return inputs, dict(spec), mu
