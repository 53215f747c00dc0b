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


def dp_random_occ(seed, T=10, S=201, L=21, density=0.1):
    """A seeded occupancy grid (T, S, L) float32 of the four cell values
    (0 free, 1 moving, 2 blocked, 3 stationary), ``density`` of it
    occupied."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(1, 4, (T, S, L)).astype(np.float32)
    return np.where(rng.random((T, S, L)) < density, occ,
                    np.float32(0.0)).astype(np.float32)


def dp_poly_keys():
    """The four (ds, l) start indices the graph DP's checks take at the
    demo widths (15 ds x 21 l): slow and centred, a level-2 cap at ds 3 and
    7 (469,335 and 577,838 edges uncapped), fast and off centre."""
    return [(1, 10), (3, 10), (7, 10), (12, 4)]


def dp_poly_propagation_case(seed, n1=40, e2=300, ties=True, nan=True):
    """A seeded two-level graph for the propagation: a root with ``n1``
    edges, level 1's nodes with ``e2`` edges among them (some nodes have
    none), float32 points; with ``ties`` the costs take few values (equal
    least costs in a node's range), with ``nan`` a NaN cost among level 2's
    and one among level 1's.  Returns (node point arrays (float64, one per
    level), edge start arrays (int32, one per level))."""
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
    return pts, [np.zeros(n1, np.int32), starts2]


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
