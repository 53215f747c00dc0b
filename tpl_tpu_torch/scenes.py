"""Seeded inputs on which the hand-written kernels are held against their
plain versions: ``chip_smoke.py``, the card tests
(``tests/test_torch_kernel_cuda.py``) and the CPU rehearsal of the kernel
bodies (``tests/test_torch_kernel_rehearsal.py``) all draw from here."""

import numpy as np
import torch

from .planning.dyn_prog import lon_kernel as tlk
from .planning.dyn_prog import poly_lat_kernel as plk

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
