"""The port's DP environment (Frenet grid build) against the JAX package.

Same seeded ref lines and quads go to both packages.  Occupancy must be
exactly equal (values 0/1/2/3); the longitudinal distance map agrees to
atol=1e-3 (both are float32; the cell positions come from float32
sin / cos, which may differ by an ulp between XLA and PyTorch).
"""

import numpy as np
import pytest

from tpl_tpu.planning.dyn_prog import dp_environment as jdpe

import tpl_tpu_torch
from tpl_tpu_torch.planning.dyn_prog import dp_environment as tdpe

DIST_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu_device():
    tpl_tpu_torch.use_device("cpu")


def _ref_line(rng, n=420, curved=True, semantic=False):
    rl = np.zeros((n, 9))
    s = np.arange(n) * 0.5
    k = rng.uniform(-0.01, 0.01) if curved else 0.0
    h = rng.uniform(-np.pi, np.pi) + k * s
    dx, dy = np.cos(h) * 0.5, np.sin(h) * 0.5
    rl[:, 0] = 300.0 + np.cumsum(dx)
    rl[:, 1] = -150.0 + np.cumsum(dy)
    rl[:, 2] = h
    rl[:, 3] = s
    rl[:, 4] = k
    rl[:, 5] = rng.uniform(8.0, 15.0, n)
    rl[rng.integers(0, n, 5), 5] = 0.05              # zero-speed cells
    rl[:, 6] = rng.uniform(2.0, 4.5, n)
    rl[:, 7] = rng.uniform(2.0, 4.5, n)
    if semantic:
        i0 = rng.integers(100, 250)
        rl[i0:i0 + 30, 8] = 1.0
    return rl


def _quads_along(rl, rng, n, stationary):
    """Seeded boxes on the road, in cartesian coordinates, with times."""
    out = []
    for _ in range(n):
        i = rng.integers(20, len(rl) - 40)
        l0 = rng.uniform(-3.0, 2.0)
        ln, w = rng.uniform(2.0, 8.0), rng.uniform(1.0, 2.5)
        h = rl[i, 2]
        t_ = np.array([np.cos(h), np.sin(h)])
        nrm = np.array([-np.sin(h), np.cos(h)])
        p = rl[i, :2] + l0 * nrm
        quad = np.array([p, p + ln * t_, p + ln * t_ + w * nrm, p + w * nrm])
        if rng.uniform() < 0.5:
            quad = quad[::-1].copy()                 # CW: made CCW inside
        t = 0.0 if stationary else float(rng.integers(0, 12))
        out.append((quad, t))
    return out


def _params(pkg, rng):
    p = pkg.DpEnvParams()
    p.dt_start = float(rng.uniform(0.2, 1.0))
    p.dilation = float(rng.uniform(0.5, 1.5))
    p.l_min, p.l_max = -5.0, 5.0
    return p


def _both(seed, n_stat, n_move, semantic=False):
    rng = np.random.default_rng(seed)
    rl = _ref_line(rng, semantic=semantic)
    stat = _quads_along(rl, rng, n_stat, True)
    move = _quads_along(rl, rng, n_move, False)
    prm_seed = int(rng.integers(1 << 30))
    envs = []
    for pkg in (jdpe, tdpe):
        env = pkg.DpEnvironment()
        env.reinit_buffers(_params(pkg, np.random.default_rng(prm_seed)))
        env.set_ref_line(rl, 0.5)
        env.insert_geometry(stat, stationary=True)
        env.insert_geometry(move, stationary=False)
        env.update()
        envs.append(env)
    return envs


CASES = [
    ("stationary", dict(seed=0, n_stat=12, n_move=0)),
    ("time_sliced", dict(seed=1, n_stat=0, n_move=40)),
    ("mixed_offroad", dict(seed=2, n_stat=6, n_move=30)),
    ("intersection", dict(seed=3, n_stat=2, n_move=25, semantic=True)),
    ("max_quads_cap", dict(seed=4, n_stat=50, n_move=200)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_build_grids_matches_jax(name, kw):
    jenv, tenv = _both(**kw)
    occ_j, occ_t = jenv.get_occ_map(), tenv.get_occ_map()
    assert occ_t.dtype == np.float32 and occ_t.shape == occ_j.shape
    np.testing.assert_array_equal(occ_t, occ_j)
    # every cell value the case is meant to produce is present
    assert {0.0, 2.0} <= set(np.unique(occ_t))
    if kw["n_stat"]:
        assert 3.0 in occ_t
    if kw["n_move"]:
        assert 1.0 in occ_t
    np.testing.assert_allclose(tenv.get_dist_map_lon(),
                               jenv.get_dist_map_lon(), atol=DIST_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tenv.grid.ref_line.numpy(),
                                  np.asarray(jenv.grid.ref_line))
    if name == "max_quads_cap":
        assert len(tenv._quads) > tdpe.DpEnvironment.MAX_QUADS
        assert tdpe.DpEnvironment.MAX_QUADS == jdpe.DpEnvironment.MAX_QUADS


def test_intersection_closure_blocks_road_width():
    """An occupied intersection cell closes every inner l cell of that s
    in that time slice (env.cu:65-93), in both packages alike."""
    jenv, tenv = _both(seed=3, n_stat=0, n_move=25, semantic=True)
    occ = tenv.get_occ_map()
    sem = np.round(tenv.grid.ref_line.numpy()[:, tdpe.RL_SEM])
    assert sem.max() == 1.0
    closed = np.all(occ[:, :, 1:-1] >= 1.0, axis=-1)
    assert closed.any()
    np.testing.assert_array_equal(occ, jenv.get_occ_map())


def test_device_inputs_match():
    """The packed grid-build inputs agree field by field."""
    jenv, tenv = _both(seed=5, n_stat=3, n_move=10)
    for a, b in zip(jenv.device_inputs(), tenv.device_inputs()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ref_line_coverage_check():
    env = tdpe.DpEnvironment()
    env.reinit_buffers(tdpe.DpEnvParams())
    env.set_ref_line(np.zeros((100, 9)), 0.5)          # 50 m < s_max 200
    with pytest.raises(RuntimeError):
        env.device_inputs()


def test_device_is_explicit():
    """An unset device is the card: without one it raises and stays unset,
    and only ``use_device("cpu")`` leads to the CPU."""
    import torch

    saved = tpl_tpu_torch._DEVICE
    tpl_tpu_torch._DEVICE = None
    try:
        if torch.cuda.is_available():
            assert tpl_tpu_torch.device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tpl_tpu_torch.device()
            assert tpl_tpu_torch._DEVICE is None
        assert tpl_tpu_torch.use_device("cpu").type == "cpu"
        assert tpl_tpu_torch.device().type == "cpu"
    finally:
        tpl_tpu_torch._DEVICE = saved
