"""The port's four host C routes (``tpl_tpu_torch/native``) against their
numpy oracles in the port and against the JAX package's functions, on the
CPU (needs only ``g++``).

Each route gets the same seeded numpy inputs three ways: the port with the
C route on, the port with ``native.enable(False)`` (the numpy oracle) and
the ``tpl_tpu`` function.  Tolerances: the C code keeps the oracle's
operations and their order and is built with ``-ffp-contract=off``, so
integers, flags and the two rampify routes are equal (0.0); the float fields
of ``project`` and ``resample`` get 1e-12, because numpy forms the same
dot products and norms through ``einsum`` / ``linalg.norm`` / ``@``, whose
accumulation (vectorised, possibly fused) may round the last bit another
way than the C loop (measured on the card's host: 2.3e-13 in ``resample``).

    python -m pytest tests/test_torch_native.py -q
"""

import contextlib
import os

import numpy as np
import pytest

from tpl_tpu.ops import geometry as j_geometry
from tpl_tpu.ops import profile as j_profile
from tpl_tpu.planning.path_vel_decomp import path_optim as j_path_optim

from tpl_tpu_torch import _build, native
from tpl_tpu_torch.ops import geometry, profile
from tpl_tpu_torch.planning.path_vel_decomp import path_optim

FLOAT_ATOL = 1e-12
PROJ_INT = ("start", "end", "index", "in_bounds")
PROJ_FLOAT = ("alpha", "point", "distance", "arc_len", "angle", "tangent")


@contextlib.contextmanager
def numpy_route():
    was = native.enable(False)
    try:
        yield
    finally:
        native.enable(was)


def three_ways(port_fn, jax_fn, *args):
    """(C route, the port's numpy oracle, the JAX package) on ``args``; the
    C route must have been taken exactly where it was on."""
    before = dict(native.calls)
    c = port_fn(*args)
    took = {k: native.calls[k] - before[k] for k in native.ROUTES}
    with numpy_route():
        mid = dict(native.calls)
        oracle = port_fn(*args)
        assert native.calls == mid, "the oracle reached the C route"
    return c, oracle, jax_fn(*args), took


# ---------------------------------------------------------------------
# project

def _polyline(rng, n):
    return np.cumsum(rng.normal(0, 1.0, (n, 2)), axis=0)


PROJECT_CASES = {
    "open": lambda rng: (_polyline(rng, 40), rng.normal(0, 5.0, (17, 2)),
                         False),
    "closed": lambda rng: (_polyline(rng, 23), rng.normal(0, 5.0, (17, 2)),
                           True),
    "two_points": lambda rng: (_polyline(rng, 2), rng.normal(0, 3.0, (5, 2)),
                               False),
    "beyond_both_ends": lambda rng: (
        np.column_stack([np.arange(6.0), np.zeros(6)]),
        np.array([[-3.0, 1.0], [9.0, -2.0], [2.5, 0.0], [2.0, 0.0]]), False),
    # (0.5, 0.5) is equally far from both legs of the corner, (2, 2) from
    # every segment's clamped end: the first minimum wins
    "exact_ties": lambda rng: (
        np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
        np.array([[0.5, 0.5], [2.0, 2.0], [0.25, 0.75], [1.0, 0.0]]), True),
    "single_position": lambda rng: (_polyline(rng, 12), rng.normal(0, 2.0, 2),
                                    False),
    "duplicate_vertex": lambda rng: (
        np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [2.0, 1.0]]),
        rng.normal(1.0, 1.0, (6, 2)), False),
}


@pytest.mark.parametrize("case", sorted(PROJECT_CASES))
def test_project_route(case):
    rng = np.random.default_rng(len(case))
    pts, pos, closed = PROJECT_CASES[case](rng)
    c, oracle, jax_res, took = three_ways(
        geometry._project_core, j_geometry._project_core, pts, pos, closed)
    assert took["project"] == 1
    for ref in (oracle, jax_res):
        for k in PROJ_INT:
            np.testing.assert_array_equal(c[k], ref[k], err_msg=k)
            assert c[k].dtype == ref[k].dtype
        for k in PROJ_FLOAT:
            np.testing.assert_allclose(c[k], ref[k], rtol=0,
                                       atol=FLOAT_ATOL, err_msg=k)
    if case == "exact_ties":
        assert c["start"][0] == 0 and c["end"][0] == 1


@pytest.mark.parametrize("n", [0, 1])
def test_project_degenerate_polyline_stays_numpy(n):
    """Fewer than two vertices: no segment, the default projection with an
    infinite distance, on either setting and in the JAX package."""
    pts = np.arange(2.0 * n).reshape(n, 2) + 3.0
    pos = np.array([[1.0, 2.0], [0.0, 0.0]])
    c, oracle, jax_res, took = three_ways(
        geometry._project_core, j_geometry._project_core, pts, pos, False)
    assert took["project"] == 0
    for ref in (oracle, jax_res):
        for k in PROJ_INT + PROJ_FLOAT:
            np.testing.assert_array_equal(c[k], ref[k], err_msg=k)
    assert np.all(np.isinf(c["distance"])) and not c["in_bounds"].any()
    with pytest.raises(ValueError, match="two vertices"):
        native.project(pts, pos)


# ---------------------------------------------------------------------
# resample

def _wavy(n, cols=2):
    s = np.linspace(0.0, 60.0, n)
    out = np.zeros((n, cols))
    out[:, 0], out[:, 1] = s, 4.0 * np.sin(s * 0.15)
    return out


def _loop(n):
    a = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.column_stack([30.0 * np.cos(a), 20.0 * np.sin(a)])


RESAMPLE_CASES = {
    "open": (_wavy(50), 0.5, 100, 0, False),
    "open_past_the_end": (_wavy(20), 1.0, 90, 0, False),
    "open_start_7_six_columns": (_wavy(50, 6), 0.7, 40, 7, False),
    "open_start_clamped": (_wavy(30), 0.5, 10, 400, False),
    "closed_two_laps": (_loop(40), 1.5, 250, 3, True),
    "closed_negative_start": (_loop(17), 2.0, 30, -5, True),
    "duplicates_dropped": (np.repeat(_wavy(25), 2, axis=0), 0.5, 60, 0,
                           False),
    "one_point": (np.array([[2.0, 3.0]]), 0.5, 8, 0, False),
    "all_the_same_point": (np.tile([[2.0, 3.0]], (4, 1)), 0.5, 8, 0, False),
    "one_step": (_wavy(10), 0.5, 1, 2, False),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_route(case):
    args = RESAMPLE_CASES[case]
    c, oracle, jax_res, took = three_ways(geometry.resample,
                                          j_geometry.resample, *args)
    assert took["resample"] == 1
    for ref in (oracle, jax_res):
        assert c.shape == ref.shape
        np.testing.assert_array_equal(c[:, 3:], ref[:, 3:])
        np.testing.assert_allclose(c[:, :3], ref[:, :3], rtol=0,
                                   atol=FLOAT_ATOL)


@pytest.mark.parametrize("pts,steps", [(np.zeros((0, 2)), 5),
                                       (_wavy(10), 0)])
def test_resample_of_nothing_is_empty(pts, steps):
    c, oracle, jax_res, took = three_ways(geometry.resample,
                                          j_geometry.resample, pts, 0.5, steps)
    assert took["resample"] == 0
    assert c.shape == oracle.shape == jax_res.shape == (0, 5)
    assert native.resample(pts, 0.5, steps).shape == (0, 5)


def test_resample_failure_raises_on_both_routes():
    """A sampling circle that no later segment of a closed path reaches."""
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    with pytest.raises(RuntimeError):
        geometry.resample(pts, 50.0, 5, 0, True)
    with numpy_route(), pytest.raises(RuntimeError):
        geometry.resample(pts, 50.0, 5, 0, True)


# ---------------------------------------------------------------------
# rampify_profile

def _limits(rng, n, nan_at=None):
    lim = np.maximum(0.2, 10.0 + np.cumsum(rng.normal(0.0, 1.0, n)))
    lim[n // 3:n // 3 + 6] = 2.0
    if nan_at is not None:
        lim[nan_at] = np.nan
    return lim


PROFILE_CASES = {
    "both_given": (8.0, 0.3, 250, None),
    "v0_none": (None, 0.0, 250, None),
    "a0_none": (6.0, None, 250, None),
    "both_none": (None, None, 100, None),
    "below_v_min": (0.0, -0.5, 64, None),
    "two_steps": (3.0, 0.0, 2, None),
    "one_step": (3.0, None, 1, None),
    "nan_limit": (8.0, 0.0, 120, 70),
    "nan_last_limit": (None, None, 50, 49),
}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_rampify_profile_route(case):
    v0, a0, n, nan_at = PROFILE_CASES[case]
    lim = _limits(np.random.default_rng(n), n, nan_at)
    with np.errstate(invalid="ignore"):
        c, oracle, jax_res, took = three_ways(
            profile.rampify_profile, j_profile.rampify_profile, v0, a0, lim,
            -2.5, 2.5, -1.5, 1.5, 1.0, 0.5)
    assert took["rampify_profile"] == 1
    assert c.shape == (n, 2)
    np.testing.assert_array_equal(c, oracle)       # NaN rows count as equal
    np.testing.assert_array_equal(c, jax_res)
    if nan_at is None:                 # (min / max may swallow a NaN limit)
        assert np.all(np.isfinite(c))
    with pytest.raises(ValueError, match="non-empty"):
        native.rampify_profile(v0, a0, lim[:0], -2.5, 2.5, -1.5, 1.5, 1.0,
                               0.5)


# ---------------------------------------------------------------------
# rampify_corridor

def _corridor(rng, n, horizon, flat=False):
    path = np.zeros((n, 6))
    path[:, 5] = rng.uniform(0.0, 12.0, n)
    path[n // 2, 5] = 0.0                   # the 1e-8 velocity floor
    lower = np.full(n, -3.0)
    upper = np.full(n, 3.0)
    if not flat:
        lower[horizon // 3:horizon // 3 + 12] = 0.5
        lower[horizon - 9:horizon - 4] = 1.0
        upper[horizon // 2:horizon // 2 + 20] = 2.0
    return 0.5, horizon, 20.0, float(rng.normal(0.0, 0.5)), path, 2.0, \
        lower, upper


CORRIDOR_CASES = {"full": (250, 250, False), "short_horizon": (250, 180, False),
                  "flat": (64, 64, True), "one_step": (4, 1, False),
                  "two_steps": (6, 2, False)}


@pytest.mark.parametrize("case", sorted(CORRIDOR_CASES))
def test_rampify_corridor_route(case):
    n, horizon, flat = CORRIDOR_CASES[case]
    args = _corridor(np.random.default_rng(n + horizon), n, horizon, flat)
    c, oracle, jax_res, took = three_ways(
        path_optim.rampify_corridor, j_path_optim.rampify_corridor, *args)
    assert took["rampify_corridor"] == 1
    assert c.shape == (n,)
    np.testing.assert_array_equal(c, oracle)
    np.testing.assert_array_equal(c, jax_res)
    np.testing.assert_array_equal(c[horizon:], -10.0)
    with pytest.raises(ValueError, match="horizon"):
        native.rampify_corridor(*args[:1], n + 1, *args[2:])


# ---------------------------------------------------------------------
# the loader

def test_library_is_built_beside_the_repo_and_loaded_once():
    lib = native.get_lib()
    assert lib is native.get_lib()
    built = [f for f in os.listdir(_build.BUILD_DIR)
             if f.startswith("hostops_") and f.endswith(".so")]
    assert built
    assert _build.BUILD_DIR.endswith(os.path.join("build", "tpl_tpu_torch"))


@pytest.mark.parametrize("fault", ["syntax_error", "no_compiler",
                                   "no_source"])
def test_broken_build_raises_and_does_not_fall_back(fault, tmp_path,
                                                    monkeypatch):
    """A source that does not compile, a missing compiler or a missing
    source raise with the reason; the hook does not take the numpy path
    instead."""
    src = tmp_path / "hostops.cpp"
    if fault != "no_source":
        body = open(native.SOURCE).read()
        src.write_text(body + ("\nthis is not C++\n"
                               if fault == "syntax_error" else "\n// x\n"))
    if fault == "no_compiler":
        monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "_lib", None)
    match = {"syntax_error": "building hostops.cpp failed",
             "no_compiler": "not found", "no_source": "not found"}[fault]
    pts = _wavy(10)
    before = dict(native.calls)
    for call in (lambda: geometry._project_core(pts, [[1.0, 1.0]], False),
                 lambda: geometry.resample(pts, 0.5, 5),
                 lambda: profile.rampify_profile(
                     3.0, 0.0, np.full(8, 5.0), -2.5, 2.5, -1.5, 1.5, 1.0,
                     0.5)):
        with pytest.raises(RuntimeError, match=match) as err:
            call()
        if fault == "syntax_error":
            assert "error" in str(err.value)      # the compiler's output
    assert native.calls == before
    assert not [f for f in os.listdir(_build.BUILD_DIR) if ".tmp" in f]


def test_enable_returns_the_previous_setting():
    assert native.enabled()
    assert native.enable(False) is True
    assert not native.enabled()
    assert native.enable(True) is False
    assert native.enabled()
