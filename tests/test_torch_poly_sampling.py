"""The port's Frenet polynomial sampling planner against the JAX package:
the candidate grid, the plain kernel against the JAX kernel's ``run`` (also
the winner where costs are NaN: the first NaN) and against the numpy
oracle ``_eval_candidates``, the obstacle packing and
the SAT helper, and the planner in ``SimStandalone`` in lock step with the
JAX one on ``demo/country_follow``.

The port runs on the CPU, where the kernel entry takes its plain version.

Tolerances: the grid exactly; the plain kernel against the JAX kernel (the
same float64 operations; XLA's dot and the port's matrix product sum the
coefficient solves in their own orders) the winner's index equal, its rows
to 1e-9 and its cost to rtol 1e-12; against the numpy oracle (all float64,
another collision screen) the winner equal, rows to 1e-4 as
tests/test_poly_kernel.py; the loop: the clock and every winning
trajectory to 1e-6, ego and controls to atol = 1e-3, zero violations and
no emergency.
"""

import uuid

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpl_tpu.planning.poly_sampling import poly_kernel as jpok
from tpl_tpu.planning.poly_sampling import poly_sampling_planner as jpsp
from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.planning.poly_sampling import poly_kernel as pok
from tpl_tpu_torch.planning.poly_sampling import poly_sampling_planner as psp
from tpl_tpu_torch.scenes import poly_scene
from tpl_tpu_torch.simulation import SimStandalone

PLANNER = "poly_sampling_planner"
ROW_TOL = 1e-9
ORACLE_TOL = 1e-4
LOOP_ATOL = 1e-3
TICKS = 66
ROWS = ("x", "y", "yaw", "s", "s_d", "s_dd", "d", "d_d", "d_dd", "c", "ds")


def _jax_pp(pp):
    q = jpsp.PolySamplingParams()
    for k, v in vars(pp).items():
        setattr(q, k, v)
    return q


@pytest.mark.parametrize("s_d", [0.0, 7.6, 8.0, 12.49])
def test_candidate_grid_matches_jax(s_d):
    start, _, _, pp = poly_scene()
    start = dict(start, s_d=s_d)
    for a, b in zip(psp.candidate_grid(start, pp),
                    jpsp.candidate_grid(start, _jax_pp(pp))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene", ["obstacles", "free", "bench"])
def test_plain_kernel_matches_jax_and_oracle(scene):
    """tests/test_poly_kernel.py's scenes (C=30, N=25) and the JAX bench's
    (500 path points, 8 obstacles)."""
    start, path, obs, pp = poly_scene(obstacles=scene == "obstacles",
                                      bench=scene == "bench")
    tpl_tpu_torch.use_device("cpu")
    got = psp._eval_candidates_device(start, path, obs, pp)
    want = jpsp._eval_candidates_device(start, path, obs, _jax_pp(pp))
    oracle = psp._eval_candidates(start, path, obs, pp)
    assert got["best"] == oracle["best"]
    np.testing.assert_array_equal(got["t"], want["t"])
    assert got["cost"] == pytest.approx(want["cost"], rel=1e-12)
    assert got["cost"] == pytest.approx(oracle["cost"], rel=ORACLE_TOL)
    for k in ROWS:
        np.testing.assert_allclose(got[k], want[k], rtol=ROW_TOL,
                                   atol=ROW_TOL, err_msg=k)
        np.testing.assert_allclose(got[k], oracle[k], rtol=ORACLE_TOL,
                                   atol=ORACLE_TOL, err_msg=k)
    if scene != "free":
        # the direct lane is blocked: the winner evades without a penalty
        assert got["cost"] < pok.PENALTY


def test_plain_kernel_index_and_factory_match_jax():
    """The JAX factory's signature, host arrays in: the packed rows and
    the cost; the entry's winner index against the oracle's, no launch."""
    start, path, obs, pp = poly_scene()
    di, Ti, tv, ts = psp.candidate_grid(start, pp)
    hulls, valid = pok.pack_obstacles(obs)
    sv = np.array([start[k] for k in ("d", "d_d", "d_dd", "s", "s_d",
                                      "s_dd")], np.float32)
    args = (sv, di, Ti, tv, ts, np.asarray(path, np.float32), hulls, valid,
            pok.pack_pp(pp))
    jrun = jpok.make_poly_sampling_kernel(len(di), len(ts), len(path),
                                          *hulls.shape[:2])
    jp, jc = jrun(*args)
    tpl_tpu_torch.use_device("cpu")
    prun = pok.make_poly_sampling_kernel(len(di), len(ts), len(path),
                                         *hulls.shape[:2])
    pp_, pc = prun(*args)
    assert pp_.dtype == torch.float64 and pp_.shape == (11, len(ts))
    np.testing.assert_allclose(pp_.numpy(), np.asarray(jp), rtol=ROW_TOL,
                               atol=ROW_TOL)
    assert float(pc) == pytest.approx(float(jc), rel=1e-12)
    before = pok.launches
    a = psp.device_inputs(start, path, obs, pp, "cpu")
    _, cost, best = pok.run(*a)
    assert pok.launches == before
    assert int(best) == psp._eval_candidates(start, path, obs, pp)["best"]
    assert float(cost) == float(pc)


@pytest.mark.parametrize("nan_at", [(17,), (23, 9)])
def test_plain_and_jax_pick_the_first_nan(nan_at):
    """Candidates whose end offset is NaN (so their cost is NaN): the JAX
    ``run`` (``jnp.argmin``) and the plain version (``torch.argmin``) both
    pick the first NaN, not the least finite cost.  The JAX winner's index
    is the candidate whose rows, evaluated alone, are its rows."""
    start, path, obs, pp = poly_scene()
    tpl_tpu_torch.use_device("cpu")
    a = [x.clone() for x in psp.device_inputs(start, path, obs, pp, "cpu")]
    finite = int(pok.run_reference(*a)[2])
    for j in nan_at:
        a[1][j] = float("nan")
    packed, cost, best = pok.run(*a)
    assert int(best) == min(nan_at) != finite and torch.isnan(cost)
    n = [x.numpy() for x in a]
    n[7] = n[7] != 0.0
    jrun = jpok.make_poly_sampling_kernel(len(n[1]), len(n[4]), len(n[5]),
                                          *n[6].shape[:2])
    jp, jc = jrun(*n)
    assert np.isnan(float(jc))

    def alone(c):
        b = list(a)
        for i in (1, 2, 3):
            b[i] = a[i][c:c + 1].contiguous()
        return pok.run_reference(*b)[0].numpy()

    picked = [c for c in range(len(n[1]))
              if np.allclose(alone(c), np.asarray(jp), rtol=ROW_TOL,
                             atol=ROW_TOL, equal_nan=True)]
    assert picked == [int(best)]
    np.testing.assert_allclose(packed.numpy(), np.asarray(jp), rtol=ROW_TOL,
                               atol=ROW_TOL)


def test_pack_obstacles_and_sat_match_jax():
    obs = [dict(hull=np.array([[0., 0.], [1., 0.], [1., 1.]])),
           dict(hull=np.array([[5., 5.], [7., 5.], [7., 7.], [5., 7.],
                               [4.5, 6.0]])),
           dict(hull=np.array([[9., 9.], [9.1, 9.]]))]
    for a, b in zip(pok.pack_obstacles(obs), jpok.pack_obstacles(obs)):
        np.testing.assert_array_equal(a, b)
    assert pok.pack_obstacles([])[0].shape == (0, 3, 2)
    rng = np.random.default_rng(6)
    ang = np.linspace(0, 2 * np.pi, 6)[:-1]
    base = np.column_stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    a = base[None] + rng.uniform(-2, 2, (200, 1, 2)).astype(np.float32)
    b = (base * 1.5)[None] + rng.uniform(-2, 2, (200, 1, 2)).astype(
        np.float32)
    want = np.asarray(jpok.hulls_intersect(jnp.asarray(a), jnp.asarray(b)))
    got = pok.hulls_intersect(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------
# the closed loop

def _make_sim(cls):
    sim = cls(app_id=uuid.uuid4().hex[:8],
              scenario_path="demo/country_follow")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = PLANNER
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
    return sim


def _observe(sim):
    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        out = dict(t=s.t, ego=np.array([s.ego.x, s.ego.y, s.ego.yaw, s.ego.v,
                                        s.ego.a, s.ego.steer_angle]),
                   violations=list(s.rule_checker.violations))
    with sim.control_app.sh_controllers.lock():
        out["controls"] = np.array(sim.control_app.sh_controllers.controls)
    with sim.planning_app.sh_planners.lock():
        out["emergency"] = sim.planning_app.sh_planners.trajectory.emergency
    p = sim.planning_app.planners[PLANNER]
    out["replan"] = p.last_update_time
    out["traj"] = None if p.poly_traj is None else {
        k: np.array(p.poly_traj[k]) for k in ROWS}
    return out


@pytest.fixture(scope="module")
def loop():
    """Both sims in lock step (the demo planning set: 2 d x 1 T x 3 v
    candidates of 25 steps, a replan every 0.2 s)."""
    tpl_tpu_torch.use_device("cpu")
    js, ts = _make_sim(JSimStandalone), _make_sim(SimStandalone)
    assert type(ts.planning_app.planners[PLANNER]).__module__.startswith(
        "tpl_tpu_torch.")
    ticks = []
    for _ in range(TICKS):
        js.update()
        ts.update()
        ticks.append((_observe(js), _observe(ts)))
    return ticks


def test_loop_picks_the_same_trajectory_every_replan(loop):
    replans = set()
    for k, (j, t) in enumerate(loop):
        assert t["t"] == j["t"] and t["replan"] == j["replan"], k
        replans.add(t["replan"])
        assert (t["traj"] is None) == (j["traj"] is None), k
        if t["traj"] is not None:
            for r in ROWS:
                np.testing.assert_allclose(t["traj"][r], j["traj"][r],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"tick {k} {r}")
    assert len(replans) >= 4, sorted(replans)


def test_loop_ego_and_controls_agree(loop):
    for k, (j, t) in enumerate(loop):
        assert t["violations"] == [] and j["violations"] == [], k
        assert not t["emergency"] and not j["emergency"], k
        np.testing.assert_allclose(t["ego"], j["ego"], rtol=0, atol=LOOP_ATOL,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(t["controls"], j["controls"], rtol=0,
                                   atol=LOOP_ATOL, err_msg=f"tick {k}")
    assert loop[-1][1]["ego"][3] > 7.0


def test_the_loop_launches_no_kernel_on_the_cpu(loop):
    assert pok.launches == 0
