"""The port's IDM sampling planner against the JAX package: the
interpolation helpers and the short angle, the plain rollout and
evaluation against the JAX kernel's lanes forms (``make_idm_kernel(...)
.rollout`` / ``.evaluate``), the object preparation, the selection, and the
planner in ``SimStandalone`` in lock step with the JAX one on
``demo/country_overtake``.

Each case hands the same numpy arrays to both packages; the port runs on the
CPU, where both kernel entries take their plain versions.

Tolerances:

- the helpers: the bracket indices equal, the weights and lerps 1e-6 (the
  JAX two-hot contraction may contract a multiply-add);
- the rollout and evaluation on the scenes of tests/test_idm_kernel.py
  (T = 20-30): rtol = atol = 1e-5, the JAX package's own lanes-vs-vmap
  tolerance there; ``invalid`` equal;
- a T = 100 rollout (the stop-cell, bench, oncoming and hairpin scenes):
  rtol = atol = 1e-4.  The port's transcendentals and
  XLA's (which contracts multiply-adds into FMAs on the CPU) part by an ulp
  now and then, and 99 closed-loop steps carry that forward.  The three
  multiply-adds where XLA's rounding decides when a stopped candidate
  starts again are rounded once in the port too (``fma32``); without that
  stopped candidates restart a few steps apart and the T = 100 rollout
  fails this tolerance;
- the object preparation: equal to 1e-6 (both numpy, the port's projection
  through its C route);
- the selection: equal indices and hysteresis state;
- the loop (the scenario's own vehicle, then with a steering dead time of
  0.18 s on both sides): the selected candidate equal at every replan, ego
  and controls to atol = 1e-3, zero violations and no emergency on both
  sides, the carried plan and dead-time buffer to 1e-4.
"""

import types
import uuid

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpl_tpu.planning.idm_sampling import idm_kernel as jidk
from tpl_tpu.planning.idm_sampling import idm_sampling_planner as jisp
from tpl_tpu.simulation import SimStandalone as JSimStandalone

import tpl_tpu_torch
from tpl_tpu_torch.planning.idm_sampling import idm_kernel as idk
from tpl_tpu_torch.planning.idm_sampling import idm_sampling_planner as isp
from tpl_tpu_torch.scenes import idm_scene, idm_through_states, \
    idm_bench_scene, idm_hairpin_scene
from tpl_tpu_torch.simulation import SimStandalone

PLANNER = "idm_sampling_planner"
RTOL = ATOL = 1e-5
LONG_TOL = 1e-4
LOOP_ATOL = 1e-3
TICKS = 26


def _spec(rl, objs, T):
    O, P, K = objs["hull_preds"].shape[:3]
    return dict(steps_t=T, n_ref=rl.shape[0], n_obj=O, n_pred=P, n_hull=K)


def _jax_objs(objs):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype.kind == "f" else None)
            for k, v in objs.items()}


def _jax_pp(pp):
    return {k: jnp.asarray(v, jnp.float32)
            for k, v in jidk.IdmSamplingParams.dynamic_dict(pp).items()}


def _port_pp(pp):
    return torch.from_numpy(np.array([getattr(pp, k) for k in idk.PP_KEYS],
                                     np.float32))


def _rollouts(rl, objs, pp, init_ref, init_con, l_trgs, d_stops, T):
    """(JAX lanes rollout, port plain rollout), numpy."""
    kern = jidk.make_idm_kernel(_spec(rl, objs, T))
    j = kern.rollout(jnp.asarray(init_ref), jnp.asarray(init_con),
                     jnp.asarray(l_trgs), jnp.asarray(d_stops),
                     jnp.float32(0.1), jnp.asarray(rl), jnp.float32(0.5),
                     _jax_objs(objs), _jax_pp(pp))
    t = torch.from_numpy
    p = idk.rollout_reference(
        t(init_ref), t(init_con), t(l_trgs), t(d_stops),
        torch.tensor(0.1, dtype=torch.float32), t(rl),
        torch.tensor(0.5, dtype=torch.float32), idk.objs_to_torch(objs, "cpu"),
        _port_pp(pp), T)
    return ([np.array(a) for a in j], [a.numpy() for a in p])


def _evaluations(rl, objs, pp, refs, cons, l_trgs, T):
    kern = jidk.make_idm_kernel(_spec(rl, objs, T))
    j = kern.evaluate(jnp.asarray(refs), jnp.asarray(cons),
                      jnp.asarray(l_trgs), _jax_objs(objs), jnp.asarray(rl),
                      jnp.float32(0.5), _jax_pp(pp), jnp.float32(0.0))
    t = torch.from_numpy
    p = idk.evaluate_reference(
        t(np.ascontiguousarray(refs)), t(np.ascontiguousarray(cons)),
        t(l_trgs), idk.objs_to_torch(objs, "cpu"), t(rl),
        torch.tensor(0.5, dtype=torch.float32), _port_pp(pp),
        torch.tensor(0.0, dtype=torch.float32))
    return {k: np.asarray(v) for k, v in j.items()}, idk.costs_dict(p)


# ---------------------------------------------------------------------
# helpers

@pytest.mark.parametrize("t", [-1.0, 0.0, 3.7, 4.0, 9.99, 12.0])
def test_interp_helpers_match_jax(t):
    rng = np.random.default_rng(1)
    ts = np.sort(rng.uniform(0, 10, 16)).astype(np.float32)
    ts[7] = 4.0
    hulls = rng.normal(size=(16, 16, 2)).astype(np.float32)
    vals = rng.normal(size=(16, 4)).astype(np.float32)
    t32 = np.float32(t)
    ji, ja = jidk._bracket_by_t(jnp.asarray(ts), jnp.float32(t32))
    pi, pa = idk._bracket_by_t(torch.from_numpy(ts), torch.tensor(t32))
    assert int(ji) == int(pi)
    np.testing.assert_allclose(float(pa), float(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        idk._two_hot(16, pi, pa, torch.float32).numpy(),
        np.asarray(jidk._two_hot(16, ji, ja, jnp.float32)), atol=1e-6)
    for jf, pf, v in ((jidk._interp_by_t, idk._interp_by_t, vals),
                      (jidk._interp_hulls_by_t, idk._interp_hulls_by_t,
                       hulls)):
        np.testing.assert_allclose(
            pf(torch.from_numpy(ts), torch.from_numpy(v),
               torch.tensor(t32)).numpy(),
            np.asarray(jf(jnp.asarray(ts), jnp.asarray(v), jnp.float32(t32))),
            rtol=1e-6, atol=1e-6)


def test_short_angle_matches_jax():
    """The JAX kernel's ``_short_angle`` (a closure of make_idm_kernel:
    jnp.mod by float32(2 pi), twice), on angles around every branch."""
    rng = np.random.default_rng(2)
    a0 = rng.uniform(-20, 20, 4000).astype(np.float32)
    a1 = (a0 + rng.uniform(-7, 7, 4000)).astype(np.float32)
    a1[:50] = a0[:50]
    a1[50:100] = a0[50:100] + np.float32(2 * np.pi)
    m = 2 * jnp.pi
    da = jnp.mod(jnp.asarray(a1) - jnp.asarray(a0), m)
    want = np.asarray(jnp.mod(2 * da, m) - da)
    got = idk._short_angle(torch.from_numpy(a0), torch.from_numpy(a1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


# ---------------------------------------------------------------------
# the rollout and the evaluation

@pytest.mark.parametrize("stop_cell,T,C", [(True, 30, 48), (False, 20, 24)])
def test_plain_rollout_matches_jax(stop_cell, T, C):
    """The stop cell, the off-road excursions (targets to +-5 m), a stop
    distance on every third candidate (tests/test_idm_kernel.py)."""
    rl, objs, pp, init_ref, init_con = idm_scene(stop_cell=stop_cell)
    l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(np.float32)
    (jr, jc), (pr, pc) = _rollouts(rl, objs, pp, init_ref, init_con, l_trgs,
                                   d_stops, T)
    assert pr.shape == (C, T, 10) and pc.shape == (C, T, 9)
    np.testing.assert_allclose(pr, jr, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scene", ["stop_cell", "bench", "oncoming"])
def test_plain_rollout_t100_matches_jax(scene):
    """99 closed-loop steps: the stop-cell scene (candidates stop and start
    again), the JAX bench's scene (NR=801, O=12, P=16, K=16) at 32 of its
    16,384 candidates, and an oncoming car (a leader of negative speed for
    the candidates that steer into its lane)."""
    if scene == "bench":
        rl, objs, pp, init_ref, init_con, l_trgs, d_stops = \
            idm_bench_scene(16384)
        l_trgs, d_stops = l_trgs[::512].copy(), d_stops[::512].copy()
    else:
        rl, objs, pp, init_ref, init_con = idm_scene(
            stop_cell=scene == "stop_cell", oncoming=scene == "oncoming")
        C = 24
        l_trgs = np.linspace(-5, 5, C).astype(np.float32)
        d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(
            np.float32)
    (jr, jc), (pr, pc) = _rollouts(rl, objs, pp, init_ref, init_con, l_trgs,
                                   d_stops, 100)
    np.testing.assert_allclose(pr, jr, rtol=LONG_TOL, atol=LONG_TOL)
    np.testing.assert_allclose(pc, jc, rtol=LONG_TOL, atol=LONG_TOL)
    if scene == "stop_cell":
        # some candidates stop at the cell and start again
        assert (jc[:, 40:, idk.V_V] == 0.0).any()


@pytest.mark.parametrize("case", ["collider", "rollout", "oncoming"])
def test_plain_evaluate_matches_jax(case):
    """The parked collider with trajectories driven through it (the
    collision screen must hit: tests/test_idm_kernel.py), the JAX rollout
    of the stop-cell scene, and the JAX rollout (T = 100) of an oncoming
    car: the interaction screen's hull tests run and hit, and some
    candidates collide with it, which ends their interaction sums."""
    if case == "collider":
        rl, objs, pp, _, _ = idm_scene(collider=True)
        C, T = 64, 20
        refs, cons = idm_through_states(C, T)
        l_trgs = np.linspace(-3, 3, C).astype(np.float32)
    else:
        rl, objs, pp, init_ref, init_con = idm_scene(
            stop_cell=case == "rollout", oncoming=case == "oncoming")
        C, T = (48, 30) if case == "rollout" else (24, 100)
        l_trgs = np.linspace(-5, 5, C).astype(np.float32)
        d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(
            np.float32)
        (refs, cons), _ = _rollouts(rl, objs, pp, init_ref, init_con, l_trgs,
                                    d_stops, T)
    want, got = _evaluations(rl, objs, pp, refs, cons, l_trgs, T)
    np.testing.assert_array_equal(got["invalid"], want["invalid"])
    for k in idk.COST_KEYS[:4]:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    n_coll, n_inter = idk.evaluate_work(torch.from_numpy(cons),
                                        idk.objs_to_torch(objs, "cpu"),
                                        _port_pp(pp))
    if case == "collider":
        assert want["invalid"].any() and (want["cost_collision"] > 0).any()
        assert n_coll > 0
        # nothing in this scene drives toward the ego
        assert n_inter == 0 and (want["cost_interaction"] == 0).all()
    if case == "oncoming":
        assert n_inter > 0 and (want["cost_interaction"] > 0).any()
        hit = want["cost_collision"] > 0
        assert hit.any() and not hit.all()


@pytest.mark.parametrize("T,C,tol", [(30, 16, RTOL), (100, 24, LONG_TOL)])
def test_plain_hairpin_matches_jax(T, C, tol):
    """The hairpin scene (scenes.idm_hairpin_scene: a ref line that doubles
    back, its legs 8 m apart, a zero-speed stretch, a narrowing and four
    objects, one oncoming): the plain rollout against JAX ``rollout_lanes``
    (1e-5 at T = 30, 1e-4 at T = 100, as the other scenes), then the plain
    evaluation of the JAX rollout against ``evaluate_lanes`` at 1e-5.
    Over 99 steps candidates reach the second leg and stop, and the
    interaction screen's hull tests run and hit."""
    rl, objs, pp, init_ref, init_con = idm_hairpin_scene()
    l_trgs = np.linspace(-5, 5, C).astype(np.float32)
    d_stops = np.where(np.arange(C) % 3 == 0, 30.0, 1e6).astype(np.float32)
    (jr, jc), (pr, pc) = _rollouts(rl, objs, pp, init_ref, init_con, l_trgs,
                                   d_stops, T)
    np.testing.assert_allclose(pr, jr, rtol=tol, atol=tol)
    np.testing.assert_allclose(pc, jc, rtol=tol, atol=tol)
    want, got = _evaluations(rl, objs, pp, jr, jc, l_trgs, T)
    np.testing.assert_array_equal(got["invalid"], want["invalid"])
    for k in idk.COST_KEYS[:4]:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if T == 100:
        half_circle_end = 40.0 + 4.0 * np.pi
        assert (jc[:, -1, idk.V_S] > half_circle_end).any()
        assert (jc[:, -1, idk.V_V] == 0.0).any()
        n_inter = idk.evaluate_work(torch.from_numpy(jc),
                                    idk.objs_to_torch(objs, "cpu"),
                                    _port_pp(pp))[1]
        assert n_inter > 0 and (want["cost_interaction"] > 0).any()


def test_wrappers_take_the_plain_version_on_the_cpu():
    """CPU tensors: both entries (and ``make_idm_kernel``'s ``run``) return
    the plain versions' results, into the buffers given, and launch
    nothing."""
    rl, objs, pp, init_ref, init_con = idm_scene(stop_cell=True)
    C, T = 8, 12
    l_trgs = np.linspace(-3, 3, C).astype(np.float32)
    d_stops = np.full(C, 1e6, np.float32)
    t = torch.from_numpy
    args = (t(init_ref), t(init_con), t(l_trgs), t(d_stops),
            torch.tensor([0.1]), t(rl), torch.tensor([0.5]),
            idk.objs_to_torch(objs, "cpu"), _port_pp(pp))
    before = (idk.rollout_launches, idk.evaluate_launches)
    out = (torch.empty(C, T, 10), torch.empty(C, T, 9))
    refs, cons = idk.rollout(*args, T, out=out)
    assert refs is out[0] and cons is out[1]
    want = idk.rollout_reference(*args[:4], args[4][0], args[5], args[6][0],
                                 args[7], args[8], T)
    assert torch.equal(refs, want[0]) and torch.equal(cons, want[1])
    costs = idk.evaluate(refs, cons, args[2], args[7], args[5], args[6],
                         args[8], torch.tensor([0.0]))
    assert costs.shape == (5, C)
    run = idk.make_idm_kernel(dict(steps_t=T, n_ref=len(rl), n_obj=4,
                                   n_pred=8, n_hull=8))
    r2, c2, costs2 = run(*args, torch.tensor([0.0]))
    assert torch.equal(r2, refs) and torch.equal(costs2, costs)
    assert torch.equal(run.evaluate(refs, cons, args[2], args[7], args[5],
                                    args[6], args[8], torch.tensor([0.0])),
                       costs)
    assert (idk.rollout_launches, idk.evaluate_launches) == before
    with pytest.raises(ValueError):
        idk.rollout(*args[:2], args[2][:3], *args[3:], T)


def _objs_of_shape(O, P, K):
    """Zero objects of O objects, P predictions and K hull points."""
    shapes = dict(pred_t=(O, P), pred_xy=(O, P, 2), pred_heading=(O, P),
                  pred_v=(O, P), pred_dists=(O, P), hull_preds=(O, P, K, 2),
                  hull_projs=(O, P, 4), radius_hull=(O,), valid=(O,),
                  on_local_map=(O,))
    return {k: torch.zeros(shapes[k]) for k in idk.OBJ_KEYS}


@pytest.mark.parametrize("O,P,K", [(0, 8, 8), (17, 8, 8), (4, 17, 8),
                                   (4, 8, 17)])
def test_object_caps_raise_before_the_plain_version(O, P, K):
    """The kernels' object caps (1-16 objects, 2-16 predictions, 1-16 hull
    points, ``csrc/idm_common.cuh``) are checked before the CPU branch, so
    both entries raise on CPU tensors too, naming the limits."""
    rl, objs, pp, init_ref, init_con = idm_scene()
    C, T = 4, 10
    t = torch.from_numpy
    objs = _objs_of_shape(O, P, K)
    args = (t(init_ref), t(init_con), torch.zeros(C), torch.full((C,), 1e6),
            torch.tensor([0.1]), t(rl), torch.tensor([0.5]), objs,
            _port_pp(pp))
    with pytest.raises(ValueError, match="at most"):
        idk.rollout(*args, T)
    with pytest.raises(ValueError, match="at most"):
        idk.evaluate(torch.zeros(C, T, 10), torch.zeros(C, T, 9), args[2],
                     objs, args[5], args[6], args[8], torch.tensor([0.0]))


# ---------------------------------------------------------------------
# the host side

class _Pred:
    def __init__(self, states, uuid_assoc_map):
        self.states = states
        self.uuid_assoc_map = uuid_assoc_map


class _Obj:
    def __init__(self, hull, predictions):
        self.hull = hull
        self.predictions = predictions


def test_prep_objects_matches_jax():
    """Predictions of 3 to 20 points (cut at MAX_PRED), hulls of 4 to 7
    vertices, on and off the local map, more objects than MAX_OBJS."""
    rng = np.random.default_rng(4)
    s = np.linspace(0, 120, 241)
    line = np.column_stack([s, 3.0 * np.sin(s / 25.0)])
    objects = []
    for i in range(15):
        P = int(rng.integers(3, 21))
        t = np.arange(P) * 0.5
        x0, y0 = rng.uniform(0, 100), rng.uniform(-4, 4)
        v = rng.uniform(0, 12)
        yaw = rng.normal(0, 0.2)
        st = np.column_stack([t, x0 + v * t * np.cos(yaw),
                              y0 + v * t * np.sin(yaw),
                              np.full(P, yaw), np.full(P, v)])
        n = int(rng.integers(4, 8))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        hull = np.column_stack([x0 + 2.0 * np.cos(ang),
                                y0 + 1.0 * np.sin(ang)])
        preds = [_Pred(st, "map_a" if i % 4 else "map_b")]
        if i % 5 == 0:
            preds.append(_Pred(st[:1], "map_a"))     # too short: skipped
        objects.append(_Obj(hull, preds))
    want = jisp._prep_objects(objects, "map_a", line)
    got = isp._prep_objects(objects, "map_a", line)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert want["valid"].sum() == isp.MAX_OBJS
    assert (~want["on_local_map"][want["valid"]]).any()


def test_select_matches_jax():
    """Seeded cost sequences through both packages' ``_select`` with the
    decision hysteresis (near ties on every level, invalid candidates)."""
    rng = np.random.default_rng(5)
    cpp = types.SimpleNamespace(dt_decision=0.5)
    states = [types.SimpleNamespace(i_prev=-1, i_min_prev=0, t_decision=0.0)
              for _ in range(2)]
    for step in range(60):
        C = 8
        costs = dict(
            cost_collision=rng.choice([0.0, 0.0, 0.0, 3.0], C),
            cost_interaction=rng.choice([0.0, 0.0, 0.5], C),
            cost_distance=rng.uniform(900, 912, C),
            cost=rng.uniform(0, 10, C),
            invalid=rng.random(C) < 0.15)
        dt = float(rng.choice([0.05, 0.1, 0.2]))
        want = jisp.IdmSamplingPlanner._select(states[0], costs, dt, cpp)
        got = isp.IdmSamplingPlanner._select(states[1], costs, dt, cpp)
        assert got == want, step
        assert vars(states[1]) == vars(states[0]), step


# ---------------------------------------------------------------------
# the closed loop

def _make_sim(cls, dead_time):
    sim = cls(app_id=uuid.uuid4().hex[:8],
              scenario_path="demo/country_overtake")
    store = sim.planning_app.sh_planners
    with store.lock():
        store.active_planner = PLANNER
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True
        if dead_time is not None:
            ss.ego.steer_dead_time = dead_time
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
    out["i_select"] = p.i_prev
    return out


@pytest.fixture(scope="module", params=[None, 0.18])
def loop(request):
    """Both sims in lock step (the demo planning set: lat_steps 3, 8
    candidates of 100 steps, a replan every 0.05 s); the planner's dead time
    is the vehicle's steering dead time: the scenario's own (0), then 0.18 s
    (the demo set's value) on both sides, which runs the dead-time
    integration and buffer.  At tick 11 the port's planner takes the JAX
    planner's carry (``load_carry``).  Keeps each replan's inputs of the
    port."""
    tpl_tpu_torch.use_device("cpu")
    js = _make_sim(JSimStandalone, request.param)
    ts = _make_sim(SimStandalone, request.param)
    jp = js.planning_app.planners[PLANNER]
    tp = ts.planning_app.planners[PLANNER]
    assert type(tp).__module__.startswith("tpl_tpu_torch.")
    ticks, inputs = [], []
    for k in range(TICKS):
        if k == 11:
            tp.load_carry(jp)
        js.update()
        ts.update()
        j, t = _observe(js), _observe(ts)
        if not ticks or t["replan"] != ticks[-1][1]["replan"]:
            inputs.append(tp.last_inputs)
        ticks.append((j, t))
    return ticks, inputs, jp, tp, request.param


def test_loop_selects_the_same_candidate_every_replan(loop):
    ticks, inputs, _, _, _ = loop
    replans = {t["replan"] for _, t in ticks}
    assert len(replans) >= 5, sorted(replans)
    for k, (j, t) in enumerate(ticks):
        assert t["t"] == j["t"] and t["replan"] == j["replan"], k
        assert t["i_select"] == j["i_select"], k


def test_loop_ego_and_controls_agree(loop):
    ticks, _, _, _, _ = loop
    for k, (j, t) in enumerate(ticks):
        assert t["violations"] == [] and j["violations"] == [], k
        assert not t["emergency"] and not j["emergency"], k
        assert np.all(np.isfinite(t["ego"]))
        np.testing.assert_allclose(t["ego"], j["ego"], rtol=0, atol=LOOP_ATOL,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(t["controls"], j["controls"], rtol=0,
                                   atol=LOOP_ATOL, err_msg=f"tick {k}")
    assert ticks[-1][1]["ego"][3] > 8.0


def test_loop_carry_and_kernel_inputs(loop):
    """The carried state agrees after the last tick, and the last replan's
    inputs give the JAX kernel's costs (the demo set's 8 candidates)."""
    _, inputs, jp, tp, dead_time = loop
    for k in ("i_prev", "i_min_prev", "reverse_counter", "enable_reverse"):
        assert getattr(tp, k) == getattr(jp, k), k
    np.testing.assert_allclose(tp.traj_np, jp.traj_np, rtol=0, atol=1e-4)
    if dead_time is None:
        # the scenario's vehicle has no steering dead time: no buffer
        assert tp.dead_time_states is None and jp.dead_time_states is None
    else:
        np.testing.assert_allclose(tp.dead_time_states, jp.dead_time_states,
                                   rtol=0, atol=1e-4)
        # the dead-time integration's 10 states lead the stored plan
        assert len(tp.traj_np) == inputs[-1]["T"] + 10
    assert tp.latch.counter == jp.latch.counter == 0
    inp = inputs[-1]
    assert len(inp["l_trgs"]) == 8 and inp["T"] == 100
    refs, cons, costs = isp.run_kernels(
        inp["init_ref"], inp["init_con"], inp["l_trgs"], inp["d_stops"],
        inp["dt_replan"], inp["ref_line"], inp["ref_step"], inp["objs"],
        inp["pp"], inp["l_trg_global"], inp["T"], torch.device("cpu"))
    kern = jidk.make_idm_kernel(_spec(inp["ref_line"], inp["objs"], 100))
    jpp = {k: jnp.float32(v) for k, v in zip(idk.PP_KEYS, inp["pp"])}
    jr, jc, jcost = kern(
        jnp.asarray(inp["init_ref"]), jnp.asarray(inp["init_con"]),
        jnp.asarray(inp["l_trgs"]), jnp.asarray(inp["d_stops"]),
        jnp.float32(inp["dt_replan"]), jnp.asarray(inp["ref_line"]),
        jnp.float32(inp["ref_step"]), _jax_objs(inp["objs"]), jpp,
        jnp.float32(inp["l_trg_global"]))
    np.testing.assert_allclose(cons, np.asarray(jc), rtol=LONG_TOL,
                               atol=LONG_TOL)
    got = idk.costs_dict(costs)
    for k in idk.COST_KEYS:
        np.testing.assert_allclose(got[k].astype(float),
                                   np.asarray(jcost[k]).astype(float),
                                   rtol=LONG_TOL, atol=LONG_TOL, err_msg=k)


def test_the_loop_launches_no_kernel_on_the_cpu(loop):
    assert idk.rollout_launches == idk.evaluate_launches == 0
