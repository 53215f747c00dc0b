"""The tracer (``tpl_tpu_torch/optim/trace.py``): torch problems traced into
the generic AL-iLQR kernel's problem struct, rehearsed on the CPU.

The fixture traces the seven native problems of
``tpl_tpu_torch/optim/problems.py``, the three examples' problems
(``tpl_tpu_torch/examples/{crane_2d,simple_vehicle,solver_crosscheck}``)
and a problem built on the kinks of ``where``, ``maximum`` / ``minimum``,
``clamp`` and ``abs``, and compiles every printed struct with
``csrc/ilqr_generic.cu`` in one g++ translation unit against the stand-in
CUDA runtime of tests/test_torch_kernel_rehearsal.py (its ``STUB``; the
harness of tests/test_torch_ilqr_generic.py, and an entry that evaluates a
struct's four functions on the kernel's second-order jets).  Inputs are
seeded with numpy.

- (a) Each struct's functions, evaluated at seeded points (and, for the
  kink problem, at points placed on each kink), equal the plain torch
  functions' values, and their jets (gradient and Hessian over (x, u))
  equal ``torch.func`` derivatives of the plain functions, at 1e-12.
- (b) Each struct's body, in double, solves within RTOL = ATOL = 1e-12 of
  the plain float64 ``make_update_fn`` with equal ``mu_step`` and
  iteration counts (the vehicle over its first 10 iterations, and over its
  own 30 at VEHICLE_TOL: see there); each native problem's traced struct also within 1e-12
  of its hand-written struct (``ilqr_generic.NATIVE``) on the same inputs.
- (c) The crane, vehicle and unicycle problems of the JAX package's
  ``examples/*.py``, loaded by path, solve the same inputs through
  ``tpl_tpu.optim.ilqr.make_update_fn``, and the crane a batch of 4
  through ``tpl_tpu.optim.batched.make_batched_update_fn`` against the
  traced struct on a grid of 4 blocks in a seeded order (each block also
  bit-equal to its single launch), at the tolerance
  tests/test_torch_genopt.py holds the plain solve to (rtol 1e-4, x atol
  1e-6, u atol 1e-5).
- (d) The tracer refuses ``erf``, a Python ``if`` on a state and a
  captured (H,) tensor, naming the function; the Solver on a CPU device
  solves the ``erf`` problem with the plain iLQR.  Sympy's rewrites: ``x - x``
  cancels to 0, so a NaN the plain version would carry is dropped.

    python -m pytest tests/test_torch_trace.py -q
"""

import ctypes
import importlib.util
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import sympy as sp
import torch
import jax
import jax.numpy as jnp

from tpl_tpu.ops import interp as j_interp
from tpl_tpu.optim import batched as j_batched
from tpl_tpu.optim import ilqr as j_ilqr

import tpl_tpu_torch
from tpl_tpu_torch import _build, scenes
from tpl_tpu_torch.examples import crane_2d, simple_vehicle, solver_crosscheck
from tpl_tpu_torch.optim import batched, ilqr, problems, solver, trace
from tpl_tpu_torch.optim import ilqr_generic as ig
from tpl_tpu_torch.ops import interp

import test_torch_ilqr_generic as tig
import test_torch_kernel_rehearsal as reh

RTOL = ATOL = 1e-12
# the vehicle's own solve (30 iterations, still descending at the last) turns
# the printed struct's other rounding order into growing differences: 8e-13
# in x after 10 iterations, 2e-9 after 20, 9e-7 after 30 (x up to 40 m, cost
# 5e-8 relative), with equal iterations and mu_step; it is held at 1e-12 over
# its first VEHICLE_ITERATIONS and at VEHICLE_TOL over all 30
VEHICLE_ITERATIONS = 10
VEHICLE_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JETS = r"""
// a struct's four functions on Jet<double, NX + NU> at one point z = (x, u):
// per output its value, gradient and packed Hessian, in the order dynamics,
// cost, constraints, end cost
static const double* jets_consts = nullptr;
extern "C" void jets_set_consts(const double* c) { jets_consts = c; }

template <class P>
static void jets_problem(const double* s, const double* tab, int n_ref,
                         double dt, int t, const double* z, double* out) {
  using namespace ilqr_generic;
  constexpr int N = P::NX + P::NU;
  typedef ilqr_jet::Jet<double, N> J;
  const Prm<double> pr{s, tab, n_ref, dt, jets_consts};
  J x[P::NX], u[P::NU > 0 ? P::NU : 1], f[P::NX];
  J g[P::NC > 0 ? P::NC : 1];
  for (int i = 0; i < P::NX; ++i) x[i] = ilqr_jet::jvar<double, N>(z[i], i);
  for (int i = 0; i < P::NU; ++i)
    u[i] = ilqr_jet::jvar<double, N>(z[P::NX + i], P::NX + i);
  auto put = [&](const J& j) {
    *out++ = j.v;
    for (int i = 0; i < N; ++i) *out++ = j.g[i];
    for (int i = 0; i < J::NH; ++i) *out++ = j.h[i];
  };
  P::dynamics(pr, t, x, u, f);
  for (int i = 0; i < P::NX; ++i) put(f[i]);
  put(P::cost(pr, t, x, u));
  if (P::NC > 0) P::constraints(pr, t, x, u, g);
  for (int i = 0; i < P::NC; ++i) put(g[i]);
  put(P::end_cost(pr, t, x));
}

extern "C" void jets(int problem, const double* s, const double* tab,
                     int n_ref, double dt, int t, const double* z,
                     double* out) {
  using namespace ilqr_generic;
#define X(ID, P) \
  if (problem == ID) return jets_problem<P<double>>(s, tab, n_ref, dt, t, z, out);
  GENERATED_PROBLEMS(X)
#undef X
}
"""


# ---------------------------------------------------------------------
# the problems and their seeded solves

def kinks_problem():
    """A problem on the kinks the jets must take as autograd does: where
    (the taken branch only), maximum / minimum (a tie splits the slope),
    clamp (the slope passes at the bounds), abs (slope 0 at 0)."""
    def dynamics(x, u, t, dt, p):
        a, b, c = x.unbind(-1)
        return torch.stack([
            torch.maximum(a, b) + torch.minimum(b, u[..., 0]),
            torch.clamp(b, min=-p["lim"], max=p["lim"]) * c,
            torch.where(a > 0.0, a * a, -a) + torch.abs(c) * u[..., 0],
        ], dim=-1)

    def cost(x, u, t, dt, p):
        a, b, c = x.unbind(-1)
        return (p["w"] * (a ** 2 + b ** 2 + c ** 2) + u[..., 0] ** 2
                + torch.clip(a - b, -0.5, 0.5) ** 2
                + torch.abs(a) * torch.sign(b))

    def constraints(x, u, t, dt, p):
        return torch.stack([torch.maximum(x[..., 0], x[..., 1]) - 2.0,
                            torch.where(x[..., 2] >= 0.0, x[..., 2], 0.0)
                            - 3.0], dim=-1)

    def end_cost(x, t, dt, p):
        return 10.0 * torch.maximum(torch.abs(x[..., 0]),
                                    torch.abs(x[..., 1])) ** 2

    prob = ilqr.Problem("kinks", nx=3, nu=1, nc=2, dynamics=dynamics,
                        cost=cost, end_cost=end_cost,
                        constraints=constraints)
    return prob, dict(w=0.5, lim=0.8)


def example_case(module):
    """(problem, param spec, inputs, params, mu_step, H, T, iterations,
    integrator) of an example's own solve (its ``make_solver``)."""
    prob, pspec = module.make_problem()
    opt = module.make_solver(device="cpu")
    inputs = {k: np.array(v) for k, v in opt._inputs().items()}
    params = dict(opt.params._values)
    return (prob, pspec, inputs, params, 0, opt.horizon_max, opt.horizon,
            opt.max_iterations, opt.integrator_type)


NATIVE_H = 120


def native_case(name, seed):
    prob, pspec = getattr(problems, name)()
    if name == "trajectory_tracking_mpc":
        inputs, params, mu = scenes.genopt_mpc_case(False, seed)
        return prob, pspec, inputs, params, mu, 60, 60, 8, ilqr.HEUN
    if name == "trajectory_tracking_mpc_time":
        inputs, params, mu = scenes.mpc_time_generic_case(60, seed)
        return prob, pspec, inputs, params, mu, 60, 60, 8, ilqr.HEUN
    inputs, params, mu, it = scenes.generic_native_case(
        name, NATIVE_H, NATIVE_H - 10, True, seed)
    return (prob, pspec, inputs, params, mu, NATIVE_H, NATIVE_H - 10, it,
            (ilqr.EULER, ilqr.HEUN, ilqr.RK4)[seed % 3])


NATIVES = tuple(ig.NATIVE)
EXAMPLES = {"crane_2d": crane_2d, "simple_vehicle": simple_vehicle,
            "unicycle_crosscheck": solver_crosscheck}


def case(name):
    if name in EXAMPLES:
        return example_case(EXAMPLES[name])
    return native_case(name, NATIVES.index(name) + 1)


TRACED = {}     # name -> (id, Spec)


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    """ilqr_generic.cu and every traced struct compiled for the host in one
    translation unit."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies for the host")
    probs = {n: case(n)[:2] for n in NATIVES + tuple(EXAMPLES)}
    probs["kinks"] = kinks_problem()
    probs.update({n: scenes.user_problem(n, H=USER_H)
                  for n in scenes.USER_PROBLEMS})
    for i, (name, (prob, pspec)) in enumerate(probs.items()):
        TRACED[name] = (100 + i, trace.spec(prob, trace.kinds_of_spec(pspec)))
    gen = "\n".join(s.struct for _, s in TRACED.values())
    gen += "\n#define GENERATED_PROBLEMS(X) " + " ".join(
        f"X({i}, {s.struct_name})" for i, s in TRACED.values()) + "\n"
    tmp = tmp_path_factory.mktemp("trace")
    (tmp / "cuda_runtime.h").write_text(reh.STUB)
    (tmp / "generated.cuh").write_text(gen)
    (tmp / "harness.cpp").write_text(tig.HARNESS + JETS)
    so = tmp / "traced.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-pthread", "-x", "c++", "-I", str(tmp), "-I", _build.CSRC,
           str(tmp / "harness.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.rehearse_generic.restype = None
    lib.rehearse_generic.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_size_t, ctypes.c_void_p])
    lib.rehearse_generic_split.restype = ctypes.c_size_t
    lib.rehearse_generic_split.argtypes = ([ctypes.c_int] * 3
                                           + [ctypes.c_size_t, ctypes.c_int])
    bind_jets(lib)
    lib.rehearse_set_consts.restype = None
    lib.rehearse_set_consts.argtypes = [ctypes.c_void_p]
    return lib


def bind_jets(lib):
    lib.jets.restype = None
    lib.jets.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_double, ctypes.c_int]
                         + [ctypes.c_void_p] * 2)
    lib.jets_set_consts.restype = None
    lib.jets_set_consts.argtypes = [ctypes.c_void_p]


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def rehearse(lib, pid, spec, shared, rows, H, n_ref, T, max_it,
             integrator, order=None):
    """The body of problem ``pid`` (a native id, or a traced struct's) on a
    grid of B = len(rows) blocks: (B, n_out) results."""
    rows = np.ascontiguousarray(rows, np.float64)
    shared = np.ascontiguousarray(shared, np.float64)
    B = rows.shape[0]
    ws = np.full(max(B * lib.rehearse_generic_split(
        pid, H, n_ref, ig.SMEM_LIMIT, 1), 1), np.nan)
    out = np.zeros((B, ig._size(ig.output_layout(spec, H))))
    o = None if order is None else np.ascontiguousarray(order, np.int32)
    consts = (None if spec.consts is None
              else np.ascontiguousarray(spec.consts, np.float64))
    lib.rehearse_set_consts(_ptr(consts))
    lib.rehearse_generic(pid, integrator, _ptr(shared), _ptr(rows),
                         _ptr(out), _ptr(ws), None, B, H, n_ref, T, max_it,
                         1, ig.SMEM_LIMIT, _ptr(o))
    return out


def solve_body(lib, pid, spec, inputs, params, mu, H, T, it, integ):
    host = ig.pack_inputs(spec, inputs, params, mu)
    n_ref = ig.n_ref_of(spec, params)
    n_sh = ig._size(ig.shared_layout(spec, H, n_ref))
    out = rehearse(lib, pid, spec, host[:n_sh], host[n_sh:][None], H, n_ref,
                   T, it, integ)
    return ig.unpack_outputs(spec, out[0], H), host, n_ref


# ---------------------------------------------------------------------
# (a) the printed functions and their jets against the plain functions

def plain_jets(prob, x, u, t, dt, p):
    """Each output's value, gradient and Hessian over z = (x, u) by
    torch.func, in the order of the jets entry."""
    nx = prob.nx
    tt = t if torch.is_tensor(t) else torch.tensor(t, dtype=torch.float64)
    dd = torch.tensor(dt, dtype=torch.float64)
    fns = [lambda z: prob.dynamics(z[:nx], z[nx:], tt, dd, p),
           lambda z: prob.cost(z[:nx], z[nx:], tt, dd, p)[None]]
    if prob.constraints is not None and prob.nc > 0:
        fns.append(lambda z: prob.constraints(z[:nx], z[nx:], tt, dd, p))
    fns.append(lambda z: (prob.end_cost(z[:nx], tt, dd, p)[None]
                          if prob.end_cost is not None
                          else torch.zeros(1, dtype=torch.float64)))
    z = torch.as_tensor(np.concatenate([x, u]), dtype=torch.float64)
    out = []
    for f in fns:
        v = f(z)
        jac = torch.func.jacrev(f)(z)
        hess = torch.func.jacrev(torch.func.jacrev(f))(z)
        out += [(float(v[i]), jac[i].numpy(), hess[i].numpy())
                for i in range(v.shape[0])]
    return out


def struct_jets(lib, pid, spec, x, u, t, dt, params):
    consts = (None if spec.consts is None
              else np.ascontiguousarray(spec.consts, np.float64))
    lib.jets_set_consts(_ptr(consts))
    s = np.array([params[n] for n in spec.scalars], np.float64)
    n_ref = ig.n_ref_of(spec, params)
    tab = np.ascontiguousarray(np.reshape(
        [params[n] for n in spec.tables], (len(spec.tables), n_ref)),
        np.float64)
    n = spec.nx + spec.nu
    width = 1 + n + n * (n + 1) // 2
    n_out = spec.nx + 1 + spec.nc + 1
    out = np.zeros(n_out * width)
    lib.jets(pid, _ptr(s if s.size else np.zeros(1)),
             _ptr(tab if tab.size else np.zeros(1)), n_ref, dt, t,
             _ptr(np.concatenate([x, u]).astype(np.float64)), _ptr(out))
    iu = np.triu_indices(n)
    res = []
    for row in out.reshape(n_out, width):
        h = np.zeros((n, n))
        h[iu] = row[1 + n:]
        res.append((row[0], row[1:1 + n], h + np.triu(h, 1).T))
    return res


def assert_jets(got, want, what):
    assert len(got) == len(want), what
    for k, ((v, g, h), (wv, wg, wh)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(v, wv, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} output {k} value")
        np.testing.assert_allclose(g, wg, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} output {k} gradient")
        np.testing.assert_allclose(h, wh, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} output {k} Hessian")


def seeded_points(name, inputs, rng, n=3):
    """Points near the case's start: (x, u, t)."""
    x0 = np.asarray(inputs["x"][0], np.float64)
    nu = inputs["u"].shape[1]
    H = inputs["u"].shape[0]
    for _ in range(n):
        scale = 0.1 * (1.0 + np.abs(x0))
        yield (x0 + rng.normal(0.0, 1.0, x0.shape) * scale,
               rng.normal(0.0, 0.3, nu), int(rng.integers(0, H)))


@pytest.mark.parametrize("name", NATIVES + tuple(EXAMPLES))
def test_traced_functions_and_jets_match_plain(body, name):
    prob, pspec, inputs, params, *_ = case(name)
    pid, spec = TRACED[name]
    p = {k: torch.as_tensor(np.asarray(v, np.float64))
         for k, v in params.items()}
    dt = float(inputs["cfg_f"][0])
    rng = np.random.default_rng(len(name))
    for x, u, t in seeded_points(name, inputs, rng):
        assert_jets(struct_jets(body, pid, spec, x, u, t, dt, params),
                    plain_jets(prob, x, u, t, dt, p), f"{name} t={t}")


# (a, b, c, u) on the kinks: max(a, b) tie, clamp(b) at its bound, where's
# a > 0 at a = 0, abs(c) at 0, min(b, u) tie, clip(a - b) at its bound,
# the end cost's max tie of |a| and |b|
KINK_POINTS = [
    (0.3, 0.3, 0.7, -0.2),
    (0.1, 0.8, -0.4, 0.5),
    (0.0, -0.8, 0.0, 0.2),
    (-0.4, 0.2, 0.0, 0.2),
    (0.7, 0.2, -1.0, 0.4),
    (-0.6, 0.6, 0.0, -0.6),
]


@pytest.mark.parametrize("point", KINK_POINTS)
def test_kink_jets_take_autograds_slopes(body, point):
    prob, params = kinks_problem()
    pid, spec = TRACED["kinks"]
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    x, u = np.array(point[:3]), np.array(point[3:])
    assert_jets(struct_jets(body, pid, spec, x, u, 3, 0.1, params),
                plain_jets(prob, x, u, 3, 0.1, p), f"kinks at {point}")


# ---------------------------------------------------------------------
# (b) the traced structs' bodies against the plain update and the natives

def plain(spec, host, H, n_ref, T, it, integ):
    out = ig.update_reference(spec, torch.from_numpy(host), H, n_ref, T, it,
                              1, integ)
    return ig.unpack_outputs(spec, out.numpy(), H)


@pytest.mark.parametrize("name", NATIVES + tuple(EXAMPLES))
def test_traced_body_matches_plain(body, name):
    prob, pspec, inputs, params, mu, H, T, it, integ = case(name)
    pid, spec = TRACED[name]
    if name == "simple_vehicle":
        got, host, n_ref = solve_body(body, pid, spec, inputs, params, mu,
                                      H, T, it, integ)
        tig.assert_matches(got, plain(spec, host, H, n_ref, T, it, integ),
                           it, VEHICLE_TOL)
        np.testing.assert_allclose(got["traj_costs"], plain(
            spec, host, H, n_ref, T, it, integ)["traj_costs"], rtol=1e-7)
        it = VEHICLE_ITERATIONS
    got, host, n_ref = solve_body(body, pid, spec, inputs, params, mu, H, T,
                                  it, integ)
    tig.assert_matches(got, plain(spec, host, H, n_ref, T, it, integ), it)
    assert float(np.abs(got["u"]).max()) > 1e-4
    if name in NATIVES:
        native, _, _ = solve_body(body, ig.NATIVE[name].id, ig.NATIVE[name],
                                  inputs, params, mu, H, T, it, integ)
        tig.assert_matches(got, native, it)


# ---------------------------------------------------------------------
# (c) the JAX package's own examples on the same inputs

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Capture:
    """Stands in for the JAX example's Solver: keeps the problem its
    ``solve_ilqr`` builds."""

    problem = None

    def __init__(self, prob, spec, horizon_max):
        _Capture.problem = prob
        self.x = np.zeros((horizon_max + 1, prob.nx))
        self.u = np.zeros((horizon_max, prob.nu))
        self.u_min = np.zeros((horizon_max, prob.nu))
        self.u_max = np.zeros((horizon_max, prob.nu))

    def update(self):
        pass


def jax_problem(name):
    path = os.path.join(REPO, "examples", {
        "crane_2d": "crane_2d.py", "simple_vehicle": "simple_vehicle.py",
        "unicycle_crosscheck": "solver_crosscheck.py"}[name])
    mod = _load(path, f"jax_example_{name}")
    if name != "unicycle_crosscheck":
        return mod.make_problem()[0]
    mod.Solver = _Capture
    mod.solve_ilqr()
    return _Capture.problem


@pytest.mark.parametrize("name", tuple(EXAMPLES))
def test_traced_example_matches_jax_example(body, name):
    prob, pspec, inputs, params, mu, H, T, it, integ = case(name)
    pid, spec = TRACED[name]
    got, _, _ = solve_body(body, pid, spec, inputs, params, mu, H, T, it,
                           integ)
    want = tig.jax_solve(jax_problem(name), spec, inputs, params, mu, H, T,
                         it, integ)
    tig.assert_jax(got, want)


def test_traced_crane_batch_matches_jax_batched(body):
    B = 4
    prob, pspec, inputs, params, mu, H, T, it, integ = case("crane_2d")
    pid, spec = TRACED["crane_2d"]
    rng = np.random.default_rng(11)
    x0 = (inputs["x"][0][:, None]
          + rng.normal(0.0, 1.0, (4, B)) * np.array([2.0, 0.5, 0.1, 0.1])
          [:, None])
    u = rng.normal(0.0, 0.1, (H, 1, B))
    lam = np.zeros((H, 1, B))
    mu_b = rng.integers(0, 3, B)
    cfg = dict(u_min=inputs["u_lims"][..., 0], u_max=inputs["u_lims"][..., 1],
               barrier_weight=inputs["bw_lim"][:, 0],
               lg_mult_limit=inputs["bw_lim"][:, 1], dt=inputs["cfg_f"][0],
               min_rel_cost_change=inputs["cfg_f"][1], T=T,
               max_iterations=it, max_lg_iterations=1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    tp = {k: t(v) for k, v in params.items()}
    tcfg = {k: (t(v) if isinstance(v, (np.ndarray, float)) else v)
            for k, v in cfg.items()}
    x = torch.zeros((H + 1, 4, B), dtype=torch.float64)
    assert trace.kinds_of_params(tp) == trace.kinds_of_spec(pspec)
    shared, rows = ig.pack_inputs_batched(
        spec, x, t(u), t(lam), torch.as_tensor(mu_b, dtype=torch.int32),
        t(x0), tp, tcfg)
    order = np.random.default_rng(3).permutation(B)
    out = rehearse(body, pid, spec, shared.numpy(), rows.numpy(), H, 0, T,
                   it, integ, order)
    singles = ig.rows_of_batch(shared, rows).numpy()
    n_sh = shared.numel()
    for b in range(B):
        one = rehearse(body, pid, spec, singles[b, :n_sh],
                       singles[b, n_sh:][None], H, 0, T, it, integ)
        assert np.array_equal(out[b], one[0]), b
    got = ig.unpack_outputs_batched(spec, torch.from_numpy(out), H)
    upd = batched.make_batched_update_fn(prob, H, B, integ, torch.float64)
    want = upd.reference(x, t(u), t(lam), torch.as_tensor(mu_b), t(x0), tp,
                         tcfg, iterations=True)
    for g, w, what in zip(got, want, ("x", "u", "lam", "mu", "cost", "it")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
    j_upd = j_batched.make_batched_update_fn(jax_problem("crane_2d"), H, B,
                                             integ, dtype=jnp.float64)
    jp = {k: jnp.asarray(np.asarray(v, np.float64))
          for k, v in params.items()}
    jcfg = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in cfg.items()}
    jx, ju, _, _, jc = j_upd(jnp.zeros((H + 1, 4, B)), jnp.asarray(u),
                             jnp.asarray(lam), jnp.asarray(mu_b, jnp.int32),
                             jnp.asarray(x0), jp, jcfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jx),
                               rtol=tig.SOLVE_RTOL, atol=tig.SOLVE_X_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ju),
                               rtol=tig.SOLVE_RTOL, atol=tig.SOLVE_U_ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(jc),
                               rtol=tig.SOLVE_RTOL)


# ---------------------------------------------------------------------
# (e) the two user problems of scenes.py (captured tensors, products, the
# reductions, the new elementwise functions, blerp) against the JAX package

USER_H = 30         # the tracking MPC's reference cut to the horizon


def user_it(name):
    """The iterations over which the problem's float64 solves agree at 1e-12
    in any rounding order (``scenes.USER_SETTINGS`` it_exact)."""
    return scenes.USER_SETTINGS[name]["it_exact"]


def _col(a, x):
    """``a`` (k,) against a value of x's layout: (k,) or (k, B)."""
    return a.reshape(a.shape + (1,) * (x.ndim - 1))


def jax_user_problem(name):
    """The jnp twin of a problem of ``scenes.USER_PROBLEMS`` (over the same
    captured arrays), for the JAX package's ilqr / batched programs: its
    functions index the state by position and reduce over the first axis,
    so that they take one step's (nx,) and the batched program's (nx, B)."""
    if name == "quadratic_tracking_mpc":
        d = {k: jnp.asarray(v)
             for k, v in scenes.quadratic_tracking_data(USER_H).items()}

        def dynamics(x, u, t, dt, p):
            return jnp.stack([x[3] * jnp.cos(x[2]), x[3] * jnp.sin(x[2]),
                              x[3] * jnp.tan(u[1]) / p["wheel_base"], u[0]])

        def cost(x, u, t, dt, p):
            e = x - _col(d["REF"][t], x)
            return (jnp.einsum("i...,ij,j...->...", e, d["Q"], e)
                    + jnp.einsum("i...,ij,j...->...", u, d["R"], u))

        def constraints(x, u, t, dt, p):
            off = x[:2] - _col(d["REF"][t][:2], x)
            return jnp.stack([
                jnp.linalg.norm(off, axis=0) - p["corridor"],
                jnp.linalg.norm(u / _col(d["U_SCALE"], u), ord=1, axis=0)
                - p["effort_max"]])

        def end_cost(x, t, dt, p):
            e = x - _col(d["REF"][-1], x)
            return jnp.einsum("i...,ij,j...->...", e, d["QF"], e)

        return j_ilqr.Problem(name, nx=4, nu=2, nc=2, dynamics=dynamics,
                              cost=cost, constraints=constraints,
                              end_cost=end_cost)
    d = {k: jnp.asarray(v) for k, v in scenes.cost_map_data().items()}

    def goal_distance(x):
        return jnp.hypot(x[0] - d["GOAL"][0], x[1] - d["GOAL"][1])

    def dynamics(x, u, t, dt, p):
        return jnp.stack([x[3] * jnp.cos(x[2]), x[3] * jnp.sin(x[2]),
                          x[3] * u[1], u[0]])

    def cost(x, u, t, dt, p):
        v, a, kappa = x[3], u[0], u[1]
        cmap = j_interp.blerp(d["ORIGIN"][0], d["ORIGIN"][1], d["STEP"],
                              d["STEP"], x[0], x[1], d["GRID"])
        goal = goal_distance(x)
        over = 4.0 * (v - p["v_max"])
        barrier = jnp.where(over > 20.0, v - p["v_max"],
                            jnp.log1p(jnp.exp(over)) / 4.0)
        obs = d["OBS"].reshape((2, 2) + (1,) * (x.ndim - 1))
        diff = x[None, :2] - obs
        scaled = u / _col(jnp.stack([p["a_max"], p["kappa_max"]]), u)
        return (p["w_map"] * cmap + barrier
                + p["w_goal"] * goal * goal * jax.lax.rsqrt(
                    1.0 + 0.01 * goal * goal)
                * jax.nn.sigmoid(0.5 * (goal - 10.0))
                - jax.scipy.special.erf(v / 8.0)
                + 0.1 * jnp.log1p((v * v * kappa) ** 2)
                + 0.1 * jnp.expm1(0.125 * a * a)
                + 10.0 * jax.nn.relu(jnp.abs(kappa) - 0.15) ** 2
                + 5.0 * jnp.exp(-0.05 * jnp.min((diff * diff).sum(1), 0))
                + 0.1 * jnp.max(jnp.square(scaled) + _col(d["U_OFF"], u), 0)
                + 0.1 * jnp.prod(u * u, 0)
                + jnp.mean(jnp.cumsum(u * u * _col(d["U_W"], u), 0), 0))

    def constraints(x, u, t, dt, p):
        return -x[3:4]

    def end_cost(x, t, dt, p):
        return p["w_goal_end"] * goal_distance(x)

    return j_ilqr.Problem(name, nx=4, nu=2, nc=1, dynamics=dynamics,
                          cost=cost, constraints=constraints,
                          end_cost=end_cost)


def user_case(name, seed=3):
    """A seeded warm start (no action exactly 0: there the JAX package's
    abs takes slope 1, torch's 0) at mu_step 0."""
    inputs, params, _ = scenes.user_case(name, H=USER_H, seed=seed,
                                         warm=True)
    return inputs, params, 0, scenes.USER_SETTINGS[name]["integ"]


@pytest.mark.parametrize("name", scenes.USER_PROBLEMS)
def test_user_problem_jets_match_plain(body, name):
    pid, spec = TRACED[name]
    prob, _ = scenes.user_problem(name, H=USER_H)
    inputs, params, _, _ = user_case(name)
    p = {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()}
    rng = np.random.default_rng(len(name))
    for x, u, t in seeded_points(name, inputs, rng):
        assert_jets(struct_jets(body, pid, spec, x, u, t, 0.1, params),
                    plain_jets(prob, x, u, torch.tensor(t), 0.1, p),
                    f"{name} t={t}")


@pytest.mark.parametrize("name", scenes.USER_PROBLEMS)
def test_user_problem_struct_plain_and_jax_agree(body, name):
    """The printed struct (g++), the plain float64 update and the JAX
    package's make_update_fn on the jnp twin, each held to the others at
    1e-12 (sympy's rewriting of the struct's expressions moves its
    rounding, not past the bound over these converged solves)."""
    pid, spec = TRACED[name]
    inputs, params, mu, integ = user_case(name)
    it = user_it(name)
    got, host, n_ref = solve_body(body, pid, spec, inputs, params, mu,
                                  USER_H, USER_H, it, integ)
    want = plain(spec, host, USER_H, n_ref, USER_H, it, integ)
    tig.assert_matches(got, want, it)
    assert got["iterations"] == it
    jax_out = tig.jax_solve(jax_user_problem(name), spec, inputs, params, mu,
                            USER_H, USER_H, it, integ)
    for k in ("x", "u"):
        np.testing.assert_allclose(want[k], jax_out[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], jax_out[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(want["traj_costs"], jax_out["traj_costs"],
                               rtol=RTOL)


@pytest.mark.parametrize("name", scenes.USER_PROBLEMS)
def test_user_problem_batch_matches_jax_vmap(body, name):
    """B = 4 through the struct on a grid of 4 blocks in a seeded order,
    each block bit-equal to its single launch, against the plain batched
    update and ``jax.vmap`` of the JAX package's update, at 1e-12."""
    B = 4
    it = user_it(name)
    pid, spec = TRACED[name]
    prob, _ = scenes.user_problem(name, H=USER_H)
    inputs, params, _, integ = user_case(name)
    H = USER_H
    rng = np.random.default_rng(17)
    x0 = (inputs["x"][0][:, None]
          + rng.normal(0.0, 1.0, (4, B)) * np.array([0.5, 0.5, 0.05, 0.5])
          [:, None])
    u = rng.normal(0.0, 0.05, (H, 2, B))
    lam = np.zeros((H, prob.nc, B))
    mu_b = rng.integers(0, 2, B)
    cfg = dict(u_min=inputs["u_lims"][..., 0], u_max=inputs["u_lims"][..., 1],
               barrier_weight=inputs["bw_lim"][:, 0],
               lg_mult_limit=inputs["bw_lim"][:, 1], dt=inputs["cfg_f"][0],
               min_rel_cost_change=inputs["cfg_f"][1], T=H,
               max_iterations=it, max_lg_iterations=1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    tp = {k: t(v) for k, v in params.items()}
    tcfg = {k: (t(v) if isinstance(v, (np.ndarray, float)) else v)
            for k, v in cfg.items()}
    x = torch.zeros((H + 1, 4, B), dtype=torch.float64)
    shared, rows = ig.pack_inputs_batched(
        spec, x, t(u), t(lam), torch.as_tensor(mu_b, dtype=torch.int32),
        t(x0), tp, tcfg)
    order = np.random.default_rng(5).permutation(B)
    out = rehearse(body, pid, spec, shared.numpy(), rows.numpy(), H, 0, H,
                   it, integ, order)
    singles = ig.rows_of_batch(shared, rows).numpy()
    n_sh = shared.numel()
    for b in range(B):
        one = rehearse(body, pid, spec, singles[b, :n_sh],
                       singles[b, n_sh:][None], H, 0, H, it, integ)
        assert np.array_equal(out[b], one[0]), b
    got = ig.unpack_outputs_batched(spec, torch.from_numpy(out), H)
    upd = batched.make_batched_update_fn(prob, H, B, integ, torch.float64)
    want = upd.reference(x, t(u), t(lam), torch.as_tensor(mu_b), t(x0), tp,
                         tcfg, iterations=True)
    for g, w, what in zip(got, want, ("x", "u", "lam", "mu", "cost", "it")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=what)
    # the JAX package's batch of this problem: jax.vmap over its jitted
    # update (its tpl_tpu/optim/batched.py program parts from its own single
    # update on the cost map, by 3e-3 to 0.56 after one iteration, and is
    # not the reference here)
    upd = j_ilqr.make_update_fn(jax_user_problem(name), H, integ,
                                dtype=jnp.float64)
    jcfg = dict(u_min=jnp.asarray(cfg["u_min"]),
                u_max=jnp.asarray(cfg["u_max"]),
                barrier_weight=jnp.asarray(cfg["barrier_weight"]),
                lg_mult_limit=jnp.asarray(cfg["lg_mult_limit"]),
                dt=jnp.float64(cfg["dt"]),
                min_rel_cost_change=jnp.float64(cfg["min_rel_cost_change"]),
                T=jnp.int32(H), max_iterations=jnp.int32(it),
                max_lg_iterations=jnp.int32(1))
    jp = {k: jnp.asarray(np.asarray(v, np.float64))
          for k, v in params.items()}
    xs = np.zeros((B, H + 1, 4))
    xs[:, 0] = x0.T
    states = j_ilqr.SolverState(jnp.asarray(xs), jnp.asarray(u.transpose(
        2, 0, 1)), jnp.asarray(lam.transpose(2, 0, 1)),
        jnp.asarray(mu_b, jnp.int32))
    new, info = jax.vmap(lambda s, x0_: upd(s, x0_, jp, jcfg))(
        states, jnp.asarray(x0.T))
    np.testing.assert_allclose(got[0].numpy(), np.moveaxis(
        np.asarray(new.x), 0, -1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.moveaxis(
        np.asarray(new.u), 0, -1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(
        info["traj_costs"]), rtol=RTOL)


# (d) what the tracer refuses, and what sympy rewrites

def _user(name, dynamics=None, cost=None):
    return ilqr.Problem(
        name, nx=2, nu=1, nc=0,
        dynamics=dynamics or (lambda x, u, t, dt, p: torch.stack(
            [x[..., 1], u[..., 0]], dim=-1)),
        cost=cost or (lambda x, u, t, dt, p: (x ** 2).sum(-1)
                      + u[..., 0] ** 2))


def _branching(x, u, t, dt, p):
    if x[..., 0] > 0.0:
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)
    return torch.stack([-x[..., 1], u[..., 0]], dim=-1)


WEIGHTS = torch.linspace(1.0, 2.0, 20)
GRID = torch.linspace(0.0, 1.0, 12).reshape(3, 4)

# what jax.jit refuses too (a Python branch, number or index off a traced
# value, a boolean mask of one), and an operation outside the tracer's table
REFUSED = {
    "python_if": (_user("with_if", dynamics=_branching), "dynamics",
                  "Python branch"),
    "python_float": (_user("with_float", cost=lambda x, u, t, dt, p: (
        x[..., 0] ** 2 * float(x[..., 1]))), "cost", "float()"),
    "python_index": (_user("with_index", cost=lambda x, u, t, dt, p: (
        WEIGHTS[[x[..., 0]]] + u[..., 0] ** 2)), "cost", "Python index"),
    "bool_mask": (_user("with_mask", cost=lambda x, u, t, dt, p: (
        WEIGHTS[x[..., 0] > 0.0] + u[..., 0] ** 2)), "cost",
        "boolean mask"),
    "sort": (_user("with_sort", cost=lambda x, u, t, dt, p: torch.sort(
        x, -1).values[..., 0] + u[..., 0] ** 2), "cost",
        "'sort' (no form in the tracer)"),
}

# what the tracer refused before it took captured tensors, erf and blerp:
# each traces into a struct of its form and routes to the generic kernel
FORMERLY_REFUSED = {
    "erf": (_user("with_erf", cost=lambda x, u, t, dt, p: torch.erf(
        x[..., 0]) + u[..., 0] ** 2), "j_erf"),
    "captured": (_user("with_weights", cost=lambda x, u, t, dt, p: (
        (x[..., :1] * WEIGHTS).sum(-1) * x[..., 0])), "j_ipow(x[0], 2)"),
    "blerp": (_user("with_blerp", cost=lambda x, u, t, dt, p: interp.blerp(
        0.0, 0.0, 1.0, 1.0, x[..., 0], x[..., 1], GRID) + u[..., 0] ** 2),
        "j_blerp(R(0.0), R(0.0), R(1.0), R(1.0), x[0], x[1], "
        "P.ctab2(0, 3, 4))"),
}


@pytest.mark.parametrize("which", sorted(FORMERLY_REFUSED))
def test_formerly_refused_problem_traces(which):
    prob, form = FORMERLY_REFUSED[which]
    spec = trace.spec(prob, ())
    assert form in spec.struct, spec.struct
    assert solver.route(prob, torch.float64, 20, 0, (),
                        torch.device("cuda"))[0] == "ilqr_generic"
    opt = solver.Solver(prob, {}, horizon_max=20, dtype=torch.float64,
                        device="cpu")
    assert opt.route is None
    opt.horizon, opt.max_iterations = 20, 3
    opt.x[0] = [1.0, 0.5]
    opt.update()            # the CPU keeps the plain iLQR
    assert opt.iterations > 0 and np.all(np.isfinite(opt.x))


@pytest.mark.parametrize("which", sorted(REFUSED))
def test_tracer_refuses_naming_the_function(which):
    prob, function, what = REFUSED[which]
    with pytest.raises(trace.Untraceable) as e:
        trace.spec(prob, ())
    assert f"{prob.name}.{function}" in str(e.value) and what in str(e.value)
    # cached: the second route raises the same
    with pytest.raises(trace.Untraceable):
        ig.spec_of(prob, ())
    opt = solver.Solver(prob, {}, horizon_max=20, dtype=torch.float64,
                        device="cpu")
    assert opt.route is None
    with pytest.raises(trace.Untraceable, match=re.escape(what)):
        solver.route(prob, torch.float64, 20, 0, (), torch.device("cuda"))
    if which == "sort":
        opt.horizon, opt.max_iterations = 20, 3
        opt.x[0] = [1.0, 0.0]
        opt.update()            # the CPU keeps the plain iLQR
        assert opt.iterations > 0 and np.all(np.isfinite(opt.x))
    msg = batched.no_batched_kernel_message(prob.name, e.value)
    assert function in msg and what in msg


def test_traced_route_and_cpu_solve(monkeypatch):
    """A user problem's route on a CUDA device is ilqr_generic; on a CPU
    device it is None (the problem is not traced) and the solve runs the
    plain iLQR without reaching the kernel's wrapper; the traced spec is
    cached on the problem by its params' kinds."""
    prob, pspec = crane_2d.make_problem()
    opt = crane_2d.make_solver(device="cpu")
    assert opt.route is None and "_traced" not in vars(opt.problem)
    kinds = trace.kinds_of_spec(pspec)
    assert solver.route(opt.problem, torch.float32, 100, 0, kinds,
                        torch.device("cuda"))[0] == "ilqr_generic"
    spec = ig.spec_of(opt.problem, kinds)
    assert spec is ig.spec_of(opt.problem, kinds)
    assert spec.struct_name == "Gen_crane_2d" and spec.problem is \
        opt.problem
    assert "printed problem 'crane_2d'" in ig.source_text(spec,
                                                           torch.float32)
    assert ig._tag(spec) == "genopt_crane_2d"
    assert ig.bound_ms(spec, 100, 0, 100, 10)[0] > 0
    assert ig.chain_ops(spec, 100, 100, 10)
    monkeypatch.setattr(ig, "solve", lambda *a, **k: pytest.fail(
        "a CPU solve reached the kernel's wrapper"))
    opt.max_iterations = 5
    opt.update()
    assert opt.iterations > 0
    # the params' kinds are part of the trace: a table taken as a scalar is
    # refused at its lookup
    veh = simple_vehicle.make_solver(device="cpu")
    assert ig.spec_of(veh.problem, veh._kinds).tables == ("ref_x", "ref_y")
    with pytest.raises(trace.Untraceable, match="simple_vehicle.cost: lerp"):
        ig.spec_of(veh.problem, tuple((n, False) for n, _ in veh._kinds))


def test_sympy_cancellation_drops_a_nan():
    """Sympy cancels ``x - x`` as it builds: the traced cost is x0**2 where
    the plain one carries a NaN state into its value."""
    prob = _user("cancels", cost=lambda x, u, t, dt, p: (
        (x[..., 0] - x[..., 0]) * 3.0 + x[..., 0] ** 2))
    tr = trace.trace(prob, ())
    x0 = sp.Symbol("x0")
    assert tr.cost == [x0 ** 2]
    nan = torch.tensor([float("nan"), 0.0], dtype=torch.float64)
    assert torch.isnan(prob.cost(nan, torch.zeros(1), 0, 0.1, {}))
