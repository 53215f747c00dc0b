"""The generic AL-iLQR kernel (``csrc/ilqr_generic_body.cuh``,
``csrc/ilqr_generic.cu``, the structs the sympy front end prints) rehearsed
on the CPU, and its wrapper ``tpl_tpu_torch/optim/ilqr_generic.py``.

The fixture compiles ``csrc/ilqr_generic.cu`` and the structs
``genopt`` prints for ``scenes.genopt_mpc_config()`` and for a config that
uses every function of the printer's table (:func:`funcs_config`) with g++
against the stand-in CUDA runtime of tests/test_torch_kernel_rehearsal.py
(its ``STUB``), and runs the bodies on host threads, a grid's blocks one
after the other.  Each case holds the body, instantiated in double, against
the plain float64 ``make_update_fn`` at RTOL = ATOL = 1e-12 with equal
``mu_step`` and iteration counts:

- the three native structs (``ref_line_smoother_k``, ``ref_line_smoother_dk``,
  ``velocity_profile_time``) at H = 250 and 300, cold and warm, with EULER,
  HEUN and RK4; the H = 300 cases with a 24 KB shared-memory limit, so that
  most arrays lie in the launch's global workspace;
- the generated genopt MPC (H = 60, HEUN, 8 iterations) and the generated
  every-function config;
- a grid of 4 blocks, in a seeded order, bit-equal to four single launches
  and within 1e-12 of ``batched.reference`` (``ref_line_smoother_k``, the
  genopt MPC, and the RSTP ``lateral_profile`` adapter).

The same seeded inputs also go through the JAX package
(``tpl_tpu.optim.genopt.make_problem`` / ``tpl_tpu.optim.problems`` with its
``make_update_fn``, and ``make_batched_update_fn``) at the tolerance
tests/test_torch_genopt.py holds the plain solve to (rtol 1e-4, x atol 1e-6,
u atol 1e-5).  A config with a function outside the printer's table warns
and solves with the plain iLQR.

    python -m pytest tests/test_torch_ilqr_generic.py -q
"""

import ctypes
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import sympy as sp
import torch
import jax.numpy as jnp

from tpl_tpu.optim import batched as j_batched
from tpl_tpu.optim import genopt as j_genopt
from tpl_tpu.optim import ilqr as j_ilqr
from tpl_tpu.optim import problems as j_problems
from tpl_tpu.optim import symext as j_spx

import tpl_tpu_torch
from tpl_tpu_torch import _build, scenes
from tpl_tpu_torch.optim import batched, genopt, ilqr, ilqr_generic as ig
from tpl_tpu_torch.optim import solver
from tpl_tpu_torch.optim import symext as spx

import test_torch_kernel_rehearsal as reh

RTOL = ATOL = 1e-12
SOLVE_RTOL, SOLVE_X_ATOL, SOLVE_U_ATOL = 1e-4, 1e-6, 1e-5
N_REF = 512
SMALL_SMEM = 24 * 1024      # most arrays in the workspace
# the tracking MPCs' structs against the plain update over 200 steps: an
# 8-iteration solve of the time-indexed MPC at 200 steps is sensitive to
# rounding (cold from scenes.mpc_time_generic_case, the two part by 3e-7 in
# x and 2e-9 in cost; at 120 steps by 3e-12), so the solves are held at
TRACKING_TOL = 1e-6

HARNESS = r"""
#include <thread>
#include <vector>
#include "ilqr_generic.cu"
#include "generated.cuh"

namespace ilqr_generic { alignas(16) unsigned char smem_raw[262144]; }

// the constant tables the next rehearse_generic passes (a traced struct's)
static const double* rehearsal_consts = nullptr;
extern "C" void rehearse_set_consts(const double* c) { rehearsal_consts = c; }

template <class F>
static void run_grid(unsigned gx, F body, const int* order) {
  const unsigned threads = 256;
  std::barrier<> block(threads);
  rehearsal::block_barrier = &block;
  blockDim = {threads, 1, 1};
  std::vector<std::thread> pool;
  for (unsigned i = 0; i < threads; ++i)
    pool.emplace_back([=] {
      threadIdx.x = i;
      gridDim = {gx, 1, 1};
      for (unsigned b = 0; b < gx; ++b) {
        blockIdx.x = order ? (unsigned)order[b] : b;
        blockIdx.y = 0;
        body();
        __syncthreads();
      }
    });
  for (auto& t : pool) t.join();
}

template <class P>
static void run_problem(int integ, const double* shared, const double* rows,
                        double* out, double* ws, long long* prof, int B,
                        int H, int n_ref, int T, int max_it, int max_lg,
                        size_t smem_limit, const int* order) {
  using namespace ilqr_generic;
  double* smd = reinterpret_cast<double*>(smem_raw);
  const size_t cap = smem_limit / sizeof(double);
  typedef Solve<P, double> S;
  const double* consts = rehearsal_consts;
  run_grid(B, [=] {
    if (prof)
      S::template run<true>(smd, ws, cap, shared, rows, out, prof, H, n_ref,
                            T, max_it, max_lg, integ, consts);
    else
      S::template run<false>(smd, ws, cap, shared, rows, out, prof, H, n_ref,
                             T, max_it, max_lg, integ, consts);
  }, order);
}

// the native problems by their ids, the generated ones from 100
extern "C" void rehearse_generic(int problem, int integ, const double* shared,
                                 const double* rows, double* out, double* ws,
                                 long long* prof, int B, int H, int n_ref,
                                 int T, int max_it, int max_lg,
                                 size_t smem_limit, const int* order) {
  using namespace ilqr_generic;
#define X(ID, P)                                                          \
  if (problem == ID)                                                      \
    return run_problem<P<double>>(integ, shared, rows, out, ws, prof, B, \
                                  H, n_ref, T, max_it, max_lg,            \
                                  smem_limit, order);
  ILQR_GENERIC_PROBLEMS(X)
  GENERATED_PROBLEMS(X)
#undef X
}

extern "C" size_t rehearse_generic_split(int problem, int H, int n_ref,
                                         size_t smem_limit, int which) {
  using namespace ilqr_generic;
#define X(ID, P)                                                       \
  if (problem == ID)                                                   \
    return split_words<P<double>, double>(H, n_ref, smem_limit, which);
  ILQR_GENERIC_PROBLEMS(X)
  GENERATED_PROBLEMS(X)
#undef X
  return 0;
}
"""


funcs_config = scenes.genopt_every_function_config
GENERATED = {}      # name -> (id, Spec)


@pytest.fixture(autouse=True)
def _cpu():
    tpl_tpu_torch.use_device("cpu")


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    """ilqr_generic.cu and the generated structs compiled for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel bodies for the host")
    specs = {"genopt_mpc": genopt.make_problem(
        scenes.genopt_mpc_config())[0].generated,
        "every_function": genopt.make_problem(funcs_config())[0].generated}
    GENERATED.update({k: (100 + i, s) for i, (k, s) in
                      enumerate(specs.items())})
    gen = "\n".join(s.struct for s in specs.values())
    gen += "\n#define GENERATED_PROBLEMS(X) " + " ".join(
        f"X({i}, {s.struct_name})" for i, s in GENERATED.values()) + "\n"
    tmp = tmp_path_factory.mktemp("generic")
    (tmp / "cuda_runtime.h").write_text(reh.STUB)
    (tmp / "generated.cuh").write_text(gen)
    (tmp / "harness.cpp").write_text(HARNESS)
    so = tmp / "generic.so"
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
    lib.ilqr_generic_split.restype = ctypes.c_size_t
    lib.ilqr_generic_split.argtypes = ([ctypes.c_int] * 4
                                       + [ctypes.c_size_t, ctypes.c_int])
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _id(spec):
    return spec.id if spec.struct is None else GENERATED[
        next(k for k, (_, s) in GENERATED.items() if s is spec)][0]


def rehearse(lib, spec, shared, rows, H, n_ref, T, max_it, max_lg=1,
             integrator=ilqr.EULER, smem_limit=ig.SMEM_LIMIT, order=None,
             prof=None):
    """The body on a grid of B = len(rows) blocks: (B, n_out) results."""
    rows = np.ascontiguousarray(rows, np.float64)
    shared = np.ascontiguousarray(shared, np.float64)
    B = rows.shape[0]
    pid = _id(spec)
    ws_words = lib.rehearse_generic_split(pid, H, n_ref, smem_limit, 1)
    ws = np.full(max(B * ws_words, 1), np.nan)
    out = np.zeros((B, ig._size(ig.output_layout(spec, H))))
    o = None if order is None else np.ascontiguousarray(order, np.int32)
    lib.rehearse_generic(pid, integrator, _ptr(shared), _ptr(rows),
                         _ptr(out), _ptr(ws), _ptr(prof), B, H, n_ref, T,
                         max_it, max_lg, smem_limit, _ptr(o))
    return out


def _split(spec, host, H, n_ref):
    n_sh = ig._size(ig.shared_layout(spec, H, n_ref))
    return host[:n_sh], host[n_sh:][None]


# ---------------------------------------------------------------------
# the cases

def native_case(name, H, T, warm, seed):
    """(spec, inputs, params, mu_step, max_iterations) of a native problem
    at n_ref = 512 (``scenes.generic_native_case``)."""
    return (ig.NATIVE[name],
            *scenes.generic_native_case(name, H, T, warm, seed, N_REF))


def mpc_case(warm, seed):
    """(spec, inputs, params, mu_step, H) of the generated genopt MPC."""
    return (GENERATED["genopt_mpc"][1], *scenes.genopt_mpc_case(warm, seed),
            60)


def plain(spec, host, H, n_ref, T, it, lg, integrator):
    out = ig.update_reference(spec, torch.from_numpy(host), H, n_ref, T, it,
                              lg, integrator)
    return ig.unpack_outputs(spec, out.numpy(), H)


def assert_matches(got, want, max_it, tol=RTOL):
    for k in ("x", "u", "lam"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(got["traj_costs"], want["traj_costs"],
                               rtol=tol)
    assert got["mu_step"] == want["mu_step"]
    assert got["iterations"] == want["iterations"]
    assert 1 <= got["iterations"] <= max_it
    assert np.all(np.isfinite(got["x"]))


# each native problem cold and warm at H = 250 and 300, the integrators in
# turn (every problem meets each of the three)
NATIVE_CASES = [(name, H, T, warm, integ)
                for k, name in enumerate(("ref_line_smoother_k",
                                          "ref_line_smoother_dk",
                                          "velocity_profile_time"))
                for j, (H, T, warm) in enumerate(((250, 250, False),
                                                  (250, 230, True),
                                                  (300, 300, False),
                                                  (300, 280, True)))
                for integ in [(k + j) % 3]]


@pytest.mark.parametrize("name,H,T,warm,integ", NATIVE_CASES)
def test_native_body_matches_plain(body, name, H, T, warm, integ):
    spec, inputs, params, mu, it = native_case(name, H, T, warm,
                                               seed=H + T + integ)
    host = ig.pack_inputs(spec, inputs, params, mu)
    shared, rows = _split(spec, host, H, N_REF)
    smem = SMALL_SMEM if H == 300 else ig.SMEM_LIMIT
    if H == 300:
        assert body.rehearse_generic_split(spec.id, H, N_REF, smem, 1) > 0
    out = rehearse(body, spec, shared, rows, H, N_REF, T, it,
                   integrator=integ, smem_limit=smem)
    assert_matches(ig.unpack_outputs(spec, out[0], H),
                   plain(spec, host, H, N_REF, T, it, 1, integ), it)


def test_native_profiling_body_is_bit_equal(body):
    spec, inputs, params, mu, it = native_case("velocity_profile_time", 250,
                                               250, True, seed=9)
    host = ig.pack_inputs(spec, inputs, params, mu)
    shared, rows = _split(spec, host, 250, N_REF)
    prof = np.zeros(len(ilqr.PHASES), np.int64)
    a = rehearse(body, spec, shared, rows, 250, N_REF, 250, it)
    b = rehearse(body, spec, shared, rows, 250, N_REF, 250, it, prof=prof)
    assert np.array_equal(a, b)
    assert np.all(prof > 0)


@pytest.mark.parametrize("warm", [False, True])
def test_generated_mpc_body_matches_plain(body, warm):
    spec, inputs, params, mu, H = mpc_case(warm, seed=3 + warm)
    host = ig.pack_inputs(spec, inputs, params, mu)
    shared, rows = _split(spec, host, H, 128)
    out = rehearse(body, spec, shared, rows, H, 128, H, 8,
                   integrator=ilqr.HEUN)
    got = ig.unpack_outputs(spec, out[0], H)
    assert_matches(got, plain(spec, host, H, 128, H, 8, 1, ilqr.HEUN), 8)
    assert float(np.abs(got["u"]).max()) > 1e-3
    if not warm:
        # the JAX package's genopt solve of the same inputs
        j_prob, _ = j_genopt.make_problem(
            scenes.genopt_mpc_config(j_spx, j_genopt))
        want = jax_solve(j_prob, spec, inputs, params, mu, H, H, 8,
                         ilqr.HEUN)
        assert_jax(got, want)


def test_generated_every_function_body_matches_plain(body):
    spec = GENERATED["every_function"][1]
    assert set(genopt.CUDA_FUNCTIONS) - set(genopt.PORT_FUNCTIONS) <= {
        type(f).__name__ for e in (funcs_config().costs
                                   + funcs_config().dynamics
                                   + funcs_config().constraints)
        for f in sp.preorder_traversal(sp.sympify(e))} | {"Pow", "sqrt"}
    H = 40
    inputs, params, mu = scenes.genopt_every_function_case(11, H)
    host = ig.pack_inputs(spec, inputs, params, mu)
    shared, rows = _split(spec, host, H, 64)
    for integ in (ilqr.EULER, ilqr.RK4):
        out = rehearse(body, spec, shared, rows, H, 64, H, 6, max_lg=2,
                       integrator=integ)
        got = ig.unpack_outputs(spec, out[0], H)
        assert_matches(got, plain(spec, host, H, 64, H, 6, 2, integ), 12)
    j_prob, _ = j_genopt.make_problem(funcs_config(j_spx, j_genopt))
    assert_jax(got, jax_solve(j_prob, spec, inputs, params, mu, H, H, 6,
                              ilqr.RK4, lg=2))


# ---------------------------------------------------------------------
# the JAX package's solve of the same inputs

def jax_solve(j_prob, spec, inputs, params, mu, H, T, it, integrator, lg=1):
    upd = j_ilqr.make_update_fn(j_prob, H, integrator, dtype=jnp.float64)
    cfg = dict(u_min=jnp.asarray(inputs["u_lims"][..., 0]),
               u_max=jnp.asarray(inputs["u_lims"][..., 1]),
               barrier_weight=jnp.asarray(inputs["bw_lim"][:, 0]),
               lg_mult_limit=jnp.asarray(inputs["bw_lim"][:, 1]),
               dt=jnp.float64(inputs["cfg_f"][0]),
               min_rel_cost_change=jnp.float64(inputs["cfg_f"][1]),
               T=jnp.int32(T), max_iterations=jnp.int32(it),
               max_lg_iterations=jnp.int32(lg))
    p = {k: jnp.asarray(np.asarray(v, np.float64)) for k, v in params.items()
         if k in spec.scalars + spec.tables}
    state = j_ilqr.SolverState(jnp.asarray(inputs["x"]),
                               jnp.asarray(inputs["u"]),
                               jnp.asarray(inputs["lam"]), jnp.int32(mu))
    new, info = upd(state, jnp.asarray(inputs["x"][0]), p, cfg)
    return dict(x=np.asarray(new.x), u=np.asarray(new.u),
                traj_costs=float(info["traj_costs"]))


def assert_jax(got, want):
    np.testing.assert_allclose(got["x"], want["x"], rtol=SOLVE_RTOL,
                               atol=SOLVE_X_ATOL)
    np.testing.assert_allclose(got["u"], want["u"], rtol=SOLVE_RTOL,
                               atol=SOLVE_U_ATOL)
    np.testing.assert_allclose(got["traj_costs"], want["traj_costs"],
                               rtol=SOLVE_RTOL)


@pytest.mark.parametrize("H", [250, 300])
@pytest.mark.parametrize("name", ["ref_line_smoother_k",
                                  "ref_line_smoother_dk",
                                  "velocity_profile_time"])
def test_native_body_matches_jax(body, name, H):
    spec, inputs, params, mu, it = native_case(name, H, H, False, seed=5)
    host = ig.pack_inputs(spec, inputs, params, mu)
    shared, rows = _split(spec, host, H, N_REF)
    out = rehearse(body, spec, shared, rows, H, N_REF, H, it,
                   integrator=ilqr.HEUN,
                   smem_limit=SMALL_SMEM if H == 300 else ig.SMEM_LIMIT)
    j_prob, _ = getattr(j_problems, name)(ref_capacity=N_REF)
    assert_jax(ig.unpack_outputs(spec, out[0], H),
               jax_solve(j_prob, spec, inputs, params, mu, H, H, it,
                         ilqr.HEUN))


# ---------------------------------------------------------------------
# the two tracking MPCs through the generic kernel

TRACKING = ("trajectory_tracking_mpc", "trajectory_tracking_mpc_time")


def tracking_case(name, H, seed, warm=False):
    """(spec, inputs, params, mu_step, n_ref) of a tracking MPC's seeded
    solve at horizon H (HEUN, 8 iterations): the spatial one on the genopt
    MPC's course (``scenes.genopt_mpc_case``), the time-indexed one on
    ``scenes.mpc_time_generic_case``."""
    if name == "trajectory_tracking_mpc":
        inputs, params, mu = scenes.genopt_mpc_case(warm, seed, H)
    else:
        inputs, params, mu = scenes.mpc_time_generic_case(H, seed, warm)
    return ig.NATIVE[name], inputs, params, mu, 128


@pytest.mark.parametrize("H", [60, 200])
@pytest.mark.parametrize("name", TRACKING)
def test_tracking_mpc_struct_matches_plain(body, name, H):
    """The hand-written structs of the two tracking MPCs (csrc/
    ilqr_generic.cu) in the body against the plain float64 update (equal
    mu_step and iterations), cold at H = 60 at RTOL = ATOL = 1e-12 and warm
    at H = 200 with a 24 KB shared-memory limit (the arrays past it in the
    workspace) at TRACKING_TOL: the structs' derivatives are autograd's
    formulas rounded in another order, and the long solves amplify that;
    at H = 200 also against the JAX package's make_update_fn at the solve
    tolerance."""
    spec, inputs, params, mu, n_ref = tracking_case(name, H, 7, H == 200)
    host = ig.pack_inputs(spec, inputs, params, mu)
    shared, rows = _split(spec, host, H, n_ref)
    smem = SMALL_SMEM if H == 200 else ig.SMEM_LIMIT
    out = rehearse(body, spec, shared, rows, H, n_ref, H, 8,
                   integrator=ilqr.HEUN, smem_limit=smem)
    got = ig.unpack_outputs(spec, out[0], H)
    assert_matches(got, plain(spec, host, H, n_ref, H, 8, 1, ilqr.HEUN), 8,
                   RTOL if H == 60 else TRACKING_TOL)
    assert float(np.abs(got["u"]).max()) > 1e-3
    if H == 200:
        j_prob, _ = getattr(j_problems, name)(ref_capacity=n_ref)
        assert_jax(got, jax_solve(j_prob, spec, inputs, params, mu, H, H, 8,
                                  ilqr.HEUN))


def test_factories_hold_300_and_route_by_capacity(monkeypatch):
    """Every ``optimizers`` factory holds the JAX package's horizon of 300
    on every device; a tracking MPC's solver names its own kernel exactly
    while its horizon_max fits that kernel's shared memory (110 spatial and
    132 time-indexed steps at 128 reference samples) and the generic kernel
    beyond; float32 takes no kernel; the vendored controller's solver (60)
    keeps the MPC's own kernel.  On the CPU a solver at 300 goes through
    ilqr_generic.solve, whose CPU tensor runs the plain update."""
    from tpl_tpu_torch.control import tracking_mpc
    from tpl_tpu_torch.optim import optimizers, problems

    for name in optimizers._FACTORIES:
        make = getattr(optimizers, name)
        assert make(device="cpu").horizon_max == optimizers.HORIZON_MAX == 300
        assert not hasattr(make, "cuda_horizon_max")
    for name, own, cap in (("trajectory_tracking_mpc", "ilqr_tracking_mpc",
                            110),
                           ("trajectory_tracking_mpc_time",
                            "ilqr_tracking_mpc_time", 132)):
        prob, pspec = getattr(problems, name)()
        for H in (20, 60, cap, cap + 1, 200, 300):
            s = solver.Solver(prob, pspec, horizon_max=H,
                              dtype=torch.float64, device="cpu")
            assert s.route == (own if H <= cap else "ilqr_generic"), (name, H)
        assert solver.Solver(prob, pspec, horizon_max=60, dtype=torch.float32,
                             device="cpu").route is None
        assert getattr(optimizers, name)(device="cpu").route == "ilqr_generic"
    assert tracking_mpc.TrackingMpc.HORIZON_MAX == 60
    prob, pspec = problems.trajectory_tracking_mpc()
    assert solver.Solver(prob, pspec, horizon_max=60, dtype=torch.float64,
                         device="cpu").route == "ilqr_tracking_mpc"
    calls = []
    real = ig.solve
    monkeypatch.setattr(ig, "solve", lambda *a, **k: (calls.append(a),
                                                      real(*a, **k))[1])
    opt = optimizers.trajectory_tracking_mpc_time(device="cpu")
    inputs, params, _ = scenes.mpc_time_generic_case(300, 1)
    for k, v in params.items():
        setattr(opt.params, k, v)
    opt.horizon, opt.step, opt.max_iterations = 300, 0.05, 2
    opt.x[0] = inputs["x"][0]
    opt.update()
    assert len(calls) == 1 and calls[0][0] == "trajectory_tracking_mpc_time"
    assert np.all(np.isfinite(opt.x)) and opt.iterations >= 1


# ---------------------------------------------------------------------
# a grid of 4 blocks

def batch_case(name, B, rng):
    """(spec, H, n_ref, T, it, integrator, params, cfg, x0 (nx, B), u, lam,
    mu_step) of a seeded batch in the public layout (batch last)."""
    if name == "genopt_mpc":
        spec, inputs, params, _, H = mpc_case(False, 1)
        n_ref, it, integ = 128, 8, ilqr.HEUN
        x0 = (inputs["x"][0][:, None]
              + rng.normal(0.0, 0.3, (7, B)) * np.array(
                  [1, 1, 0.2, 0.1, 3, 0, 0.5])[:, None])
    elif name == "lateral_profile":
        spec, H, n_ref, it, integ = ig.NATIVE[name], 80, 128, 6, ilqr.EULER
        lower = np.full(n_ref, -2.0)
        lower[8:14] = 0.4
        params = dict(k_ref=0.01 * np.sin(np.arange(n_ref) * 0.1),
                      d_offset=np.zeros(n_ref), d_lower_constr=lower,
                      d_upper_constr=np.full(n_ref, 2.0), ref_step=0.5,
                      w_d=0.5, w_v_d=0.5, w_a_d=0.5, w_k=0.5)
        inputs, _ = scenes.generic_inputs(2, 1, 2, H, H, rng, False,
                                          [-2.5, 2.5], 1000.0, 0.1, 0.5,
                                          [0.0, 0.0], 0.0)
        x0 = np.stack([rng.normal(0.0, 0.5, B), rng.normal(0.0, 0.05, B)])
    else:
        spec, inputs, params, _, it = native_case(name, 120, 120, False, 2)
        H, n_ref, integ = 120, N_REF, ilqr.RK4
        x0 = (inputs["x"][0][:, None]
              + rng.normal(0.0, 0.3, (spec.nx, B)))
    u = rng.normal(0.0, 0.02, (H, spec.nu, B))
    lam = np.zeros((H, spec.ncl, B))
    mu = rng.integers(0, 3, B)
    cfg = dict(u_min=inputs["u_lims"][..., 0], u_max=inputs["u_lims"][..., 1],
               barrier_weight=inputs["bw_lim"][:, 0],
               lg_mult_limit=inputs["bw_lim"][:, 1], dt=inputs["cfg_f"][0],
               min_rel_cost_change=inputs["cfg_f"][1], T=H,
               max_iterations=it, max_lg_iterations=1)
    return spec, H, n_ref, it, integ, params, cfg, x0, u, lam, mu


@pytest.mark.parametrize("name", ["ref_line_smoother_k", "genopt_mpc",
                                  "lateral_profile"])
def test_grid_of_four_blocks_matches_single_and_plain_batch(body, name):
    rng = np.random.default_rng(7)
    B = 4
    spec, H, n_ref, it, integ, params, cfg, x0, u, lam, mu = batch_case(
        name, B, rng)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    tp = {k: t(v) for k, v in params.items()}
    tcfg = {k: (t(v) if isinstance(v, (np.ndarray, float)) else v)
            for k, v in cfg.items()}
    x = torch.zeros((H + 1, spec.nx, B), dtype=torch.float64)
    shared, rows = ig.pack_inputs_batched(
        spec, x, t(u), t(lam), torch.as_tensor(mu, dtype=torch.int32),
        t(x0), tp, tcfg)
    order = np.random.default_rng(3).permutation(B)
    out = rehearse(body, spec, shared.numpy(), rows.numpy(), H, n_ref, H,
                   it, integrator=integ, order=order)
    singles = ig.rows_of_batch(shared, rows).numpy()
    n_sh = shared.numel()
    for b in range(B):
        one = rehearse(body, spec, singles[b, :n_sh], singles[b, n_sh:][None],
                       H, n_ref, H, it, integrator=integ)
        assert np.array_equal(out[b], one[0]), b
    got = ig.unpack_outputs_batched(spec, torch.from_numpy(out), H)
    upd = batched.make_batched_update_fn(spec.problem, H, B, integ,
                                         torch.float64)
    want = upd.reference(x, t(u), t(lam), torch.as_tensor(mu), t(x0), tp,
                         tcfg, iterations=True)
    for g, w, what in zip(got, want, ("x", "u", "lam", "mu", "cost", "it")):
        if what in ("mu", "it"):
            assert np.array_equal(g.numpy(), w.numpy()), what
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=what)
    if name == "ref_line_smoother_k":
        j_prob, _ = j_problems.ref_line_smoother_k(ref_capacity=n_ref)
        j_upd = j_batched.make_batched_update_fn(j_prob, H, B, integ,
                                                 dtype=jnp.float64)
        jp = {k: jnp.asarray(np.asarray(v, np.float64))
              for k, v in params.items() if k in spec.scalars + spec.tables}
        jcfg = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                for k, v in cfg.items()}
        jx, ju, _, jmu, jc = j_upd(jnp.zeros((H + 1, spec.nx, B)),
                                   jnp.asarray(u), jnp.asarray(lam),
                                   jnp.asarray(mu, jnp.int32),
                                   jnp.asarray(x0), jp, jcfg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jx),
                                   rtol=SOLVE_RTOL, atol=SOLVE_X_ATOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ju),
                                   rtol=SOLVE_RTOL, atol=SOLVE_U_ATOL)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(jc),
                                   rtol=SOLVE_RTOL)


# ---------------------------------------------------------------------
# the wrapper on the CPU

def test_split_moves_what_does_not_fit_to_the_workspace(body):
    spec = GENERATED["genopt_mpc"][1]
    pid = _id(spec)
    sm, ws = (body.rehearse_generic_split(pid, 300, 128, ig.SMEM_LIMIT, w)
              for w in (0, 1))
    assert 0 < sm * 8 <= ig.SMEM_LIMIT and ws > 0
    assert body.rehearse_generic_split(pid, 20, 128, ig.SMEM_LIMIT, 1) == 0
    nat = ig.NATIVE["ref_line_smoother_k"]
    assert (body.ilqr_generic_split(nat.id, 1, 300, 512, ig.SMEM_LIMIT, 0)
            == body.rehearse_generic_split(nat.id, 300, 512, ig.SMEM_LIMIT,
                                           0))


def test_solver_routes_and_cpu_takes_the_plain_update(monkeypatch):
    """On a CPU device a generated problem's Solver goes through
    ilqr_generic.solve, whose CPU tensor takes the plain make_update_fn: the
    result is the plain update's; a native problem of the generic kernel is
    in solver.KERNELS in both dtypes."""
    for name in ("ref_line_smoother_k", "ref_line_smoother_dk",
                 "velocity_profile_time"):
        for dtype in (torch.float32, torch.float64):
            assert (name, dtype) in solver.KERNELS
    opt = genopt.build(scenes.genopt_mpc_config(), device="cpu",
                       dtype=torch.float64)()
    assert opt.problem.generated is not None and opt.problem.kernel is None
    calls = []
    real = ig.solve
    monkeypatch.setattr(ig, "solve", lambda *a, **k: (calls.append(a),
                                                      real(*a, **k))[1])
    inputs, x0 = scenes.genopt_mpc_solve_inputs()
    for k, v in inputs.items():
        setattr(opt.params, k, v)
    opt.horizon, opt.step, opt.max_iterations = 20, 0.05, 4
    opt.x[0] = x0
    state_in = {k: np.array(v) for k, v in opt._inputs().items()}
    opt.update()
    assert len(calls) == 1
    upd = ilqr.make_update_fn(opt.problem, opt.horizon_max, ilqr.EULER,
                              dtype=torch.float64)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    cfg = ilqr.packed_cfg(t(state_in["u_lims"]), t(state_in["bw_lim"]),
                          t(state_in["cfg_f"]), 20, 4, 1)
    p = {k: t(v) for k, v in opt.params._values.items()}
    new, info = upd(ilqr.SolverState(t(state_in["x"]), t(state_in["u"]),
                                     t(state_in["lam"]), 0),
                    t(state_in["x"][0]), p, cfg)
    np.testing.assert_array_equal(opt._x, new.x.numpy())
    np.testing.assert_array_equal(opt._u, new.u.numpy())
    assert opt.traj_costs == float(info["traj_costs"])


def test_unprintable_function_warns_and_solves_plain(monkeypatch):
    x, u = sp.symbols("x u0")
    cfg = genopt.Config(states=[x], actions=[u], params=[], dynamics=[u],
                        costs=[x ** 2 + 0.1 * u ** 2 + 0.01 * sp.floor(x)],
                        name="with_floor")
    with pytest.warns(UserWarning, match="floor"):
        make = genopt.build(cfg, device="cpu", dtype=torch.float64)
    assert make.problem.generated is None
    monkeypatch.setattr(ig, "solve", lambda *a, **k: pytest.fail(
        "a problem without a printed struct reached the generic kernel"))
    opt = make()
    opt.horizon = 10
    opt.x[0] = [1.0]
    opt.update()
    assert opt.iterations > 0 and abs(opt.x[-1, 0]) < 1.0


def test_batched_update_names_the_problems_with_a_batched_kernel():
    """A problem the tracer refuses (a user's torch problem with an
    operation outside its table) raises on CUDA tensors: the message says
    what the tracer refused and names the problems that have a batched
    kernel, the time-indexed tracking MPC among them (the generic kernel's
    batch); on CPU tensors every problem takes the plain version."""
    from tpl_tpu_torch.optim import problems, trace

    prob = ilqr.Problem("my_problem", nx=1, nu=1, nc=0,
                        dynamics=lambda x, u, t, dt, p: u,
                        cost=lambda x, u, t, dt, p: torch.floor(x[..., 0]))
    with pytest.raises(trace.Untraceable) as refused:
        ig.spec_of(prob, ())
    msg = batched.no_batched_kernel_message("my_problem", refused.value)
    for name in ("trajectory_tracking_mpc", "trajectory_tracking_mpc_time",
                 "lateral_profile", "velocity_profile_space",
                 "ref_line_smoother_k", "ref_line_smoother_dk",
                 "velocity_profile_time"):
        assert name in msg
    assert msg.count("trajectory_tracking_mpc,") == 1
    assert "generated" in msg and "my_problem" in msg
    assert "my_problem.cost" in msg and "floor" in msg
    assert "tracer takes" in msg

    prob, _ = problems.trajectory_tracking_mpc_time()
    assert ig.spec_of(prob) is ig.NATIVE["trajectory_tracking_mpc_time"]


def test_operation_counts_and_bounds():
    spec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
    assert spec.ops["dynamics"] > 0 and spec.ops["cost"] > spec.ops[
        "dynamics"]
    ms, by = ig.bound_ms(spec, 60, 128, 60, 8, integrator=ilqr.HEUN)
    assert ms > 0 and by in ("bytes", "operations")
    ms_b, _ = ig.bound_ms(spec, 60, 128, 60, [8] * 2048,
                          integrator=ilqr.HEUN)
    assert ms_b > ms
    ops = ig.chain_ops(spec, 60, 60, 8, ilqr.HEUN)
    assert all(k in ig._latency.PROBES for k in ops)
    for name in ig.NATIVE:
        assert ig.chain_ops(name, 250, 250, 4, dtype=torch.float32)
        assert ig.operations(name, 250, 250, 4) > 0


def test_generated_library_named_by_its_text():
    """A sympy config's source for each dtype: the struct in a unit that
    includes the body, built into build/tpl_tpu_torch/ under the config's
    name and the hash of its text and headers."""
    spec = genopt.make_problem(scenes.genopt_mpc_config())[0].generated
    t64, t32 = (ig.source_text(spec, d) for d in (torch.float64,
                                                  torch.float32))
    for text, flag in ((t64, "ILQR_GENERIC_F64_ONLY"),
                       (t32, "ILQR_GENERIC_F32_ONLY")):
        assert flag in text and spec.struct in text
        assert '#include "ilqr_generic_body.cuh"' in text
    src, so = _build._generated(ig._tag(spec), t64)
    assert (src, so) == _build._generated(ig._tag(spec), t64)
    assert so != _build._generated(ig._tag(spec), t32)[1]
    assert src.startswith(_build.BUILD_DIR) and "genopt_mpc_sympy_" in so
