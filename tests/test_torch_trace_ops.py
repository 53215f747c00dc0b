"""What the tracer (``tpl_tpu_torch/optim/trace.py``) takes beyond the
arithmetic, as ``jax.jit`` takes it from a problem in the JAX package:
products, captured constants and tables, shape operations, reductions,
the elementwise functions, indexing by a traced value and ``blerp``.

Each operation is a one-function problem (:data:`OPS`): a double
integrator (states p, v; action a) whose step cost adds one term written
with the operation, in torch for the port and in jnp for the JAX package.
Inputs are seeded with numpy.

- Each problem traces and prints (its struct calls the operation's jet
  form or the composition the tracer prints for it).
- Its plain float64 torch solve (``optim.ilqr.make_update_fn``, H = 12,
  HEUN, 8 iterations) agrees with the JAX package's ``make_update_fn`` on
  the jnp twin at 1e-12 with equal iteration counts.  The twins run as one
  JAX program, a ``lax.switch`` over the operations on a param, so that
  XLA compiles once.
- Every struct is compiled with g++ in one translation unit (the kernel
  body's header and the structs' functions on the kernel's second-order
  jets, the entry of tests/test_torch_trace.py): its value, gradient and
  Hessian over (x, u) equal ``torch.func``'s of the plain functions at
  1e-12, at seeded points and at the operation's kinks (relu at 0, the
  2-norm at 0, an amax tie, softplus past its threshold), where the jets
  take autograd's slopes.
- Indexing by a traced value reads as jnp reads it: the struct's cost at
  steps whose index runs past either end of a captured tensor (clamped)
  and below 0 (counted from the end once) equals the JAX program's.

    python -m pytest tests/test_torch_trace_ops.py -q
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from tpl_tpu.ops import interp as j_interp
from tpl_tpu.optim import ilqr as j_ilqr

from tpl_tpu_torch import _build
from tpl_tpu_torch.ops import interp
from tpl_tpu_torch.optim import ilqr, trace

import test_torch_kernel_rehearsal as reh
import test_torch_trace as ttr

RTOL = ATOL = 1e-12
H, IT, DT = 12, 8, 0.1
X0, U0 = (1.0, -0.5), 0.1

_rng = np.random.default_rng(7)
M = _rng.normal(0.0, 0.5, (2, 2)) + 2.0 * np.eye(2)     # folded (4 numbers)
W = 0.5 + _rng.uniform(0.0, 1.0, H)                      # a weight a step
W2 = _rng.uniform(0.5, 1.5, (H, 2))
WBIG = _rng.normal(0.0, 0.1, (2, 50))                    # > FOLD_MAX: a table
TAB = np.cos(0.3 * np.arange(16))
GRID = _rng.uniform(-1.0, 1.0, (6, 7))
PARAMS = {"blerp_param": {"g": _rng.uniform(-1.0, 1.0, 20)},
          "table_index": {"w": 0.5 + _rng.uniform(0.0, 1.0, H)}}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


tM, tW, tW2, tWBIG, tTAB, tGRID = map(_t, (M, W, W2, WBIG, TAB, GRID))
jM, jW, jW2, jWBIG, jTAB, jGRID = map(jnp.asarray, (M, W, W2, WBIG, TAB,
                                                   GRID))


def _one_step(x):
    return x.dim() == 1


# name -> (the torch term, the jnp term, the printed form it must show): a
# term of (x, u, t, p); the torch one takes leading (batch) dims, the jnp
# one a single step, as each package calls a problem's functions.  Torch
# defines mm, mv, dot and outer on one step's 1-D / 2-D values only: those
# terms take the batch through matmul / einsum, which the tracer, seeing
# one step, does not reach.
OPS = {
    "matmul": (lambda x, u, t, p: ((x @ tM) * x).sum(-1),
               lambda x, u, t, p: x @ jM @ x, "x[1]"),
    "tensor_matmul": (
        lambda x, u, t, p: ((tM @ x.unsqueeze(-1)).squeeze(-1) ** 2).sum(-1),
        lambda x, u, t, p: ((jM @ x) ** 2).sum(), "j_ipow"),
    "mm": (lambda x, u, t, p: (torch.mm(tM, x.unsqueeze(-1)) ** 2).sum()
           if _one_step(x) else ((tM @ x.unsqueeze(-1)) ** 2).sum((-1, -2)),
           lambda x, u, t, p: ((jM @ x) ** 2).sum(), "j_ipow"),
    "mv": (lambda x, u, t, p: torch.mv(tM, x).pow(2).sum() if _one_step(x)
           else ((tM @ x.unsqueeze(-1)) ** 2).sum((-1, -2)),
           lambda x, u, t, p: ((jM @ x) ** 2).sum(), "j_ipow"),
    "dot": (lambda x, u, t, p: torch.dot(x, x + 1.0) if _one_step(x)
            else (x * (x + 1.0)).sum(-1),
            lambda x, u, t, p: jnp.dot(x, x + 1.0), "x[0]"),
    "outer": (lambda x, u, t, p: (torch.outer(x, x) * tM).sum()
              if _one_step(x) else (x.unsqueeze(-1) * x.unsqueeze(-2)
                                    * tM).sum((-1, -2)),
              lambda x, u, t, p: (jnp.outer(x, x) * jM).sum(), "x[1]"),
    "einsum": (lambda x, u, t, p: torch.einsum("...i,ij,...j->...", x, tM,
                                               x),
               lambda x, u, t, p: jnp.einsum("i,ij,j->", x, jM, x), "x[1]"),
    "reshape": (lambda x, u, t, p: (x.reshape(*x.shape[:-1], 2, 1) ** 2)
                .sum((-2, -1)),
                lambda x, u, t, p: (x.reshape(2, 1) ** 2).sum(), "j_ipow"),
    "view": (lambda x, u, t, p: (x.view(*x.shape[:-1], 1, 2) ** 2).sum(
        (-2, -1)), lambda x, u, t, p: (x ** 2).sum(), "j_ipow"),
    "flatten": (lambda x, u, t, p: (x.unsqueeze(-1).flatten(-2) * tW[:2])
                .sum(-1),
                lambda x, u, t, p: (x * jW[:2]).sum(), "x[0]"),
    "unsqueeze_squeeze": (
        lambda x, u, t, p: (x.unsqueeze(-2) @ tM).squeeze(-2)[..., 0] ** 2,
        lambda x, u, t, p: (x @ jM)[0] ** 2, "j_ipow"),
    "transpose": (
        lambda x, u, t, p: (x.unsqueeze(-1).transpose(-1, -2) @ tM
                            @ x.unsqueeze(-1)).squeeze(-1).squeeze(-1),
        lambda x, u, t, p: x @ jM @ x, "x[1]"),
    "T": (lambda x, u, t, p: (torch.stack([x, 2.0 * x]).T * tM).sum()
          if _one_step(x) else (torch.stack([x, 2.0 * x], -1) * tM)
          .sum((-1, -2)),
          lambda x, u, t, p: (jnp.stack([x, 2.0 * x]).T * jM).sum(), "x[0]"),
    "permute": (lambda x, u, t, p: (torch.stack([x, x * x], -2).permute(
        *range(x.dim() - 1), -1, -2) * tM).sum((-1, -2)),
        lambda x, u, t, p: (jnp.stack([x, x * x]).T * jM).sum(), "x[0]"),
    "expand": (lambda x, u, t, p: (x[..., :1].expand(*x.shape[:-1], 3) ** 2)
               .sum(-1),
               lambda x, u, t, p: 3.0 * x[0] ** 2, "j_ipow"),
    "slice": (lambda x, u, t, p: x[..., 1:2].sum(-1) * x[..., :1].sum(-1),
              lambda x, u, t, p: x[1] * x[0], "x[1]"),
    "mean": (lambda x, u, t, p: (x ** 2 + u ** 2).mean(-1),
             lambda x, u, t, p: jnp.mean(x ** 2 + u ** 2), "j_ipow"),
    "prod": (lambda x, u, t, p: (x + 2.0).prod(-1),
             lambda x, u, t, p: jnp.prod(x + 2.0), "x[0]"),
    "amax": (lambda x, u, t, p: torch.amax(x * tM[0], -1),
             lambda x, u, t, p: jnp.max(x * jM[0]), "j_amax"),
    "amin": (lambda x, u, t, p: torch.amin(x * tM[1], -1),
             lambda x, u, t, p: jnp.min(x * jM[1]), "j_amin"),
    "vector_norm": (lambda x, u, t, p: torch.linalg.vector_norm(
        x + 0.3, dim=-1), lambda x, u, t, p: jnp.linalg.norm(x + 0.3),
        "j_norm2"),
    "vector_norm_1": (lambda x, u, t, p: torch.linalg.vector_norm(
        x + 3.0, ord=1, dim=-1),
        lambda x, u, t, p: jnp.linalg.norm(x + 3.0, ord=1), "j_abs"),
    "linalg_norm": (lambda x, u, t, p: torch.linalg.norm(x - 0.2, dim=-1),
                    lambda x, u, t, p: jnp.linalg.norm(x - 0.2), "j_norm2"),
    "norm": (lambda x, u, t, p: (x + 0.5).norm(dim=-1),
             lambda x, u, t, p: jnp.linalg.norm(x + 0.5), "j_norm2"),
    "cumsum": (lambda x, u, t, p: (torch.cumsum(x, -1) ** 2).sum(-1),
               lambda x, u, t, p: (jnp.cumsum(x) ** 2).sum(), "j_ipow"),
    "neg": (lambda x, u, t, p: torch.neg(x[..., 0]) * x[..., 1],
            lambda x, u, t, p: -x[0] * x[1], "x[0]"),
    "reciprocal": (lambda x, u, t, p: torch.reciprocal(2.0 + x[..., 0] ** 2),
                   lambda x, u, t, p: 1.0 / (2.0 + x[0] ** 2), "j_ipow"),
    "rsqrt": (lambda x, u, t, p: torch.rsqrt(1.0 + x[..., 1] ** 2),
              lambda x, u, t, p: jax.lax.rsqrt(1.0 + x[1] ** 2), "j_sqrt"),
    "erf": (lambda x, u, t, p: torch.erf(x[..., 0] - x[..., 1]),
            lambda x, u, t, p: jax.scipy.special.erf(x[0] - x[1]), "j_erf"),
    "sigmoid": (lambda x, u, t, p: torch.sigmoid(2.0 * x[..., 0]),
                lambda x, u, t, p: jax.nn.sigmoid(2.0 * x[0]), "j_sigmoid"),
    "softplus": (lambda x, u, t, p: F.softplus(x[..., 0] + x[..., 1],
                                               beta=2.0, threshold=1.5),
                 lambda x, u, t, p: jnp.where(
                     2.0 * (x[0] + x[1]) > 1.5, x[0] + x[1],
                     jnp.log1p(jnp.exp(2.0 * (x[0] + x[1]))) / 2.0),
                 "j_softplus"),
    "log1p": (lambda x, u, t, p: torch.log1p(x[..., 0] ** 2),
              lambda x, u, t, p: jnp.log1p(x[0] ** 2), "j_log1p"),
    "expm1": (lambda x, u, t, p: torch.expm1(0.5 * x[..., 1]),
              lambda x, u, t, p: jnp.expm1(0.5 * x[1]), "j_expm1"),
    "hypot": (lambda x, u, t, p: torch.hypot(x[..., 0] + 1.0, x[..., 1]),
              lambda x, u, t, p: jnp.hypot(x[0] + 1.0, x[1]), "j_hypot"),
    "relu": (lambda x, u, t, p: torch.relu(x[..., 0] - 0.2) * (1.0 + x[..., 1]),
             lambda x, u, t, p: jax.nn.relu(x[0] - 0.2) * (1.0 + x[1]),
             "j_relu"),
    "captured_table": (lambda x, u, t, p: (x.unsqueeze(-1) * tWBIG).sum(
        (-1, -2)), lambda x, u, t, p: (x[:, None] * jWBIG).sum(), "j_take"),
    "traced_index": (lambda x, u, t, p: tW[t] * x[..., 0] ** 2
                     + (tW2[t] * x).sum(-1),
                     lambda x, u, t, p: jW[t] * x[0] ** 2 + (jW2[t] * x).sum(),
                     "j_take"),
    "index_wraps": (lambda x, u, t, p: tW[t - 6] * x[..., 1] ** 2,
                    lambda x, u, t, p: jW[t - 6] * x[1] ** 2, "j_take"),
    "table_index": (lambda x, u, t, p: p["w"][t] * x[..., 0] ** 2,
                    lambda x, u, t, p: p["w"][t] * x[0] ** 2, "j_take"),
    "traced_value_index": (
        lambda x, u, t, p: x[t.clamp(0, 1)] ** 2 if _one_step(x)
        else torch.where(t >= 1, x[..., 1], x[..., 0]) ** 2,
        lambda x, u, t, p: x[jnp.clip(t, 0, 1)] ** 2, "j_select"),
    "lerp_captured": (lambda x, u, t, p: interp.lerp(0.0, 0.5, x[..., 0] + 2,
                                                     tTAB) * x[..., 1],
                      lambda x, u, t, p: j_interp.lerp(0.0, 0.5, x[0] + 2,
                                                       jTAB) * x[1], "j_lerp"),
    "blerp_captured": (
        lambda x, u, t, p: interp.blerp(-1.0, -1.5, 0.5, 0.5, x[..., 0],
                                        x[..., 1], tGRID),
        lambda x, u, t, p: j_interp.blerp(-1.0, -1.5, 0.5, 0.5, x[0], x[1],
                                          jGRID), "j_blerp"),
    "blerp_param": (
        lambda x, u, t, p: interp.blerp(-1.0, -1.0, 0.5, 0.5, x[..., 0],
                                        x[..., 1], p["g"].reshape(4, 5)),
        lambda x, u, t, p: j_interp.blerp(-1.0, -1.0, 0.5, 0.5, x[0], x[1],
                                          p["g"].reshape(4, 5)),
        "P.table2"),
}
NAMES = tuple(OPS)


def t_problem(name):
    term = OPS[name][0]

    def dynamics(x, u, t, dt, p):
        return torch.stack([x[..., 1], u[..., 0] - 0.2 * x[..., 0]], -1)

    def cost(x, u, t, dt, p):
        return (0.5 * (x ** 2).sum(-1) + 0.1 * u[..., 0] ** 2
                + 0.3 * term(x, u, t, p))

    return ilqr.Problem(f"op_{name}", nx=2, nu=1, nc=0, dynamics=dynamics,
                        cost=cost)


def t_params(name):
    return {k: _t(v) for k, v in PARAMS.get(name, {}).items()}


def kinds(name):
    return trace.kinds_of_params(t_params(name))


def j_problem():
    """The jnp twins as one JAX problem: ``p["op"]`` selects the term."""
    terms = [OPS[n][1] for n in NAMES]

    def dynamics(x, u, t, dt, p):
        return jnp.stack([x[1], u[0] - 0.2 * x[0]])

    def cost(x, u, t, dt, p):
        term = jax.lax.switch(p["op"], [
            lambda x, u, t, p, f=f: jnp.asarray(f(x, u, t, p), jnp.float64)
            for f in terms], x, u, t, p)
        return 0.5 * jnp.sum(x ** 2) + 0.1 * u[0] ** 2 + 0.3 * term

    return j_ilqr.Problem("op_twins", nx=2, nu=1, nc=0, dynamics=dynamics,
                          cost=cost)


def _inputs():
    x = np.zeros((H + 1, 2))
    x[0] = X0
    return x, np.full((H, 1), U0), np.zeros((H, 1))


def plain_solve(name):
    x, u, lam = _inputs()
    upd = ilqr.make_update_fn(t_problem(name), H, ilqr.HEUN,
                              dtype=torch.float64)
    f = lambda v: torch.as_tensor(v, dtype=torch.float64)
    cfg = dict(u_min=f(np.full((H, 1), -2.0)), u_max=f(np.full((H, 1), 2.0)),
               barrier_weight=f(np.ones(1)), lg_mult_limit=f(np.full(1, 1e3)),
               dt=f(DT), min_rel_cost_change=f(1e-9), T=H, max_iterations=IT,
               max_lg_iterations=1)
    new, info = upd(ilqr.SolverState(f(x), f(u), f(lam), 0), f(x[0]),
                    t_params(name), cfg)
    return new.x.numpy(), new.u.numpy(), float(info["traj_costs"]), int(
        info["iterations"])


@pytest.fixture(scope="module")
def jax_solves():
    """name -> (x, u, cost) of the JAX program on each twin."""
    x, u, lam = _inputs()
    upd = j_ilqr.make_update_fn(j_problem(), H, ilqr.HEUN,
                                dtype=jnp.float64)
    cfg = dict(u_min=jnp.full((H, 1), -2.0), u_max=jnp.full((H, 1), 2.0),
               barrier_weight=jnp.ones(1), lg_mult_limit=jnp.full(1, 1e3),
               dt=jnp.float64(DT), min_rel_cost_change=jnp.float64(1e-9),
               T=jnp.int32(H), max_iterations=jnp.int32(IT),
               max_lg_iterations=jnp.int32(1))
    state = j_ilqr.SolverState(jnp.asarray(x), jnp.asarray(u),
                               jnp.asarray(lam), jnp.int32(0))
    tables = dict(g=jnp.zeros(20), w=jnp.zeros(H))
    out = {}
    for k, name in enumerate(NAMES):
        p = dict(tables, op=jnp.int32(k))
        p.update({n: jnp.asarray(v) for n, v in PARAMS.get(name, {}).items()})
        new, info = upd(state, jnp.asarray(x[0]), p, cfg)
        out[name] = (np.asarray(new.x), np.asarray(new.u),
                     float(info["traj_costs"]))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_operation_traces_and_prints(name):
    spec = trace.spec(t_problem(name), kinds(name))
    assert OPS[name][2] in spec.struct, spec.struct


@pytest.mark.parametrize("name", NAMES)
def test_operation_plain_solve_matches_jax(jax_solves, name):
    x, u, cost, its = plain_solve(name)
    jx, ju, jc = jax_solves[name]
    assert its >= 2 and np.all(np.isfinite(x))
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u, ju, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cost, jc, rtol=RTOL)


# ---------------------------------------------------------------------
# the structs' jets, compiled with g++

@pytest.fixture(scope="module")
def jets_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the structs for the host")
    specs = {n: trace.spec(t_problem(n), kinds(n)) for n in NAMES}
    specs["index_edges"] = trace.spec(index_edges_problem(), ())
    ids = {n: 100 + i for i, n in enumerate(specs)}
    gen = "\n".join(s.struct for s in specs.values())
    gen += "\n#define GENERATED_PROBLEMS(X) " + " ".join(
        f"X({ids[n]}, {s.struct_name})" for n, s in specs.items()) + "\n"
    tmp = tmp_path_factory.mktemp("trace_ops")
    (tmp / "cuda_runtime.h").write_text(reh.STUB)
    (tmp / "generated.cuh").write_text(gen)
    (tmp / "jets.cpp").write_text('#include "ilqr_generic_body.cuh"\n'
                                  '#include "generated.cuh"\n' + ttr.JETS)
    so = tmp / "jets.so"
    cmd = [gxx, "-std=c++20", "-O0", "-ffp-contract=off", "-shared", "-fPIC",
           "-x", "c++", "-I", str(tmp), "-I", _build.CSRC,
           str(tmp / "jets.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    ttr.bind_jets(lib)
    return lib, {n: (ids[n], s) for n, s in specs.items()}


# (p, v, a) on each operation's kinks, where the jets take autograd's
# slopes (and the seeded points elsewhere); at the 2-norm's 0 autograd's
# Hessian is NaN (its double backward divides by the norm)
KINKS = {
    "relu": [(0.2, 0.4, 0.1)],
    "vector_norm": [(-0.3, -0.3, 0.2)],
    "amax": [(1.0, M[0, 0] / M[0, 1], 0.0)],
    "amin": [(1.0, M[1, 0] / M[1, 1], 0.0)],
    "softplus": [(0.7, 0.4, 0.1), (0.3, 0.2, -0.4)],
    "traced_value_index": [(0.3, -0.7, 0.2)],
}


@pytest.mark.parametrize("name", NAMES)
def test_operation_jets_match_autograd(jets_lib, name):
    lib, specs = jets_lib
    pid, spec = specs[name]
    prob = t_problem(name)
    p = t_params(name)
    params = {k: v.numpy() for k, v in p.items()}
    rng = np.random.default_rng(len(name))
    points = [(rng.normal(0.0, 0.8, 2), rng.normal(0.0, 0.5, 1),
               int(rng.integers(0, H))) for _ in range(3)]
    points += [(np.array(k[:2]), np.array(k[2:]), 3)
               for k in KINKS.get(name, [])]
    if name == "vector_norm":
        # at the norm's 0: the value and autograd's slope 0; the Hessian NaN
        # over the states in both (torch.func's is NaN in some of the mixed
        # (state, action) entries too, one triangle only)
        x, u, t = points.pop()
        got = ttr.struct_jets(lib, pid, spec, x, u, t, DT, params)[2]
        want = ttr.plain_jets(prob, x, u, torch.tensor(t), DT, p)[2]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        assert np.isnan(got[2][:2, :2]).all() and np.isnan(
            want[2][:2, :2]).all()
    for x, u, t in points:
        ttr.assert_jets(ttr.struct_jets(lib, pid, spec, x, u, t, DT, params),
                        ttr.plain_jets(prob, x, u, torch.tensor(t), DT, p),
                        f"{name} at x={x}, u={u}, t={t}")


def index_edges_problem():
    """Costs read W at t + 5 (past the end from t = 7), t - 6 (below 0,
    counted from the end) and t - 20 (below -len(W): clamped to row 0)."""
    def cost(x, u, t, dt, p):
        return (tW[t + 5] * x[..., 0] ** 2 + tW[t - 6] * x[..., 1]
                + tW2[t - 20][..., 1] * u[..., 0] ** 2)

    return ilqr.Problem("index_edges", nx=2, nu=1, nc=0,
                        dynamics=lambda x, u, t, dt, p: torch.stack(
                            [x[..., 1], u[..., 0]], -1), cost=cost)


def test_traced_index_clamps_and_wraps_as_jnp(jets_lib):
    lib, specs = jets_lib
    pid, spec = specs["index_edges"]
    j_cost = jax.jit(lambda x, u, t: jW[t + 5] * x[0] ** 2 + jW[t - 6] * x[1]
                     + jW2[t - 20][1] * u[0] ** 2)
    x, u = np.array([0.7, -1.3]), np.array([0.4])
    for t in range(0, 2 * H):
        got = ttr.struct_jets(lib, pid, spec, x, u, t, DT, {})[2][0]
        want = float(j_cost(jnp.asarray(x), jnp.asarray(u), jnp.int32(t)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"t={t}")


def test_config_blerp_prints_through_the_same_entry():
    """The sympy front end's ``symext.blerp`` on a table param read as 2-D
    (``symext.table2``) prints as the tracer's does, and its plain version
    reads the table as ``interp.blerp`` reads the 2-D tensor."""
    import sympy as sp
    from tpl_tpu_torch.optim import genopt
    from tpl_tpu_torch.optim import symext as spx

    x, v, a = sp.symbols("x v a")
    g = spx.ArraySymbol("g")
    cfg = genopt.Config(
        states=[x, v], actions=[a], params={g: None}, dynamics=[v, a],
        costs=[spx.blerp(-1.0, -1.0, 0.5, 0.5, x, v, spx.table2(g, 4, 5))
               + a ** 2], name="config_blerp", array_capacity=20)
    prob, spec = genopt.make_problem(cfg)
    assert ("j_blerp(R(-1.0), R(-1.0), R(0.5), R(0.5), x[0], x[1], "
            "P.table2(0, 4, 5))") in prob.generated.struct
    grid = PARAMS["blerp_param"]["g"]
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.uniform(-1.5, 1.5, (5, 2)))
    got = prob.cost(xs, torch.zeros(5, 1, dtype=torch.float64), 0, 0.1,
                    {"g": _t(grid)})
    want = interp.blerp(-1.0, -1.0, 0.5, 0.5, xs[:, 0], xs[:, 1],
                        _t(grid).reshape(4, 5))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-15)


def test_blerp_clamps_and_takes_a_nan_as_the_plain_version(jets_lib):
    """``j_blerp`` on the captured grid against ``tpl_tpu.ops.interp.blerp``
    (the JAX package's) and the port's plain ``blerp``: queries past either
    edge of both axes (floor and ceil clamped to the grid, alpha clipped to
    [0, 1], so the jets take the edge's value and no slope there), and a
    NaN coordinate (row 0 read, its alpha NaN: the value NaN)."""
    lib, specs = jets_lib
    pid, spec = specs["blerp_captured"]
    prob = t_problem("blerp_captured")
    for x0, x1 in ((-3.0, 0.2), (4.0, -4.0), (0.7, 2.5), (-1.0, -1.5),
                   (float("nan"), 0.3), (0.4, float("nan"))):
        x, u = np.array([x0, x1]), np.array([0.1])
        got = ttr.struct_jets(lib, pid, spec, x, u, 3, DT, {})[2]
        term = float(j_interp.blerp(-1.0, -1.5, 0.5, 0.5, jnp.float64(x0),
                                    jnp.float64(x1), jGRID))
        want = 0.5 * (x0 ** 2 + x1 ** 2) + 0.1 * 0.01 + 0.3 * term
        np.testing.assert_allclose(got[0], want, rtol=RTOL, atol=ATOL)
        if np.isnan(want):
            continue
        ttr.assert_jets([got], [ttr.plain_jets(prob, x, u, torch.tensor(3),
                                               DT, {})[2]],
                        f"blerp at {(x0, x1)}")
