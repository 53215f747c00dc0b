"""
One full AL-iLQR update of the time-indexed tracking MPC, as one kernel: one
thread block per solve.

The solve is :func:`tpl_tpu_torch.optim.ilqr.make_update_fn` of
:func:`~tpl_tpu_torch.optim.problems.trajectory_tracking_mpc_time` (nx=6,
nu=2, nc=4) in float64: the initial rollout and its cost, then
``max_lg_iterations`` multiplier updates, each followed by up to
``max_iterations`` iLQR iterations (derivatives, Riccati backward pass, 8
line-search rollouts, mu schedule).  The JAX package compiled the same
program with XLA for the host CPU (``tpl_tpu/optim/ilqr.py:126``
make_update_fn, pinned to the CPU by ``tpl_tpu/control/tracking_mpc.py:120``);
it has no Pallas kernel.

:func:`update` takes the packed input tensor of :func:`pack_inputs` and
returns the packed result (:func:`unpack_outputs`).  On a CUDA tensor it
launches the hand-written kernel ``csrc/ilqr_tracking_mpc_time.cu`` (one
launch per update, counted in ``launches``); on a CPU tensor it runs the
plain version :func:`update_reference`, which is the plain
``make_update_fn``.  :func:`profile` runs the kernel's profiling
instantiation (the same bits, and cycles by phase).  :func:`bound_ms` and
:func:`chain_ms` state the kernel's two bounds from shapes and iteration
counts.
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.optim import ilqr, problems

NX, NU, NC = 6, 2, 4
# the kernel's scalar params and reference tables, in its order
# (enum Scalar / enum Table of csrc/ilqr_tracking_mpc_time.cu)
SCALARS = ("pd", "pv", "pdelta", "min_pdelta_dot", "pdelta_dot",
           "min_p_phi_dot", "p_phi_dot", "p_phi", "pa", "pj", "l", "v_ch",
           "cog_pos", "ref_dt", "ref_t_offset", "max_delta", "max_acc",
           "min_acc", "a_offset")
TABLES = ("ref_x", "ref_y", "ref_phi", "ref_v")

launches = 0          # kernel launches (reset freely)

# Operation counts of one step of the algorithm, as the plain version
# defines it (an add, multiply, divide, compare or transcendental counts as
# one): the four reference lookups of a step (its time, the query, the
# clamped indices and three lerps, the clamped angle lerp with its mod),
# the dynamics (tan, the slip angle's atan, the yaw rate, the sine and
# cosine of the course angle), the augmented step cost (eight weighted
# terms, the yaw rate again, four constraints with their multiplier and
# penalty terms), one closed-loop HEUN rollout step (2 x 6 feedback
# products with the clamp, two dynamics evaluations, the combination), one
# Riccati step (56 + 52 dot products of 6, the nu = 2 solve, the gains and
# the value update), the derivatives of one step and the multiplier update.
#
# The derivatives are counted as what the function needs: one pass over the
# step cost and one over the dynamics, whose intermediate values every
# entry shares, and one operation for each entry of the step's block that
# is neither structurally zero nor a constant:
# - the cost's gradient, 8: every variable of (x, u) appears in it;
# - its Hessian's upper triangle, 10: the squares of px, py, phi, delta, v,
#   a, j and delta_dot, and (delta, v), (v, delta_dot);
# - the dynamics' Jacobian, 8: the course-angle rows by phi, delta and v,
#   the yaw rate by delta and v; the rows of delta, v, a are the constants
#   0, 1 and dt.
DERIV_ENTRIES = dict(gradient=8, hessian=10, jacobian=8)
OPS = dict(lookups=30, dynamics=18, step_cost=77, rollout_step=109,
           riccati_step=1740,
           derivatives=77 + 18 + sum(DERIV_ENTRIES.values()), multipliers=20)
# The critical path of one step (dependent operations, by the probe's
# names).  Riccati: A = fx^T Vxx (a dot of 6), Qxx = lxx + A fx, the nu = 2
# solve (a + mu, the determinant, one division, the inverse's entry, the
# gain), K^T Quu K and the last sum.  Rollout (HEUN): the feedback dot of 6
# and its two sums, then the dynamics' longest chain once (tan, the slip
# angle's product and atan, its cosine, the yaw rate's product and
# division) and the combinations.  Once: the slip angle and yaw rate of a
# HEUN step's two evaluations depend on (delta, v) alone, and the second
# evaluation's (delta, v) is known as soon as the step's control is, so no
# design need wait for the first evaluation's chain before the second's;
# both course angles are known then too, and their sines and cosines are
# off the longest chain.
CHAIN_RICCATI = dict(f64_mul=6, f64_add=17, f64_div=1)
CHAIN_DYNAMICS = dict(f64_tan=1, f64_atan=1, f64_cos=1, f64_mul=2,
                      f64_div=1)
CHAIN_ROLLOUT_EXTRA = dict(f64_mul=3, f64_add=10)   # feedback, combinations

_MAX_SMEM = 227 * 1024      # dynamic shared memory a block can use (H100)


def input_layout(H, n_ref):
    """(name, shape) of every input, in packed order."""
    return [("x", (H + 1, NX)), ("u", (H, NU)), ("lam", (H, NC)),
            ("u_lims", (H, NU, 2)), ("bw_lim", (NC, 2)), ("cfg_f", (2,)),
            ("alphas", (len(ilqr.ALPHAS),)), ("scalars", (len(SCALARS),)),
            ("tables", (len(TABLES), n_ref))]


def pack_inputs(inputs, params):
    """One float64 host buffer from the solver inputs (name -> array: x,
    u, lam, u_lims, bw_lim, cfg_f) and the params (name -> value).  Params
    are looked up by name."""
    H = inputs["u"].shape[0]
    n_ref = len(params[TABLES[0]])
    arrays = dict(inputs, alphas=ilqr.ALPHAS,
                  scalars=[params[n] for n in SCALARS],
                  tables=np.stack([params[n] for n in TABLES]))
    return np.concatenate([np.asarray(arrays[name], np.float64).reshape(-1)
                           for name, shape in input_layout(H, n_ref)])


def output_layout(H):
    """(name, shape) of the packed result; ``tail`` is (mu_step,
    traj_costs, iterations)."""
    return [("x", (H + 1, NX)), ("u", (H, NU)), ("lam", (H, NC)),
            ("tail", (3,))]


def unpack_outputs(out, H):
    """Dict of x (H+1, 6), u (H, 2), lam (H, 4), mu_step, traj_costs and
    iterations from a packed result (numpy or tensor)."""
    v = ilqr.unpack(out, ilqr.layout(output_layout(H))[0])
    mu_step, traj_costs, iterations = (float(a) for a in v.pop("tail"))
    return dict(v, mu_step=int(mu_step), traj_costs=traj_costs,
                iterations=int(iterations))


def _check(buf, H, n_ref, mu_step, integrator):
    _, n = ilqr.layout(input_layout(H, n_ref))
    if buf.dtype != torch.float64 or buf.dim() != 1 or buf.numel() != n:
        raise ValueError(f"packed input must be a float64 vector of {n}, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("packed input must be contiguous")
    if integrator not in (ilqr.EULER, ilqr.HEUN, ilqr.RK4):
        raise ValueError(f"unknown integrator {integrator}")
    if not 0 <= mu_step <= 7:
        raise ValueError(f"mu_step {mu_step} outside the schedule's 0..7")


def update(buf, H, n_ref, T, max_iterations, max_lg_iterations, mu_step,
           integrator=ilqr.HEUN):
    """One update from the packed inputs ``buf`` (float64, on the solve's
    device); returns the packed result on the same device."""
    _check(buf, H, n_ref, mu_step, integrator)
    if buf.device.type == "cpu":
        return update_reference(buf, H, n_ref, T, max_iterations,
                                max_lg_iterations, mu_step, integrator)
    return launch(buf, H, n_ref, T, max_iterations, max_lg_iterations,
                  mu_step, integrator)


def profile(buf, H, n_ref, T, max_iterations, max_lg_iterations, mu_step,
            integrator=ilqr.HEUN):
    """:func:`update` through the kernel's profiling instantiation (CUDA
    only): returns the packed result, bit-equal to :func:`update`'s, and
    thread 0's cycles per phase, a dict over ``ilqr.PHASES`` (sums over the
    solve)."""
    _check(buf, H, n_ref, mu_step, integrator)
    cycles = torch.zeros(len(ilqr.PHASES), dtype=torch.int64,
                         device=buf.device)
    out = launch(buf, H, n_ref, T, max_iterations, max_lg_iterations,
                 mu_step, integrator, cycles)
    return out, dict(zip(ilqr.PHASES, cycles.cpu().tolist()))


def launch(buf, H, n_ref, T, max_iterations, max_lg_iterations, mu_step,
           integrator=ilqr.HEUN, cycles=None):
    """Launches the kernel (its profiling instantiation when ``cycles``, an
    int64 tensor of ``len(ilqr.PHASES)``, is given) on the checked CUDA
    tensor ``buf``; returns the packed result.  Raises on any other device
    and on a failed launch."""
    global launches
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"ilqr_tracking_mpc_time: unsupported device {dev}")
    lib = _kernel()
    smem = lib.ilqr_tracking_mpc_time_smem_bytes(H, n_ref)
    if smem > _MAX_SMEM:
        raise ValueError(f"horizon {H} with {n_ref} reference samples needs "
                         f"{smem} B of shared memory, above {_MAX_SMEM}")
    out = torch.empty(ilqr.layout(output_layout(H))[1], dtype=torch.float64,
                      device=dev)
    run = (H, n_ref, T, max_iterations, max_lg_iterations, mu_step,
           integrator)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cycles is None:
            err = lib.ilqr_tracking_mpc_time(buf.data_ptr(), out.data_ptr(),
                                             *run, stream)
        else:
            err = lib.ilqr_tracking_mpc_time_profile(
                buf.data_ptr(), out.data_ptr(), cycles.data_ptr(), *run,
                stream)
    if err != 0:
        raise RuntimeError(f"ilqr_tracking_mpc_time launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def traffic_bytes(H, n_ref):
    """Bytes one update must move: the packed input read once and the
    packed result written once."""
    return 8 * (ilqr.layout(input_layout(H, n_ref))[1]
                + ilqr.layout(output_layout(H))[1])


def operations(H, T, iterations, max_lg_iterations=1, integrator=ilqr.HEUN,
               rolled=None):
    """Operations of one update that ran ``iterations`` iLQR iterations in
    all (the result's count): the reference lookups, the initial rollout and
    its cost, the multiplier updates, and per iteration the derivatives and
    the Riccati pass; ``rolled`` line-search candidates in all, each a
    rollout, its step costs and its ordered sum (default: all 8 every
    iteration)."""
    if integrator != ilqr.HEUN:
        raise ValueError("operation counts are stated for HEUN")
    n = min(T, H)
    if rolled is None:
        rolled = len(ilqr.ALPHAS) * iterations
    open_loop = 2 * OPS["dynamics"] + 31        # no feedback, no clamp
    init = n * (OPS["lookups"] + open_loop + OPS["step_cost"] + 1)
    per_it = n * (OPS["derivatives"] + OPS["riccati_step"])
    per_candidate = n * (OPS["rollout_step"] + OPS["step_cost"] + 1)
    return (init + max_lg_iterations * n * OPS["multipliers"]
            + iterations * per_it + rolled * per_candidate)


def bound_ms(H, n_ref, T, iterations, max_lg_iterations=1):
    """(ms, "bytes" or "operations"): the roofline bound of one update."""
    return _latency.roofline_ms(
        traffic_bytes(H, n_ref),
        operations(H, T, iterations, max_lg_iterations), "float64")


def chain_ops(H, T, iterations):
    """Dependent operations on the critical path of one update: the initial
    rollout and its ordered cost sum, then per iteration T Riccati steps,
    then T rollout steps of one candidate (the candidates roll side by side)
    and its ordered cost sum."""
    n = min(T, H)
    total = {}
    add = lambda ops, times: _latency.add_ops(total, ops, times)
    add(CHAIN_DYNAMICS, n * (1 + iterations))
    add(CHAIN_ROLLOUT_EXTRA, n * iterations)
    add(dict(f64_mul=2, f64_add=3), n)          # the initial rollout's sums
    add(CHAIN_RICCATI, n * iterations)
    add(dict(f64_add=1), n * (1 + iterations))  # the ordered cost sums
    return total


def chain_ms(H, T, iterations, cycles, sm_mhz):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(H, T, iterations), cycles, sm_mhz)


_PLAIN = {}


def update_reference(buf, H, n_ref, T, max_iterations, max_lg_iterations,
                     mu_step, integrator=ilqr.HEUN):
    """The plain PyTorch update (``make_update_fn``) on the device of
    ``buf``, with the packed inputs and result of :func:`update`."""
    key = (H, n_ref, integrator)
    if key not in _PLAIN:
        prob, _ = problems.trajectory_tracking_mpc_time(ref_capacity=n_ref)
        _PLAIN[key] = ilqr.make_update_fn(prob, H, integrator,
                                          dtype=torch.float64)
    v = ilqr.unpack(buf, ilqr.layout(input_layout(H, n_ref))[0])
    params = {n: v["scalars"][i] for i, n in enumerate(SCALARS)}
    params.update({n: v["tables"][i] for i, n in enumerate(TABLES)})
    cfg = ilqr.packed_cfg(v["u_lims"], v["bw_lim"], v["cfg_f"], T,
                          max_iterations, max_lg_iterations)
    state = ilqr.SolverState(v["x"], v["u"], v["lam"], mu_step)
    new, info = _PLAIN[key](state, v["x"][0], params, cfg)
    count = lambda n: torch.full((1,), float(n), dtype=torch.float64,
                                 device=buf.device)
    return torch.cat([new.x.reshape(-1), new.u.reshape(-1),
                      new.lam.reshape(-1), count(new.mu_step),
                      info["traj_costs"].reshape(1),
                      count(info["iterations"])])


def solve(inputs, params, T, max_iterations, max_lg_iterations, mu_step,
          integrator, device):
    """One :class:`~tpl_tpu_torch.optim.solver.Solver` update: pack the
    inputs and params (names -> host arrays), one upload to ``device``,
    :func:`update`, one download; returns :func:`unpack_outputs`."""
    H = inputs["u"].shape[0]
    buf = torch.from_numpy(pack_inputs(inputs, params)).to(device)
    out = update(buf, H, len(params[TABLES[0]]), T, max_iterations,
                 max_lg_iterations, mu_step, integrator)
    return unpack_outputs(out.cpu().numpy(), H)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library, and load its code
    onto the current device with the shared-memory limit set, so that the
    first update does not pay for either."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("ilqr_tracking_mpc_time")
        lib.ilqr_tracking_mpc_time.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_time.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_time_profile.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_time_profile.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_time_smem_bytes.restype = ctypes.c_size_t
        lib.ilqr_tracking_mpc_time_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.ilqr_tracking_mpc_time_prepare.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_time_prepare.argtypes = []
        _build.prepare(lib, "ilqr_tracking_mpc_time")
        _LIB = lib
    return _LIB
