"""
One full AL-iLQR update of the spatial-progress tracking MPC, as one kernel:
one thread block per solve, a grid of B blocks for a batch of B scenarios.

The solve is :func:`tpl_tpu_torch.optim.ilqr.make_update_fn` of
:func:`~tpl_tpu_torch.optim.problems.trajectory_tracking_mpc` in float64:
the initial rollout and its cost, then ``max_lg_iterations`` multiplier
updates, each followed by up to ``max_iterations`` iLQR iterations
(derivatives, Riccati backward pass, 8 line-search rollouts, mu schedule).
The JAX package compiled the same program with XLA for the host CPU
(``tpl_tpu/optim/ilqr.py:126`` make_update_fn, pinned to the CPU by
``tpl_tpu/control/tracking_mpc.py:119-120``); it has no Pallas kernel.

:func:`update` takes the packed input tensor of :func:`pack_inputs` and
returns the packed result (:func:`unpack_outputs`).  On a CUDA tensor it
launches the hand-written kernel ``csrc/ilqr_tracking_mpc.cu`` (one launch
per update, counted in ``launches``); on a CPU tensor it runs the plain
version :func:`update_reference`, which is the plain ``make_update_fn``.
:func:`profile` launches the kernel's profiling instantiation (the same
bits, and cycles per phase).  :func:`bound_ms` and :func:`chain_ms` state
the kernel's two bounds from shapes and iteration counts.

The batch (``tpl_tpu_torch.optim.batched`` on CUDA tensors; the JAX
package's ``tpl_tpu/optim/batched.py:30``) is the same kernel body on a grid
of B blocks, float64 or float32: :func:`pack_inputs_batched` lays B packed
inputs one after the other with vectorised tensor operations on the device,
:func:`launch_batched` is the bare launcher (one launch per batch, counted
in ``launches_batched``), :func:`update_batched` the wrapper the batched
update calls.  Block b of a float64 batch returns the bits of a single
launch on scenario b's inputs.  :func:`bound_ms_batched` and
:func:`floor_ms_batched` state the batch's roofline bound and the least
time of this design (waves of blocks, each a solve's dependent chain).
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.optim import ilqr, problems

NX, NU, NC = 7, 2, 4
# the kernel's scalar params and reference tables, in its order
# (enum Scalar / enum Table of csrc/ilqr_tracking_mpc.cu)
SCALARS = ("pd", "pv", "pdelta", "min_pdelta_dot", "pdelta_dot",
           "min_p_phi_dot", "p_phi_dot", "p_phi", "p_phi_ref_dot_diff",
           "pa", "pj", "l", "v_ch", "ref_step", "max_delta", "max_acc",
           "min_acc", "a_offset")
TABLES = ("ref_x", "ref_y", "ref_phi", "ref_k", "ref_v")

launches = 0          # single-solve kernel launches (reset freely)
launches_batched = 0  # batched kernel launches, one per batch

# Operation counts of one step of the algorithm, as the plain version
# defines it (an add, multiply, divide, compare or transcendental counts as
# one): the dynamics with their table lookups, the augmented step cost, one
# closed-loop HEUN rollout step (2 x 7 feedback products, two dynamics
# evaluations, the combination), one Riccati step (72 + 67 dot products of
# 7, the nu = 2 solve, the value update), the derivatives of one step and the
# multiplier update.
#
# The derivatives are counted as what the function needs, not as what a
# way of forming them executes: one pass over the step cost, whose
# intermediate values (the lookups, the sines and cosines, d_r, s_dot, the
# yaw rate) every entry shares with it and with the dynamics, and one
# operation for each entry of the step's block that is neither structurally
# zero nor a constant:
# - the cost's gradient, 9: every variable of (x, u) appears in it;
# - its Hessian's upper triangle, 25: the 21 pairs over (px, py, phi, delta,
#   v, s_r), which the yaw-rate-difference term couples, and (a, a), (j, j),
#   (v, delta_dot), (delta_dot, delta_dot); the lower triangle is a copy;
# - the dynamics' Jacobian, 11: d(v cos phi), d(v sin phi) and the yaw rate
#   by two variables each, s_dot by (px, py, phi, v, s_r); the rows of
#   delta, v, a are the constants 0, 1 and dt.
# Forward-mode numbers execute more than this even with every structural
# zero left out, so the count is below any implementation's.
DERIV_ENTRIES = dict(gradient=9, hessian=25, jacobian=11)
OPS = dict(dynamics=58, step_cost=119, rollout_step=203, riccati_step=2520,
           derivatives=119 + sum(DERIV_ENTRIES.values()), multipliers=20)
# The critical path of one step (dependent operations, by the probe's
# names).  Riccati: A = fx^T Vxx (a dot of 7), Qxx = lxx + A fx, the nu = 2
# solve (a + mu, the determinant, one division, the inverse's entry, the
# gain), K^T Quu K and the last sum.  Rollout (HEUN): the feedback dot of 7
# and its two sums, then twice the dynamics' longest chain (the query's
# division, floor and alpha, a table load, the angle distance with its mod,
# the lerp, a cosine, d_r, the denominator, the division of s_dot) and the
# two combinations.
CHAIN_RICCATI = dict(f64_mul=7, f64_add=19, f64_div=1)
CHAIN_DYNAMICS = dict(f64_div=2, f64_fmod=1, f64_add=8, f64_mul=3, f64_cos=1,
                      smem_load=1)
CHAIN_ROLLOUT_EXTRA = dict(f64_mul=3, f64_add=11)   # feedback, combinations

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
    """Dict of x (H+1, 7), u (H, 2), lam (H, 4), mu_step, traj_costs and
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
    return _launch(buf, H, n_ref, T, max_iterations, max_lg_iterations,
                   mu_step, integrator, None)


def profile(buf, H, n_ref, T, max_iterations, max_lg_iterations, mu_step,
            integrator=ilqr.HEUN):
    """:func:`update` through the kernel's profiling instantiation (CUDA
    only): returns the packed result, bit-equal to :func:`update`'s, and
    thread 0's cycles per phase, a dict over ``ilqr.PHASES`` (sums over the
    solve)."""
    _check(buf, H, n_ref, mu_step, integrator)
    cycles = torch.zeros(len(ilqr.PHASES), dtype=torch.int64,
                         device=buf.device)
    out = _launch(buf, H, n_ref, T, max_iterations, max_lg_iterations,
                  mu_step, integrator, cycles)
    return out, dict(zip(ilqr.PHASES, cycles.cpu().tolist()))


def _launch(buf, H, n_ref, T, max_iterations, max_lg_iterations, mu_step,
            integrator, cycles):
    """Launches the kernel (its profiling instantiation when ``cycles``, an
    int64 tensor of ``len(ilqr.PHASES)``, is given) on the checked CUDA
    tensor ``buf``."""
    global launches
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"ilqr_tracking_mpc: unsupported device {dev}")
    lib = _kernel()
    smem = lib.ilqr_tracking_mpc_smem_bytes(H, n_ref, 0)
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
            err = lib.ilqr_tracking_mpc(buf.data_ptr(), out.data_ptr(), *run,
                                        stream)
        else:
            err = lib.ilqr_tracking_mpc_profile(
                buf.data_ptr(), out.data_ptr(), cycles.data_ptr(), *run,
                stream)
    if err != 0:
        raise RuntimeError(f"ilqr_tracking_mpc launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


DTYPES = {torch.float64: 0, torch.float32: 1}     # the kernel's f32 flag


def pack_inputs_batched(x, u, lam, x0, params, cfg, dtype=torch.float64):
    """The ``(B, n_in)`` buffer of a batch on the device of ``x``: row b is
    scenario b's :func:`pack_inputs`.  ``x``, ``u``, ``lam``, ``x0`` carry
    the batch last (``tpl_tpu_torch.optim.batched``); a param is a scalar
    or table shared across the batch, or a ``(B,)`` scalar per scenario;
    ``cfg`` is the batched update's.  Packed with tensor operations, no
    loop over the scenarios."""
    dev, B, H = x.device, x.shape[-1], u.shape[0]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    n_ref = t(params[TABLES[0]]).shape[0]
    xs = torch.zeros((B, H + 1, NX), dtype=dtype, device=dev)
    xs[:, 0] = t(x0).T
    shared = lambda a: t(a).reshape(1, -1).expand(B, -1)
    scal = torch.stack([t(params[n]).expand(B) for n in SCALARS], 1)
    tables = torch.stack([t(params[n]) for n in TABLES])
    if tables.shape != (len(TABLES), n_ref):
        raise ValueError("the reference tables are shared across the batch: "
                         f"expected {(len(TABLES), n_ref)}, got "
                         f"{tuple(tables.shape)}")
    parts = dict(
        x=xs.reshape(B, -1), u=t(u).movedim(-1, 0).reshape(B, -1),
        lam=t(lam).movedim(-1, 0).reshape(B, -1),
        u_lims=shared(torch.stack([t(cfg["u_min"]), t(cfg["u_max"])], -1)),
        bw_lim=shared(torch.stack([t(cfg["barrier_weight"]),
                                   t(cfg["lg_mult_limit"])], -1)),
        cfg_f=shared(torch.stack([t(cfg["dt"]).reshape(()),
                                  t(cfg["min_rel_cost_change"]).reshape(())])),
        alphas=shared(ilqr.ALPHAS), scalars=scal, tables=shared(tables))
    return torch.cat([parts[name] for name, _ in input_layout(H, n_ref)], 1)


def unpack_outputs_batched(out, H, mu_dtype=torch.int32):
    """``(xs, u, lam, mu_step, traj_costs, iterations)`` of a ``(B, n_out)``
    packed result, the batch last as the batched update returns it."""
    B = out.shape[0]
    offs, _ = ilqr.layout(output_layout(H))
    v = {name: out[:, off:off + int(np.prod(shape))].reshape((B,) + shape)
         for name, (off, shape) in offs.items()}
    tail = v["tail"]
    return (v["x"].movedim(0, -1), v["u"].movedim(0, -1),
            v["lam"].movedim(0, -1), tail[:, 0].to(mu_dtype), tail[:, 1],
            tail[:, 2].to(torch.int64))


def launch_batched(buf, mu_steps, H, n_ref, T, max_iterations,
                   max_lg_iterations=1, integrator=ilqr.HEUN):
    """The bare launcher of the batched kernel: ``buf`` ``(B, n_in)``
    float64 or float32 and ``mu_steps`` ``(B,)`` int32 on one CUDA device;
    one launch of B blocks, returns the ``(B, n_out)`` packed results."""
    global launches_batched
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"the batched kernel runs on CUDA tensors, got {dev}")
    if buf.dtype not in DTYPES:
        raise NotImplementedError(f"no batched kernel for {buf.dtype}")
    _, n = ilqr.layout(input_layout(H, n_ref))
    if buf.dim() != 2 or buf.shape[1] != n or not buf.is_contiguous():
        raise ValueError(f"packed inputs must be a contiguous (B, {n}) "
                         f"tensor, got {tuple(buf.shape)}")
    B = buf.shape[0]
    if (mu_steps.dtype != torch.int32 or tuple(mu_steps.shape) != (B,)
            or mu_steps.device != dev or not mu_steps.is_contiguous()):
        raise ValueError(f"mu_steps must be a contiguous int32 ({B},) tensor "
                         f"on {dev}")
    if integrator not in (ilqr.EULER, ilqr.HEUN, ilqr.RK4):
        raise ValueError(f"unknown integrator {integrator}")
    lib, f32 = _kernel(), DTYPES[buf.dtype]
    smem = lib.ilqr_tracking_mpc_smem_bytes(H, n_ref, f32)
    if smem > _MAX_SMEM:
        raise ValueError(f"horizon {H} with {n_ref} reference samples needs "
                         f"{smem} B of shared memory, above {_MAX_SMEM}")
    out = torch.empty((B, ilqr.layout(output_layout(H))[1]), dtype=buf.dtype,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ilqr_tracking_mpc_batched(
            buf.data_ptr(), out.data_ptr(), mu_steps.data_ptr(), B, H, n_ref,
            int(T), int(max_iterations), int(max_lg_iterations), integrator,
            f32, stream)
    if err != 0:
        raise RuntimeError(f"ilqr_tracking_mpc_batched launch failed: CUDA "
                           f"error {err}")
    launches_batched += 1
    return out


def update_batched(x, u, lam, mu_step, x0, params, cfg, integrator=ilqr.HEUN,
                   dtype=torch.float64):
    """The batched update of ``tpl_tpu_torch.optim.batched`` on CUDA
    tensors: pack, one launch, unpack.  Returns ``(xs, u, lam, mu_step,
    traj_costs, iterations)``, the batch last."""
    H = u.shape[0]
    buf = pack_inputs_batched(x, u, lam, x0, params, cfg, dtype)
    n_ref = len(params[TABLES[0]])
    mu = mu_step.to(torch.int32).clamp(0, 7).contiguous()
    out = launch_batched(buf, mu, H, n_ref, int(cfg["T"]),
                         int(cfg["max_iterations"]),
                         int(cfg.get("max_lg_iterations", 1)), integrator)
    return unpack_outputs_batched(out, H, mu_step.dtype)


def blocks_per_sm(H, n_ref, dtype=torch.float64):
    """Blocks of the batched kernel one SM holds at a time (the occupancy
    calculator's answer on the current CUDA device)."""
    n = _kernel().ilqr_tracking_mpc_blocks_per_sm(H, n_ref, DTYPES[dtype])
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def smem_bytes(H, n_ref, dtype=torch.float64):
    """Dynamic shared memory of one block (one solve)."""
    return _kernel().ilqr_tracking_mpc_smem_bytes(H, n_ref, DTYPES[dtype])


def traffic_bytes(H, n_ref):
    """Bytes one update must move: the packed input read once and the
    packed result written once."""
    return 8 * (ilqr.layout(input_layout(H, n_ref))[1]
                + ilqr.layout(output_layout(H))[1])


def operations(H, T, iterations, max_lg_iterations=1, integrator=ilqr.HEUN):
    """Operations of one update that ran ``iterations`` iLQR iterations in
    all (the result's count): the initial rollout and its cost, the
    multiplier updates, and per iteration the derivatives, the Riccati pass,
    8 rollouts with their step costs and the 8 ordered sums."""
    if integrator != ilqr.HEUN:
        raise ValueError("operation counts are stated for HEUN")
    n = min(T, H)
    open_loop = 2 * OPS["dynamics"] + 35        # no feedback, no clamp
    init = n * (open_loop + OPS["step_cost"] + 1)
    per_it = n * (OPS["derivatives"] + OPS["riccati_step"]
                  + len(ilqr.ALPHAS) * (OPS["rollout_step"]
                                        + OPS["step_cost"] + 1))
    return (init + max_lg_iterations * n * OPS["multipliers"]
            + iterations * per_it)


def bound_ms(H, n_ref, T, iterations, max_lg_iterations=1):
    """(ms, "bytes" or "operations"): the roofline bound of one update."""
    return _latency.roofline_ms(
        traffic_bytes(H, n_ref),
        operations(H, T, iterations, max_lg_iterations), "float64")


def bound_ms_batched(H, n_ref, T, iterations, dtype=torch.float64):
    """(ms, "bytes" or "operations"): the roofline bound of one batch whose
    scenarios ran ``iterations`` (a sequence, one count per scenario): every
    scenario's packed input read and result written once, and the
    operations its own iteration count needs, at the peak of ``dtype``."""
    size = torch.empty((), dtype=dtype).element_size()
    n_bytes = len(iterations) * traffic_bytes(H, n_ref) // 8 * size
    n_ops = sum(operations(H, T, int(it)) for it in iterations)
    return _latency.roofline_ms(n_bytes, n_ops,
                                str(dtype).replace("torch.", ""))


def floor_ms_batched(B, sms, per_sm, solve_chain_ms):
    """The least time of the one-block-per-scenario design: the batch runs
    in ``ceil(B / (sms * per_sm))`` waves of resident blocks, and a wave
    takes at least one solve's dependent chain (``solve_chain_ms``)."""
    return -(-B // (sms * per_sm)) * solve_chain_ms


def chain_ops(H, T, iterations):
    """Dependent operations on the critical path of one update: the
    initial rollout and its ordered cost sum, then per iteration T Riccati
    steps, T rollout steps and the ordered cost sum."""
    n = min(T, H)
    dyn2 = {k: 2 * v for k, v in CHAIN_DYNAMICS.items()}
    total = {}
    add = lambda ops, times: _latency.add_ops(total, ops, times)
    add(dyn2, n * (1 + iterations))
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
        prob, _ = problems.trajectory_tracking_mpc(ref_capacity=n_ref)
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
    """Build (first call) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("ilqr_tracking_mpc")
        lib.ilqr_tracking_mpc.restype = ctypes.c_int
        lib.ilqr_tracking_mpc.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_profile.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_profile.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_smem_bytes.restype = ctypes.c_size_t
        lib.ilqr_tracking_mpc_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ilqr_tracking_mpc_batched.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_batched.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_blocks_per_sm.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        _LIB = lib
    return _LIB
