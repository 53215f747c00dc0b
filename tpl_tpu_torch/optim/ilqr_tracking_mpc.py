"""
One full AL-iLQR update of the spatial-progress tracking MPC, as one kernel:
one thread block per solve, and for a batch a persistent kernel with a warp
per scenario.

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
package's ``tpl_tpu/optim/batched.py:30``) is the kernel's batched entry,
float64 or float32: :func:`pack_inputs_batched` packs the part every
scenario shares once and a row per scenario (:func:`batched_layout`) with
vectorised tensor operations on the device, :func:`launch_batched` is the
bare launcher (one launch per batch, counted in ``launches_batched``),
:func:`update_batched` the wrapper the batched update calls.  A warp solves
scenario after scenario, taken from an atomic counter; the line search
stops at the first improving candidate, which is the plain version's pick.
A batch small enough that every scenario can have a block of its own at
once (:func:`team_scenarios`) takes the team geometry instead: a block of
warps a scenario, the derivatives spread over its warps and every
candidate rolled in one round, with the same bits.
Scenario b of a float64 batch returns the bits of a single launch on
:func:`rows_of_batch`'s row b.  :func:`resident_scenarios` is the
occupancy calculator's answer for the batch's geometry,
:func:`bound_ms_batched` the batch's bound whatever the design and
:func:`floor_ms_batched` the least time of this design.
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
# candidates the batched kernel's line search rolls side by side, by
# precision (NG of the body)
SIDE_BY_SIDE = {torch.float64: 2, torch.float32: 4}


def batch_phases(dtype=torch.float64):
    """The batched kernel's profiling phases (enum BatchPhase of the body),
    scenario 0's cycles per phase over its solve: "candidates_a_b" is
    candidates a .. b rolled side by side with their step costs and sums."""
    ng = SIDE_BY_SIDE[dtype]
    return (("load", "init_rollout", "multipliers", "derivatives",
             "expansion", "riccati")
            + tuple(f"candidates_{c}_{c + ng - 1}"
                    for c in range(0, len(ilqr.ALPHAS), ng))
            + ("pick_copy", "store"))


def batched_layout(H, n_ref):
    """``(shared, row)``: the (name, shape) of the batch's shared part,
    packed once for every scenario, and of one scenario's row, each in
    packed order."""
    return ([("u_lims", (H, NU, 2)), ("bw_lim", (NC, 2)), ("cfg_f", (2,)),
             ("alphas", (len(ilqr.ALPHAS),)),
             ("tables", (len(TABLES), n_ref))],
            [("x0", (NX,)), ("u", (H, NU)), ("lam", (H, NC)),
             ("scalars", (len(SCALARS),))])


def pack_inputs_batched(x, u, lam, x0, params, cfg, dtype=torch.float64):
    """``(shared, rows)`` of a batch on the device of ``x``: the shared part
    ``(n_shared,)`` and the ``(B, n_row)`` rows of :func:`batched_layout`.
    ``x``, ``u``, ``lam``, ``x0`` carry the batch last
    (``tpl_tpu_torch.optim.batched``); a param is a scalar or table shared
    across the batch, or a ``(B,)`` scalar per scenario; ``cfg`` is the
    batched update's.  Packed with tensor operations, no loop over the
    scenarios."""
    dev, B, H = x.device, x.shape[-1], u.shape[0]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    tabs = [t(params[n]) for n in TABLES]
    n_ref = tabs[0].shape[-1]
    if any(tuple(a.shape) != (n_ref,) for a in tabs):
        raise ValueError("the reference tables are shared across the batch: "
                         f"expected {len(TABLES)} of ({n_ref},), got "
                         f"{[tuple(a.shape) for a in tabs]}")
    tables = torch.stack(tabs)
    shared = dict(
        u_lims=torch.stack([t(cfg["u_min"]), t(cfg["u_max"])], -1),
        bw_lim=torch.stack([t(cfg["barrier_weight"]),
                            t(cfg["lg_mult_limit"])], -1),
        cfg_f=torch.stack([t(cfg["dt"]).reshape(()),
                           t(cfg["min_rel_cost_change"]).reshape(())]),
        alphas=t(ilqr.ALPHAS), tables=tables)
    rows = dict(x0=t(x0).T, u=t(u).movedim(-1, 0), lam=t(lam).movedim(-1, 0),
                scalars=torch.stack([t(params[n]).expand(B)
                                     for n in SCALARS], 1))
    shared_layout, row_layout = batched_layout(H, n_ref)
    for name, shape in shared_layout:
        if tuple(shared[name].shape) != shape:
            raise ValueError(f"{name} is shared across the batch: expected "
                             f"{shape}, got {tuple(shared[name].shape)}")
    for name, shape in row_layout:
        if tuple(rows[name].shape) != (B,) + shape:
            raise ValueError(f"{name} must be {(B,) + shape} batch first, "
                             f"got {tuple(rows[name].shape)}")
    return (torch.cat([shared[n].reshape(-1) for n, _ in shared_layout]),
            torch.cat([rows[n].reshape(B, -1) for n, _ in row_layout], 1))


def rows_of_batch(shared, rows, H, n_ref):
    """The ``(B, n_in)`` inputs of single solves (:func:`pack_inputs`'
    layout), a row per scenario, from a batch's ``(shared, rows)``: what a
    single launch on scenario b takes (x beyond its start is zero; the solve
    overwrites it)."""
    B = rows.shape[0]
    shared_layout, row_layout = batched_layout(H, n_ref)
    sh = ilqr.unpack(shared, ilqr.layout(shared_layout)[0])
    offs, _ = ilqr.layout(row_layout)
    rw = {name: rows[:, off:off + int(np.prod(shape))]
          for name, (off, shape) in offs.items()}
    x = torch.zeros((B, (H + 1) * NX), dtype=rows.dtype, device=rows.device)
    x[:, :NX] = rw["x0"]
    parts = dict(x=x, u=rw["u"], lam=rw["lam"], scalars=rw["scalars"],
                 **{k: v.reshape(1, -1).expand(B, -1) for k, v in sh.items()})
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


def _check_batched(shared, rows, mu_steps, H, n_ref, integrator):
    """Raises unless ``shared``, ``rows`` and ``mu_steps`` are what the
    batched kernel takes: one CUDA device, float64 or float32, contiguous,
    the shapes of :func:`batched_layout`, int32 mu_steps."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the batched kernel runs on CUDA tensors, got {dev}")
    if rows.dtype not in DTYPES:
        raise NotImplementedError(f"no batched kernel for {rows.dtype}")
    shared_layout, row_layout = batched_layout(H, n_ref)
    n_sh, n_row = (ilqr.layout(lay)[1] for lay in (shared_layout, row_layout))
    if rows.dim() != 2 or rows.shape[1] != n_row or not rows.is_contiguous():
        raise ValueError(f"the rows must be a contiguous (B, {n_row}) "
                         f"tensor, got {tuple(rows.shape)}")
    if (tuple(shared.shape) != (n_sh,) or shared.dtype != rows.dtype
            or shared.device != dev or not shared.is_contiguous()):
        raise ValueError(f"the shared part must be a contiguous ({n_sh},) "
                         f"{rows.dtype} tensor on {dev}, got {shared.dtype} "
                         f"{tuple(shared.shape)} on {shared.device}")
    B = rows.shape[0]
    if (mu_steps.dtype != torch.int32 or tuple(mu_steps.shape) != (B,)
            or mu_steps.device != dev or not mu_steps.is_contiguous()):
        raise ValueError(f"mu_steps must be a contiguous int32 ({B},) tensor "
                         f"on {dev}")
    if integrator not in (ilqr.EULER, ilqr.HEUN, ilqr.RK4):
        raise ValueError(f"unknown integrator {integrator}")


def launch_batched(shared, rows, mu_steps, H, n_ref, T, max_iterations,
                   max_lg_iterations=1, integrator=ilqr.HEUN, cycles=None):
    """The bare launcher of the batched kernel: ``shared`` ``(n_shared,)``
    and ``rows`` ``(B, n_row)``, float64 or float32, and ``mu_steps``
    ``(B,)`` int32 on one CUDA device; one launch, returns the ``(B,
    n_out)`` packed results.  With ``cycles``, an int64 tensor of
    ``len(batch_phases(dtype)) + 8``, the profiling instantiation runs and
    fills it (:func:`profile_batched`)."""
    global launches_batched
    _check_batched(shared, rows, mu_steps, H, n_ref, integrator)
    dev, B = rows.device, rows.shape[0]
    lib, f32 = _kernel(), DTYPES[rows.dtype]
    out = torch.empty((B, ilqr.layout(output_layout(H))[1]), dtype=rows.dtype,
                      device=dev)
    work = torch.empty(1, dtype=torch.int32, device=dev)
    run = (B, H, n_ref, int(T), int(max_iterations), int(max_lg_iterations),
           integrator, f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (shared.data_ptr(), rows.data_ptr(), out.data_ptr(),
                mu_steps.data_ptr(), work.data_ptr())
        if cycles is None:
            err = lib.ilqr_tracking_mpc_batched(*ptrs, *run, stream)
        else:
            err = lib.ilqr_tracking_mpc_batched_profile(
                *ptrs, cycles.data_ptr(), *run, stream)
    if err != 0:
        raise RuntimeError(f"ilqr_tracking_mpc_batched launch failed: CUDA "
                           f"error {err}")
    launches_batched += 1
    return out


def profile_batched(shared, rows, mu_steps, H, n_ref, T, max_iterations,
                    max_lg_iterations=1, integrator=ilqr.HEUN):
    """:func:`launch_batched` through the profiling instantiation: returns
    the packed results (bit-equal), scenario 0's cycles per phase (a dict
    over :func:`batch_phases`, sums over its solve) and the histogram of the
    batch's line searches by candidates rolled (entry k: k + 1 rolled)."""
    names = batch_phases(rows.dtype)
    n = len(names)
    cycles = torch.zeros(n + len(ilqr.ALPHAS), dtype=torch.int64,
                         device=rows.device)
    out = launch_batched(shared, rows, mu_steps, H, n_ref, T, max_iterations,
                         max_lg_iterations, integrator, cycles)
    c = cycles.cpu().tolist()
    return out, dict(zip(names, c[:n])), c[n:]


def update_batched(x, u, lam, mu_step, x0, params, cfg, integrator=ilqr.HEUN,
                   dtype=torch.float64):
    """The batched update of ``tpl_tpu_torch.optim.batched`` on CUDA
    tensors: pack, one launch, unpack.  Returns ``(xs, u, lam, mu_step,
    traj_costs, iterations)``, the batch last."""
    H = u.shape[0]
    shared, rows = pack_inputs_batched(x, u, lam, x0, params, cfg, dtype)
    n_ref = len(params[TABLES[0]])
    mu = mu_step.to(torch.int32).clamp(0, 7).contiguous()
    out = launch_batched(shared, rows, mu, H, n_ref, int(cfg["T"]),
                         int(cfg["max_iterations"]),
                         int(cfg.get("max_lg_iterations", 1)), integrator)
    return unpack_outputs_batched(out, H, mu_step.dtype)


def resident_scenarios(H, n_ref, dtype=torch.float64):
    """``(scenarios, slots)``: the scenarios of the batched kernel one SM
    holds at a time and the slots (scenarios) of its block, the occupancy
    calculator's answer on the current CUDA device."""
    slots = ctypes.c_int(0)
    n = _kernel().ilqr_tracking_mpc_batched_resident(
        H, n_ref, DTYPES[dtype], ctypes.byref(slots))
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n, slots.value


def team_scenarios(H, n_ref, dtype=torch.float64):
    """Scenarios one SM holds at a time in the team geometry (a block of
    ``8 / SIDE_BY_SIDE[dtype]`` warps a scenario), the occupancy
    calculator's answer on the current CUDA device; a batch of at most this
    many per SM takes that geometry, a larger one a warp a scenario."""
    n = _kernel().ilqr_tracking_mpc_batched_team(H, n_ref, DTYPES[dtype])
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def batched_bytes(H, n_ref, dtype=torch.float64):
    """``(shared, slot)``: the bytes of shared memory a block of the batched
    kernel gives the part every scenario shares (with the angle distances)
    and each scenario's slot."""
    lib = _kernel()
    return tuple(lib.ilqr_tracking_mpc_batched_bytes(H, n_ref, DTYPES[dtype],
                                                     what) for what in (0, 1))


def traffic_bytes(H, n_ref):
    """Bytes one update must move: the packed input read once and the
    packed result written once."""
    return 8 * (ilqr.layout(input_layout(H, n_ref))[1]
                + ilqr.layout(output_layout(H))[1])


def traffic_bytes_batched(B, H, n_ref, itemsize=8):
    """Bytes a batch of B must move: the shared part once, each scenario's
    row and its packed result once, ``itemsize`` bytes a real."""
    shared_layout, row_layout = batched_layout(H, n_ref)
    return itemsize * (ilqr.layout(shared_layout)[1]
                       + B * (ilqr.layout(row_layout)[1]
                              + ilqr.layout(output_layout(H))[1]))


def operations(H, T, iterations, max_lg_iterations=1, integrator=ilqr.HEUN,
               rolled=None):
    """Operations of one update that ran ``iterations`` iLQR iterations in
    all (the result's count): the initial rollout and its cost, the
    multiplier updates, and per iteration the derivatives and the Riccati
    pass; ``rolled`` line-search candidates in all, each a rollout, its step
    costs and its ordered sum (default: all 8 every iteration)."""
    if integrator != ilqr.HEUN:
        raise ValueError("operation counts are stated for HEUN")
    n = min(T, H)
    if rolled is None:
        rolled = len(ilqr.ALPHAS) * iterations
    open_loop = 2 * OPS["dynamics"] + 35        # no feedback, no clamp
    init = n * (open_loop + OPS["step_cost"] + 1)
    per_it = n * (OPS["derivatives"] + OPS["riccati_step"])
    per_candidate = n * (OPS["rollout_step"] + OPS["step_cost"] + 1)
    return (init + max_lg_iterations * n * OPS["multipliers"]
            + iterations * per_it + rolled * per_candidate)


def bound_ms(H, n_ref, T, iterations, max_lg_iterations=1):
    """(ms, "bytes" or "operations"): the roofline bound of one update."""
    return _latency.roofline_ms(
        traffic_bytes(H, n_ref),
        operations(H, T, iterations, max_lg_iterations), "float64")


def roofline_ms_batched(H, n_ref, T, iterations, rolled,
                        dtype=torch.float64):
    """(ms, "bytes" or "operations"): the roofline of a batch whose
    scenarios ran ``iterations`` and rolled ``rolled`` candidates (one count
    each per scenario): the bytes of :func:`traffic_bytes_batched` and the
    operations each scenario's own counts need, at the peak of ``dtype``."""
    size = torch.empty((), dtype=dtype).element_size()
    n_ops = sum(operations(H, T, int(it), rolled=int(r))
                for it, r in zip(iterations, rolled))
    return _latency.roofline_ms(
        traffic_bytes_batched(len(iterations), H, n_ref, size), n_ops,
        str(dtype).replace("torch.", ""))


def bound_ms_batched(H, n_ref, T, iterations, rolled, cycles, sm_mhz,
                     dtype=torch.float64):
    """(ms, "bytes", "operations" or "chain"): the least time of a batch
    whatever the design: the larger of its roofline
    (:func:`roofline_ms_batched`) and the dependent chain of its longest
    scenario at its own iteration count (:func:`chain_ms` in ``dtype``, one
    rollout an iteration)."""
    roof = roofline_ms_batched(H, n_ref, T, iterations, rolled, dtype)
    chain = chain_ms(H, T, int(max(iterations)), cycles, sm_mhz, dtype=dtype)
    return roof if roof[0] >= chain else (chain, "chain")


def floor_ms_batched(chains_ms, sms, per_sm):
    """The least time of the warp-per-scenario design: ``sms * per_sm``
    warps take the scenarios in turn, each at least its own dependent chain
    with its line searches' rounds rolled one after the other
    (``chains_ms``, one a scenario: :func:`chain_ms` with ``rolled`` the
    rounds of its searches), so the batch takes at least the longest chain
    and the chains' sum over the warps."""
    return max(max(chains_ms), sum(chains_ms) / (sms * per_sm))


def chain_ops(H, T, iterations, rolled=None, dtype=torch.float64):
    """Dependent operations on the critical path of one update in
    ``dtype``: the initial rollout and its ordered cost sum, then per
    iteration T Riccati steps, and T rollout steps and the ordered cost sum
    of each of ``rolled`` rollouts in all, one after the other (default:
    one an iteration, the candidates side by side).  Float32 prices every
    operation at its ``f32_*`` probe."""
    n = min(T, H)
    if rolled is None:
        rolled = iterations
    dyn2 = {k: 2 * v for k, v in CHAIN_DYNAMICS.items()}
    total = {}
    add = lambda ops, times: _latency.add_ops(total, ops, times)
    add(dyn2, n * (1 + rolled))
    add(CHAIN_ROLLOUT_EXTRA, n * rolled)
    add(dict(f64_mul=2, f64_add=3), n)          # the initial rollout's sums
    add(CHAIN_RICCATI, n * iterations)
    add(dict(f64_add=1), n * (1 + rolled))      # the ordered cost sums
    if dtype == torch.float32:
        total = {k.replace("f64_", "f32_"): v for k, v in total.items()}
    elif dtype != torch.float64:
        raise ValueError(f"no chain for {dtype}")
    return total


def chain_ms(H, T, iterations, cycles, sm_mhz, rolled=None,
             dtype=torch.float64):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(H, T, iterations, rolled, dtype),
                             cycles, sm_mhz)


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
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_batched_profile.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_batched_profile.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_batched_resident.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_batched_resident.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ilqr_tracking_mpc_batched_team.restype = ctypes.c_int
        lib.ilqr_tracking_mpc_batched_team.argtypes = [ctypes.c_int] * 3
        lib.ilqr_tracking_mpc_batched_bytes.restype = ctypes.c_size_t
        lib.ilqr_tracking_mpc_batched_bytes.argtypes = [ctypes.c_int] * 4
        _LIB = lib
    return _LIB
