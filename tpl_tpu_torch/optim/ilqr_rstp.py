"""
One full AL-iLQR update of an RSTP profile problem, as one kernel.

The two solves of the path/velocity-decomposed planner (RSTP) are
:func:`tpl_tpu_torch.optim.ilqr.make_update_fn` of
:func:`~tpl_tpu_torch.optim.problems.lateral_profile` (nx=2, nu=1, nc=2,
with an end cost) and of
:func:`~tpl_tpu_torch.optim.problems.velocity_profile_space` (nx=2, nu=1,
nc=5), both float32 with the Euler integrator: the initial rollout and its
cost, then ``max_lg_iterations`` clipped multiplier updates, each followed
by up to ``max_iterations`` iLQR iterations.  The JAX package compiled the
same programs with XLA (``tpl_tpu/optim/ilqr.py:126`` make_update_fn,
called by ``fused_replan.py:322-327``, ``path_optim.py:321`` and
``velocity_optim.py:243``); there is no Pallas kernel for them.

:func:`update` takes the packed float32 input of :func:`pack_inputs` (or
:func:`pack_tensors`, which packs tensors already on the device) and
returns the packed result (:func:`unpack_outputs`).  ``mu_step`` travels
inside the packed input and result, so a chain of solves on the card never
reads it back.  On a CUDA tensor :func:`update` launches the hand-written
kernel ``csrc/ilqr_rstp.cu`` (one launch per update, counted in
``launches``); on a CPU tensor it runs the plain version
:func:`update_reference`, which is the plain ``make_update_fn``.
:func:`profile` launches the kernel's profiling instantiation (the same
bits, and cycles per phase).  :func:`bound_ms` and :func:`chain_ms` state
the kernel's two bounds from shapes and iteration counts.
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.optim import ilqr, problems

# per problem: the kernel's id, sizes, and its scalar params and reference
# tables in its order (struct Lateral / struct Velocity of csrc/ilqr_rstp.cu)
PROBLEMS = {
    "lateral_profile": dict(
        id=0, nx=2, nu=1, nc=2,
        scalars=("ref_step", "w_d", "w_v_d", "w_a_d", "w_k"),
        tables=("k_ref", "d_offset", "d_lower_constr", "d_upper_constr")),
    "velocity_profile_space": dict(
        id=1, nx=2, nu=1, nc=5,
        scalars=("p_v", "p_a", "max_a_total", "ref_step"),
        tables=("ref_v", "ref_k", "ref_t_max", "ref_t_min", "ref_t_offset",
                "ref_v_weight")),
}

launches = 0        # kernel launches since import (reset freely)

# Operation counts of one step of the algorithm, as the plain version
# defines it (an add, multiply, divide, compare or transcendental counts as
# one), per problem: the reference lookups at the step's arc length, the
# Euler rollout step with its feedback (lookups included, as the plain
# version makes them in every step), the augmented step cost, one Riccati
# step at nx = 2, nu = 1, and the derivatives of one step.
#
# The derivatives are counted as what the function needs, not as what a
# way of forming them executes: one pass over the step cost, whose
# intermediate values every entry shares, and one operation for each entry
# of the step's block that is neither structurally zero nor a constant (the
# gradient, the Hessian's upper triangle, the dynamics' Jacobian):
# - lateral_profile, 3 + 6 + 0: the curvature term couples (d, v_d, a_d)
#   fully; the dynamics are linear, so fx and fu are constants;
# - velocity_profile_space, 3 + 5 + 3: the Hessian has no (st, a) entry; of
#   a / v and 1 / v (the branch above v = 1) three Jacobian entries depend
#   on the state.
# The kernel's dense forward-mode numbers execute about ten passes, so the
# count is below any implementation's.
DERIV_ENTRIES = {"lateral_profile": 3 + 6 + 0,
                 "velocity_profile_space": 3 + 5 + 3}
OPS = {
    "lateral_profile": dict(
        ref=20, rollout_step=35, step_cost=58, riccati_step=113,
        derivatives=58 + DERIV_ENTRIES["lateral_profile"], multipliers=12),
    "velocity_profile_space": dict(
        ref=28, rollout_step=46, step_cost=79, riccati_step=113,
        derivatives=79 + DERIV_ENTRIES["velocity_profile_space"],
        multipliers=25),
}
# The critical path of one step (dependent operations, by the probe's
# names).  Riccati: fx^T Vxx (a dot of 2), Qxx = lxx + A fx, Quu + mu, the
# division, the gain, (K Quu) K and the last sum.  Rollout: the feedback
# dot of 2 with its two sums, the dynamics (a division in the velocity
# problem, none in the lateral one) and the Euler sum; the lookups depend
# on the step alone and are off the path.
CHAIN_RICCATI = dict(f32_mul=5, f32_add=5, f32_div=1)
CHAIN_ROLLOUT = {
    "lateral_profile": dict(f32_mul=2, f32_add=4),
    "velocity_profile_space": dict(f32_mul=2, f32_add=4, f32_div=1),
}

_MAX_SMEM = 227 * 1024      # dynamic shared memory a block can use (H100)


def _spec(name):
    try:
        return PROBLEMS[name]
    except KeyError:
        raise ValueError(f"ilqr_rstp: no kernel for problem {name!r}")


def input_layout(name, H, n_ref):
    """(name, shape) of every input, in packed order."""
    p = _spec(name)
    nx, nu, nc = p["nx"], p["nu"], p["nc"]
    return [("x", (H + 1, nx)), ("u", (H, nu)), ("lam", (H, nc)),
            ("u_lims", (H, nu, 2)), ("bw_lim", (nc, 2)), ("cfg_f", (2,)),
            ("alphas", (len(ilqr.ALPHAS),)),
            ("scalars", (len(p["scalars"]),)),
            ("tables", (len(p["tables"]), n_ref)), ("mu_step", (1,))]


def output_layout(name, H):
    """(name, shape) of the packed result; ``tail`` is (mu_step,
    traj_costs, iterations)."""
    p = _spec(name)
    return [("x", (H + 1, p["nx"])), ("u", (H, p["nu"])),
            ("lam", (H, p["nc"])), ("tail", (3,))]


def _check_mu_step(mu_step):
    if not 0 <= int(mu_step) <= 7:
        raise ValueError(f"mu_step {mu_step} outside the schedule's 0..7")


def _ordered(name, inputs, params, mu_step, alphas):
    p = _spec(name)
    return dict(inputs, alphas=alphas,
                scalars=[params[n] for n in p["scalars"]],
                tables=[params[n] for n in p["tables"]], mu_step=mu_step)


def pack_inputs(name, inputs, params, mu_step):
    """One float32 host buffer from the solver inputs (name -> array: x,
    u, lam, u_lims, bw_lim, cfg_f), the params (name -> value) and the
    integer ``mu_step``.  Params are looked up by name."""
    _check_mu_step(mu_step)
    H = inputs["u"].shape[0]
    n_ref = len(params[_spec(name)["tables"][0]])
    arrays = _ordered(name, inputs, params, [float(mu_step)], ilqr.ALPHAS)
    return np.concatenate(
        [np.asarray(arrays[k], np.float64).astype(np.float32).reshape(-1)
         for k, _ in input_layout(name, H, n_ref)])


def pack_tensors(name, inputs, params, mu_step, alphas):
    """:func:`pack_inputs` for tensors on one device (one ``cat``):
    ``params`` maps names to 0-d / 1-d tensors, ``mu_step`` is a (1,)
    tensor (the tail of a previous result), ``alphas`` the float32
    line-search step sizes."""
    H = inputs["u"].shape[0]
    n_ref = params[_spec(name)["tables"][0]].shape[0]
    arrays = _ordered(name, inputs, params, mu_step, alphas)
    parts = []
    for k, _ in input_layout(name, H, n_ref):
        a = arrays[k]
        parts += ([v.reshape(-1) for v in a] if isinstance(a, list)
                  else [a.reshape(-1)])
    return torch.cat(parts).to(torch.float32)


def unpack_outputs(name, out, H):
    """Dict of x, u, lam, mu_step, traj_costs and iterations from a
    packed result (numpy or tensor)."""
    v = ilqr.unpack(out, ilqr.layout(output_layout(name, H))[0])
    mu_step, traj_costs, iterations = (float(a) for a in v.pop("tail"))
    return dict(v, mu_step=int(mu_step), traj_costs=traj_costs,
                iterations=int(iterations))


def _check(name, buf, H, n_ref, integrator):
    _, n = ilqr.layout(input_layout(name, H, n_ref))
    if buf.dtype != torch.float32 or buf.dim() != 1 or buf.numel() != n:
        raise ValueError(f"packed input must be a float32 vector of {n}, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("packed input must be contiguous")
    if integrator != ilqr.EULER:
        raise ValueError(f"ilqr_rstp: the RSTP solves integrate with EULER "
                         f"only, got integrator {integrator}")


def update(name, buf, H, n_ref, T, max_iterations, max_lg_iterations,
           integrator=ilqr.EULER):
    """One update of problem ``name`` from the packed inputs ``buf``
    (float32, on the solve's device); returns the packed result on the
    same device."""
    _check(name, buf, H, n_ref, integrator)
    if buf.device.type == "cpu":
        return update_reference(name, buf, H, n_ref, T, max_iterations,
                                max_lg_iterations, integrator)
    return _launch(name, buf, H, n_ref, T, max_iterations, max_lg_iterations,
                   None)


def profile(name, buf, H, n_ref, T, max_iterations, max_lg_iterations,
            integrator=ilqr.EULER):
    """:func:`update` through the kernel's profiling instantiation (CUDA
    only): returns the packed result, bit-equal to :func:`update`'s, and
    thread 0's cycles per phase, a dict over ``ilqr.PHASES`` (sums over the
    solve)."""
    _check(name, buf, H, n_ref, integrator)
    cycles = torch.zeros(len(ilqr.PHASES), dtype=torch.int64,
                         device=buf.device)
    out = _launch(name, buf, H, n_ref, T, max_iterations, max_lg_iterations,
                  cycles)
    return out, dict(zip(ilqr.PHASES, cycles.cpu().tolist()))


def _launch(name, buf, H, n_ref, T, max_iterations, max_lg_iterations,
            cycles):
    """Launches the kernel (its profiling instantiation when ``cycles``, an
    int64 tensor of ``len(ilqr.PHASES)``, is given) on the checked CUDA
    tensor ``buf``."""
    global launches
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"ilqr_rstp: unsupported device {dev}")
    lib = _kernel()
    pid = PROBLEMS[name]["id"]
    smem = lib.ilqr_rstp_smem_bytes(pid, H, n_ref)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: horizon {H} with {n_ref} reference samples "
                         f"needs {smem} B of shared memory, above {_MAX_SMEM}")
    out = torch.empty(ilqr.layout(output_layout(name, H))[1],
                      dtype=torch.float32, device=dev)
    run = (H, n_ref, T, max_iterations, max_lg_iterations)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cycles is None:
            err = lib.ilqr_rstp_update(pid, buf.data_ptr(), out.data_ptr(),
                                       *run, stream)
        else:
            err = lib.ilqr_rstp_profile(pid, buf.data_ptr(), out.data_ptr(),
                                        cycles.data_ptr(), *run, stream)
    if err != 0:
        raise RuntimeError(f"ilqr_rstp launch failed: CUDA error {err}")
    launches += 1
    return out


def traffic_bytes(name, H, n_ref):
    """Bytes one update must move: the packed input read once and the
    packed result written once."""
    return 4 * (ilqr.layout(input_layout(name, H, n_ref))[1]
                + ilqr.layout(output_layout(name, H))[1])


def operations(name, H, T, iterations, max_lg_iterations=1):
    """Operations of one update that ran ``iterations`` iLQR iterations in
    all (the result's count): the initial rollout and its cost, the
    multiplier updates, and per iteration the derivatives, the Riccati pass,
    8 rollouts with their step costs and the 8 ordered sums."""
    _spec(name)
    ops = OPS[name]
    n = min(T, H)
    init = n * (ops["rollout_step"] - 11 + ops["step_cost"] + 1)
    per_it = n * (ops["derivatives"] + ops["riccati_step"]
                  + len(ilqr.ALPHAS) * (ops["rollout_step"]
                                        + ops["step_cost"] + 1))
    return (init + max_lg_iterations * n * ops["multipliers"]
            + iterations * per_it)


def bound_ms(name, H, n_ref, T, iterations, max_lg_iterations=1):
    """(ms, "bytes" or "operations"): the roofline bound of one update."""
    return _latency.roofline_ms(
        traffic_bytes(name, H, n_ref),
        operations(name, H, T, iterations, max_lg_iterations), "float32")


def chain_ops(name, H, T, iterations):
    """Dependent operations on the critical path of one update: the
    initial rollout and its ordered cost sum, then per iteration T Riccati
    steps, T rollout steps and the ordered cost sum."""
    _spec(name)
    roll = CHAIN_ROLLOUT[name]
    n = min(T, H)
    total = {}
    add = lambda ops, times: _latency.add_ops(total, ops, times)
    add(roll, n * iterations)
    # the initial rollout has no feedback: the dynamics and the Euler sum
    add({k: v for k, v in roll.items() if k == "f32_div"}, n)
    add(dict(f32_mul=1, f32_add=1), n)
    add(CHAIN_RICCATI, n * iterations)
    add(dict(f32_add=1), n * (1 + iterations))  # the ordered cost sums
    return total


def chain_ms(name, H, T, iterations, cycles, sm_mhz):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(name, H, T, iterations), cycles,
                             sm_mhz)


_PLAIN = {}


def update_reference(name, buf, H, n_ref, T, max_iterations,
                     max_lg_iterations, integrator=ilqr.EULER):
    """The plain PyTorch update (``make_update_fn``, float32) on the device
    of ``buf``, with the packed inputs and result of :func:`update`."""
    _check(name, buf, H, n_ref, integrator)
    key = (name, H, n_ref)
    if key not in _PLAIN:
        prob, _ = getattr(problems, name)(ref_capacity=n_ref)
        _PLAIN[key] = ilqr.make_update_fn(prob, H, ilqr.EULER,
                                          dtype=torch.float32)
    p = PROBLEMS[name]
    v = ilqr.unpack(buf, ilqr.layout(input_layout(name, H, n_ref))[0])
    mu_step = int(v["mu_step"][0])
    _check_mu_step(mu_step)
    params = {n: v["scalars"][i] for i, n in enumerate(p["scalars"])}
    params.update({n: v["tables"][i] for i, n in enumerate(p["tables"])})
    cfg = ilqr.packed_cfg(v["u_lims"], v["bw_lim"], v["cfg_f"], T,
                          max_iterations, max_lg_iterations)
    state = ilqr.SolverState(v["x"], v["u"], v["lam"], mu_step)
    new, info = _PLAIN[key](state, v["x"][0], params, cfg)
    count = lambda n: torch.full((1,), float(n), dtype=torch.float32,
                                 device=buf.device)
    return torch.cat([new.x.reshape(-1), new.u.reshape(-1),
                      new.lam.reshape(-1), count(new.mu_step),
                      info["traj_costs"].reshape(1),
                      count(info["iterations"])])


def solve(name, inputs, params, T, max_iterations, max_lg_iterations,
          mu_step, integrator, device):
    """One :class:`~tpl_tpu_torch.optim.solver.Solver` update: pack the
    inputs and params (names -> host arrays), one upload to ``device``,
    :func:`update`, one download; returns :func:`unpack_outputs`."""
    H = inputs["u"].shape[0]
    n_ref = len(params[PROBLEMS[name]["tables"][0]])
    buf = torch.from_numpy(pack_inputs(name, inputs, params, mu_step))
    out = update(name, buf.to(device), H, n_ref, T, max_iterations,
                 max_lg_iterations, integrator)
    return unpack_outputs(name, out.cpu().numpy(), H)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("ilqr_rstp")
        lib.ilqr_rstp_update.restype = ctypes.c_int
        lib.ilqr_rstp_update.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.ilqr_rstp_profile.restype = ctypes.c_int
        lib.ilqr_rstp_profile.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.ilqr_rstp_smem_bytes.restype = ctypes.c_size_t
        lib.ilqr_rstp_smem_bytes.argtypes = [ctypes.c_int] * 3
        _LIB = lib
    return _LIB
