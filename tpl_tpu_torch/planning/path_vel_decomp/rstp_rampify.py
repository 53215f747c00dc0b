"""
The fused RSTP step's jerk/acc-limited reference profile, as one kernel.

:func:`scan` is the port of ``_rampify_scan``
(``tpl_tpu/planning/path_vel_decomp/fused_replan.py:244-299``), the float32
twin of the host ``ops.profile.rampify_profile``: a backward scan over
t = H-1 .. 1 that limits deceleration into slower regions, then a forward
scan that limits acceleration out of them.  Every step depends on the
previous one.  The JAX package ran the two ``jax.lax.scan`` of that
function inside the fused step's XLA program; there is no Pallas kernel.

On a CUDA tensor :func:`scan` launches the hand-written kernel
``csrc/rstp_rampify.cu`` (one launch per call, counted in ``launches``); on
a CPU tensor it runs the plain version :func:`scan_reference`, the torch
port of ``_rampify_scan`` step for step.  The kernel reads the scalars and
the limits where they lie (nine pointers), so a call copies nothing;
:func:`profile` runs its profiling instantiation.

:func:`scan_start` is the same kernel's start mode, the poly chain's
``rampify_device`` (``tpl_tpu/planning/dyn_prog/poly_chain_kernel.py:
227-273``): the same recurrences over the whole horizon, the forward scan
starting from the backward scan's end state (v, -a); plain version
:func:`scan_start_reference`.  ``launches`` counts both modes,
``start_launches`` the start mode.
"""

import ctypes

import torch

from tpl_tpu_torch import _latency

launches = 0        # kernel launches since import (reset freely)
start_launches = 0

N_SCAL = 8          # v0, a0, a_min, a_max, j_min, j_max, v_min, step
# the kernel's phases (enum Phase of csrc/rstp_rampify.cu): the limits and the
# backward reset branch staged by the block, the backward scan, the forward
# reset branch staged, the forward scan (which writes the rows out)
PHASES = ("stage", "backward", "forward_stage", "forward")
_MAX_SMEM = 227 * 1024

# Operations of one backward / forward step as the plain version defines
# them (an add, multiply, divide, maximum, minimum or select counts as one),
# and the dependent operations on each step's critical path by the probe's
# names (a maximum, minimum or select counts as an add).  Backward: the
# limit's (cv - lim) / step * cv, the maximum, then -ca / cv * step, the
# minimum and the sum.  Forward: the same with the final minimum.
OPS = dict(backward_step=15, forward_step=17)
CHAIN_BACKWARD = dict(f32_div=2, f32_mul=2, f32_add=4)
CHAIN_FORWARD = dict(f32_div=2, f32_mul=2, f32_add=5)


def _check(lim_v, T, scalars):
    H = lim_v.shape[0]
    if lim_v.dtype != torch.float32 or lim_v.dim() != 1 or H < 2:
        raise ValueError(f"lim_v must be a float32 vector of at least 2, got "
                         f"{lim_v.dtype} {tuple(lim_v.shape)}")
    if not 1 <= T <= H:
        raise ValueError(f"active length {T} outside 1..{H}")
    for s in scalars:
        if s.dtype != torch.float32 or s.numel() != 1 \
                or s.device != lim_v.device:
            raise ValueError("the scan's scalars must be float32 one-element "
                             f"tensors on {lim_v.device}")


def scan(v0, a0, lim_v, T, a_min, a_max, j_min, j_max, v_min, step):
    """The (H, 2) [velocity, acceleration] profile under the limits
    ``lim_v`` (H,), whose rows >= T hold row T-1.  Every argument but the
    host integer ``T`` is a float32 tensor on one device, the scalars with
    one element."""
    scalars = (v0, a0, a_min, a_max, j_min, j_max, v_min, step)
    _check(lim_v, T, scalars)
    dev = lim_v.device
    if dev.type == "cpu":
        return scan_reference(v0, a0, lim_v, T, a_min, a_max, j_min, j_max,
                              v_min, step)
    return _launch(scalars, lim_v, T, None)


def scan_start(lim_v, a_min, a_max, j_min, j_max, v_min, step):
    """The (H, 2) [velocity, acceleration] profile of the start mode
    under the limits ``lim_v`` (H,), every row active; the scalars are
    one-element float32 tensors on the device of ``lim_v``."""
    # v0 and a0 are not read in the start mode: any valid pointer will do
    scalars = (a_min, a_min, a_min, a_max, j_min, j_max, v_min, step)
    H = lim_v.shape[0]
    _check(lim_v, H, scalars)
    if lim_v.device.type == "cpu":
        return scan_start_reference(lim_v, a_min, a_max, j_min, j_max, v_min,
                                    step)
    return _launch(scalars, lim_v, H, None, start=True)


def profile(v0, a0, lim_v, T, a_min, a_max, j_min, j_max, v_min, step):
    """:func:`scan` through the kernel's profiling instantiation: returns
    the profile (the same bits) and thread 0's cycles per phase, a dict over
    :data:`PHASES`.  Needs a CUDA tensor."""
    scalars = (v0, a0, a_min, a_max, j_min, j_max, v_min, step)
    _check(lim_v, T, scalars)
    if lim_v.device.type != "cuda":
        raise ValueError("the profiling instantiation runs on a CUDA device, "
                         f"not {lim_v.device}")
    cycles = torch.zeros(len(PHASES), dtype=torch.int64, device=lim_v.device)
    out = _launch(scalars, lim_v, T, cycles)
    return out, dict(zip(PHASES, cycles.cpu().tolist()))


def pointers(scalars, lim_v):
    """The kernel's input argument: a host array of the nine device
    pointers (v0, a0, a_min, a_max, j_min, j_max, v_min, step, then
    ``lim_v``).  The scalars are read where they lie, so slices of one
    input vector need no copy."""
    return (ctypes.c_void_p * (N_SCAL + 1))(
        *[s.data_ptr() for s in scalars], lim_v.data_ptr())


def _launch(scalars, lim_v, T, cycles, start=False):
    """One launch on the checked CUDA inputs (the profiling instantiation
    when ``cycles`` is given, the start mode with ``start``)."""
    global launches, start_launches
    dev = lim_v.device
    if dev.type != "cuda":
        raise ValueError(f"rstp_rampify: unsupported device {dev}")
    H = lim_v.shape[0]
    lib = _kernel()
    smem = lib.rstp_rampify_smem_bytes(H)
    if smem > _MAX_SMEM:
        raise ValueError(f"horizon {H} needs {smem} B of shared memory, "
                         f"above {_MAX_SMEM}")
    lim_v = lim_v.contiguous()
    out = torch.empty((H, 2), dtype=torch.float32, device=dev)
    ptrs = pointers(scalars, lim_v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if start:
            err = lib.rstp_rampify_scan_start(ptrs, out.data_ptr(), H, stream)
        elif cycles is None:
            err = lib.rstp_rampify_scan(ptrs, out.data_ptr(), H, T, stream)
        else:
            err = lib.rstp_rampify_profile(ptrs, out.data_ptr(),
                                           cycles.data_ptr(), H, T, stream)
    if err != 0:
        raise RuntimeError(f"rstp_rampify launch failed: CUDA error {err}")
    launches += 1
    start_launches += int(start)
    return out


def traffic_bytes(H):
    """Bytes one scan must move: the 8 scalars and the limits read once,
    the (H, 2) profile written once."""
    return 4 * (N_SCAL + H) + 4 * 2 * H


def operations(H):
    """Operations of one scan: the staged limits, H - 1 backward steps and
    H forward steps."""
    return H + (H - 1) * OPS["backward_step"] + H * OPS["forward_step"]


def bound_ms(H):
    """(ms, "bytes" or "operations"): the roofline bound of one scan."""
    return _latency.roofline_ms(traffic_bytes(H), operations(H), "float32")


def chain_ops(H):
    """Dependent operations on the critical path: H - 1 backward steps,
    then H forward steps."""
    total = {k: v * (H - 1) for k, v in CHAIN_BACKWARD.items()}
    for k, v in CHAIN_FORWARD.items():
        total[k] = total.get(k, 0) + v * H
    return total


def chain_ms(H, cycles, sm_mhz):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(H), cycles, sm_mhz)


def scan_reference(v0, a0, lim_v, T, a_min, a_max, j_min, j_max, v_min,
                   step, start=False):
    """The plain PyTorch version of :func:`scan` (a Python loop of
    one-element tensor ops), on the device of ``lim_v``; with ``start``
    that of :func:`scan_start` (``v0`` and ``a0`` unread)."""
    v0, a0, a_min, a_max, j_min, j_max, v_min, step = (
        s.reshape(()) for s in (v0, a0, a_min, a_max, j_min, j_max, v_min,
                                step))
    H = lim_v.shape[0]
    dev = lim_v.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lim = torch.maximum(torch.cat([lim_v[:T], lim_v[T - 1].expand(H - T)]),
                        v_min)

    # backward pass over t = H-1 .. 1; row t keeps the carry before step t
    cv, ca = lim[H - 1], zero
    bv, ba = [zero] * H, [zero] * H
    for t in range(H - 1, 0, -1):
        bv[t], ba[t] = cv, ca
        lim_t, lim_tm1 = lim[t], lim[t - 1]
        lim_a = torch.maximum(a_min, (cv - lim_tm1) / step * cv)
        neg = lim_a < 0.0
        ca = torch.where(neg, torch.maximum(ca + j_min / cv * step, lim_a),
                         zero)
        cv = torch.where(neg, cv, lim_t)
        cv = cv + torch.minimum(-ca / cv * step, lim_tm1 - cv)

    # forward pass
    if start:
        ca = -ca
    else:
        cv, ca = torch.maximum(v0, v_min), a0
    bv[0], ba[0] = cv, ca
    lim_a = zero
    out_v, out_a = [], []
    for t in range(H):
        if t < H - 1:
            lim_a = torch.minimum(a_max, (bv[t + 1] - cv) / step * cv)
        pos = lim_a > 0.0
        ca = torch.where(pos, torch.minimum(ca + j_max / cv * step, lim_a),
                         zero)
        cv = torch.where(pos, cv, bv[t])
        next_v = cv + torch.minimum(ca / cv * step, lim[t] - cv)
        cv = torch.minimum(bv[t], next_v)
        out_v.append(cv)
        out_a.append(ca)
    return torch.stack([torch.stack(out_v), torch.stack(out_a)], -1)


def scan_start_reference(lim_v, a_min, a_max, j_min, j_max, v_min, step):
    """The plain PyTorch version of :func:`scan_start`."""
    return scan_reference(a_min, a_min, lim_v, lim_v.shape[0], a_min, a_max,
                          j_min, j_max, v_min, step, start=True)


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("rstp_rampify")
        lib.rstp_rampify_scan.restype = ctypes.c_int
        lib.rstp_rampify_scan.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.rstp_rampify_scan_start.restype = ctypes.c_int
        lib.rstp_rampify_scan_start.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
        lib.rstp_rampify_profile.restype = ctypes.c_int
        lib.rstp_rampify_profile.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        if lib.rstp_rampify_n_phases() != len(PHASES):
            raise RuntimeError("rstp_rampify.cu and PHASES disagree")
        lib.rstp_rampify_smem_bytes.restype = ctypes.c_size_t
        lib.rstp_rampify_smem_bytes.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB
