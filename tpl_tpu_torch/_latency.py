"""
The card's limits that the kernels' bounds are stated against.

Two bounds stand beside every hand-written kernel:

- ``bound_ms``, the roofline bound: the bytes the function must move (each
  input read once, each output written once) over the card's memory rate,
  against the operations it does over the card's peak rate for their type,
  whichever is larger (:func:`roofline_ms`; NVIDIA's data sheet of the H100
  SXM: 3.35 TB/s, 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
  tensor cores);
- ``chain_ms``, the bound that is real for a dependent scan: the operations
  on the algorithm's critical path times the latency of each on this card
  (:func:`chain_ms`).  The latencies come from :func:`measure`, which runs
  ``csrc/latency_probe.cu``: one thread, 4096 dependent operations per type
  between two ``clock64()`` reads (``f32_rate`` / ``f64_rate``: four
  independent add chains side by side, so cycles per instruction started by
  one warp rather than a latency).

The wrapper modules count bytes, operations and critical-path operations
from shapes (``traffic_bytes``, ``operations``, ``chain_ops``), so the CPU
tests reach every count; only :func:`measure` needs the card.
"""

import ctypes

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

# the order of enum Probe in csrc/latency_probe.cu
PROBES = ("f32_add", "f32_mul", "f32_div", "f32_sin", "f32_cos", "f32_atan",
          "f32_fmod", "f64_add", "f64_mul", "f64_div", "f64_sin", "f64_cos",
          "f64_tan", "f64_fmod", "smem_load", "f32_rate", "f64_rate")
# probes whose chain carries one extra operation, taken off the reading
_EXTRA_OP = {"f64_tan": "f64_add", "f64_fmod": "f64_add",
             "f32_fmod": "f32_add"}

launches = 0        # probe launches since import


def roofline_ms(n_bytes, n_ops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``n_bytes`` and do ``n_ops`` operations of ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def add_ops(total, ops, times):
    """Adds ``times`` repetitions of the operation counts ``ops`` to
    ``total`` (both map an operation of :data:`PROBES` to a count)."""
    for op, n in ops.items():
        total[op] = total.get(op, 0) + n * times
    return total


def chain_ms(ops, cycles, sm_mhz):
    """The time of a critical path: ``ops`` maps an operation of
    :data:`PROBES` to its count on the path, ``cycles`` to its latency in
    SM cycles, ``sm_mhz`` is the SM clock."""
    return sum(n * cycles[op] for op, n in ops.items()) / (sm_mhz * 1e3)


def measure(device):
    """Cycles per dependent operation on ``device`` (a CUDA device), by
    name (:data:`PROBES`)."""
    global launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the latency probe runs on a CUDA device, not {dev}")
    lib = _kernel()
    n_ops = lib.latency_probe_n_ops()
    seeds = torch.tensor([1.0 + 2.0 ** -20, 2.0 ** -20, 0.0],
                         dtype=torch.float64, device=dev)
    cycles = torch.zeros(len(PROBES), dtype=torch.int64, device=dev)
    sink = torch.zeros(len(PROBES), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.latency_probe_run(seeds.data_ptr(), cycles.data_ptr(),
                                sink.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"latency_probe launch failed: CUDA error {err}")
    launches += 1
    per_op = dict(zip(PROBES, (cycles.cpu().numpy() / n_ops).tolist()))
    for name, extra in _EXTRA_OP.items():
        per_op[name] -= per_op[extra]
    return per_op


def sincos_mismatches(device, lo, hi, n):
    """How many of ``n`` evenly spaced float64 arguments in [lo, hi) give
    another bit pattern from the card's ``sincos()`` than from its
    ``sin()`` and ``cos()`` (the tracking-MPC kernel's rollouts take both
    of an angle in one ``sincos()`` call)."""
    global launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the sincos check runs on a CUDA device, not {dev}")
    lib = _kernel()
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sincos_check(float(lo), (float(hi) - float(lo)) / n, int(n),
                               count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sincos_check launch failed: CUDA error {err}")
    launches += 1
    return int(count.item())


_LIB = None


def _kernel():
    """Build (first call) and bind the probe library."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("latency_probe")
        lib.latency_probe_run.restype = ctypes.c_int
        lib.latency_probe_run.argtypes = [ctypes.c_void_p] * 4
        lib.sincos_check.restype = ctypes.c_int
        lib.sincos_check.argtypes = [ctypes.c_double, ctypes.c_double,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
        lib.latency_probe_n_ops.restype = ctypes.c_int
        lib.latency_probe_n_ops.argtypes = []
        _LIB = lib
    return _LIB
