"""
One full AL-iLQR update of the spatial-progress tracking MPC, as one kernel.

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
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch.optim import ilqr, problems

NX, NU, NC = 7, 2, 4
# the kernel's scalar params and reference tables, in its order
# (enum Scalar / enum Table of csrc/ilqr_tracking_mpc.cu)
SCALARS = ("pd", "pv", "pdelta", "min_pdelta_dot", "pdelta_dot",
           "min_p_phi_dot", "p_phi_dot", "p_phi", "p_phi_ref_dot_diff",
           "pa", "pj", "l", "v_ch", "ref_step", "max_delta", "max_acc",
           "min_acc", "a_offset")
TABLES = ("ref_x", "ref_y", "ref_phi", "ref_k", "ref_v")

launches = 0        # kernel launches since import (reset freely)

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
    global launches
    _check(buf, H, n_ref, mu_step, integrator)
    dev = buf.device
    if dev.type == "cpu":
        return update_reference(buf, H, n_ref, T, max_iterations,
                                max_lg_iterations, mu_step, integrator)
    if dev.type != "cuda":
        raise ValueError(f"ilqr_tracking_mpc: unsupported device {dev}")

    lib = _kernel()
    smem = lib.ilqr_tracking_mpc_smem_bytes(H, n_ref)
    if smem > _MAX_SMEM:
        raise ValueError(f"horizon {H} with {n_ref} reference samples needs "
                         f"{smem} B of shared memory, above {_MAX_SMEM}")
    out = torch.empty(ilqr.layout(output_layout(H))[1], dtype=torch.float64,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ilqr_tracking_mpc(buf.data_ptr(), out.data_ptr(), H, n_ref,
                                    T, max_iterations, max_lg_iterations,
                                    mu_step, integrator, stream)
    if err != 0:
        raise RuntimeError(f"ilqr_tracking_mpc launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


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
        lib.ilqr_tracking_mpc_smem_bytes.restype = ctypes.c_size_t
        lib.ilqr_tracking_mpc_smem_bytes.argtypes = [ctypes.c_int] * 2
        _LIB = lib
    return _LIB
