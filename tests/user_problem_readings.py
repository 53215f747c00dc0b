"""Readings behind ``chip_smoke.py``'s USER_OWN_TOL: how far two float64
solves of the two problems of ``tpl_tpu_torch.scenes.USER_PROBLEMS`` part
when only their rounding differs, at the problems' own iterations.

    JAX_PLATFORMS=cpu python tests/user_problem_readings.py [B]

For each problem, at its own iterations (``USER_SETTINGS`` it) and at
fewer: the single solve from the ``Solver``'s cold start, and a batch of B
(default 64) spread starts as ``chip_smoke.traced_ops_batch`` makes them,
each through the traced struct compiled with g++ for the host (the
rehearsal of ``tests/test_torch_trace.py``) against the plain float64
iLQR (max |dx|, |du| over the largest |x|, the relative cost, whether the
iterations agree); the plain batch against itself with its starts moved by
1e-14 (relative); and the plain float32 single solve against the plain
float64 one (the control).  Not a test: it needs g++, imports JAX through
the tests' rehearsal harness and runs about two minutes.
"""

import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def struct_library(specs, tmp):
    """The generic body and ``specs`` ({name: (id, Spec)}) compiled with
    g++ into one library, bound as the rehearsal binds it."""
    import test_torch_ilqr_generic as tig
    import test_torch_kernel_rehearsal as reh
    import test_torch_trace as tt
    from tpl_tpu_torch import _build

    gen = "\n".join(s.struct for _, s in specs.values())
    gen += "\n#define GENERATED_PROBLEMS(X) " + " ".join(
        f"X({i}, {s.struct_name})" for i, s in specs.values()) + "\n"
    (tmp / "cuda_runtime.h").write_text(reh.STUB)
    (tmp / "generated.cuh").write_text(gen)
    (tmp / "harness.cpp").write_text(tig.HARNESS + tt.JETS)
    so = tmp / "readings.so"
    done = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-x", "c++", "-I", str(tmp), "-I", _build.CSRC,
         str(tmp / "harness.cpp"), "-o", str(so)],
        capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(done.stderr[-4000:])
    import ctypes
    lib = ctypes.CDLL(str(so))
    lib.rehearse_generic.restype = None
    lib.rehearse_generic.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_size_t, ctypes.c_void_p])
    lib.rehearse_generic_split.restype = ctypes.c_size_t
    lib.rehearse_generic_split.argtypes = ([ctypes.c_int] * 3
                                           + [ctypes.c_size_t, ctypes.c_int])
    tt.bind_jets(lib)
    lib.rehearse_set_consts.restype = None
    lib.rehearse_set_consts.argtypes = [ctypes.c_void_p]
    return lib


def parting(got, want):
    d = max(float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))))
            for k in ("x", "u"))
    return (d / max(1.0, float(np.max(np.abs(want["x"])))),
            abs(got["traj_costs"] - want["traj_costs"])
            / abs(want["traj_costs"]))


def batch_parting(got, want):
    """Max over the scenarios of max |dx| over the scenario's largest |x|;
    the scenarios whose iterations differ."""
    per = max(float((got[0][..., b] - want[0][..., b]).abs().max())
              / max(1.0, float(want[0][..., b].abs().max()))
              for b in range(want[0].shape[-1]))
    return per, int((got[5] != want[5]).sum())


def main(B=64):
    import test_torch_trace as tt
    import tpl_tpu_torch
    from tpl_tpu_torch import scenes
    from tpl_tpu_torch.optim import batched, trace
    from tpl_tpu_torch.optim import ilqr_generic as ig

    tpl_tpu_torch.use_device("cpu")
    f64 = torch.float64
    specs = {}
    for i, name in enumerate(scenes.USER_PROBLEMS):
        prob, pspec = scenes.user_problem(name)
        specs[name] = (100 + i, trace.spec(prob, trace.kinds_of_spec(pspec)))
    with tempfile.TemporaryDirectory() as tmp:
        lib = struct_library(specs, pathlib.Path(tmp))
    for name, (pid, spec) in specs.items():
        st = scenes.USER_SETTINGS[name]
        H, integ, own = st["H"], st["integ"], st["it"]
        for its in sorted({st["it_exact"], 5, 10, own}):
            opt = scenes.user_solver(name, f64, "cpu", max_iterations=its)
            state = {k: np.array(v) for k, v in opt._inputs().items()}
            params = dict(opt.params._values)
            host = ig.pack_inputs(spec, state, params, 0)
            n_sh = ig._size(ig.shared_layout(spec, H, 0))
            got = ig.unpack_outputs(spec, tt.rehearse(
                lib, pid, spec, host[:n_sh], host[n_sh:][None], H, 0, H, its,
                integ)[0], H)
            want = ig.unpack_outputs(spec, ig.update_reference(
                spec, torch.from_numpy(host), H, 0, H, its, 1,
                integ).numpy(), H)
            p32, s32 = scenes.user_problem(name, torch.float32)
            spec32 = trace.spec(p32, trace.kinds_of_spec(s32))
            w32 = ig.unpack_outputs(spec32, ig.update_reference(
                spec32, torch.from_numpy(ig.pack_inputs(
                    spec32, state, params, 0, torch.float32)),
                H, 0, H, its, 1, integ).double().numpy(), H)
            print(f"{name} single, {its} iterations: struct against plain "
                  "%.3e of the largest |x|, cost %.3e, iterations %d / %d; "
                  "plain float32 against float64 %.3e, cost %.3e" % (
                      *parting(got, want), got["iterations"],
                      want["iterations"], *parting(w32, want)), flush=True)
        prob, pspec = scenes.user_problem(name)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
        tp = {k: t(v) for k, v in pspec.items()}
        lims = np.asarray(st["u_lim"], float)
        rng = np.random.default_rng(B)
        x, u, lam, mu = batched.init_batch(prob, H, B, f64, "cpu")
        x0 = t(np.asarray(st["x0"])[:, None] + rng.normal(0.0, 1.0, (4, B))
               * np.array([[0.5], [0.5], [0.05], [0.5]]))
        upd = batched.make_batched_update_fn(prob, H, B, integ, f64)
        for its in sorted({st["it_exact"], 5, 10, own}):
            cfg = dict(u_min=t(np.tile(lims[:, 0], (H, 1))),
                       u_max=t(np.tile(lims[:, 1], (H, 1))),
                       barrier_weight=t(np.ones(prob.nc)),
                       lg_mult_limit=t(np.full(prob.nc, 1e4)),
                       dt=t(st["dt"]), min_rel_cost_change=t(1e-6), T=H,
                       max_iterations=its, max_lg_iterations=1)
            shared, rows = ig.pack_inputs_batched(spec, x, u, lam, mu, x0,
                                                  tp, cfg)
            got = ig.unpack_outputs_batched(spec, torch.from_numpy(
                tt.rehearse(lib, pid, spec, shared.numpy(), rows.numpy(), H,
                            0, H, its, integ)), H)
            want = upd.reference(x, u, lam, mu, x0, tp, cfg,
                                 iterations=True)
            moved = upd.reference(x, u, lam, mu, x0 * (1 + 1e-14), tp, cfg,
                                  iterations=True)
            print(f"{name} B={B}, {its} iterations: struct against plain "
                  "%.3e, iterations differ in %d; plain, starts moved by "
                  "1e-14, %.3e, iterations differ in %d" % (
                      *batch_parting(got, want),
                      *batch_parting(moved, want)), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
