"""The port's public surface against the JAX package's.

For every module and package ``__init__`` of ``tpl_tpu/``, every public
top-level name (``__all__`` where a module has one; else a class or a
function it defines, for a package also one it re-exports from the JAX
package, and a module-level assignment, each without a leading
underscore) has its counterpart of the same name in the same module of
``tpl_tpu_torch/``, or a rename listed with its reason in :data:`RENAMES`
(a module's in :data:`MODULE_RENAMES`).  The names that came last
(``ops.gen_prediction_geometry``, ``ops.lqr_smoother_torch`` and
``util.list_data``) are held against the JAX functions on seeded inputs, at
1e-12 in float64.

    python -m pytest tests/test_torch_surface.py -q
"""

import ast
import importlib
import inspect
import os
import types

import numpy as np
import pytest
import torch

import tpl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX module -> (its counterpart in the port, why it has another name)
MODULE_RENAMES = {
    "tpl_tpu.planning.dyn_prog.latlon_pallas": (
        "tpl_tpu_torch.planning.dyn_prog.latlon_action_min",
        "the Pallas kernel's module: its counterpart is the CUDA kernel "
        "csrc/latlon_action_min.cu and its wrapper"),
}

# (JAX module, name) -> (the counterpart: a name of the same module, or
# "module.name" elsewhere, or None where none is needed; the reason)
RENAMES = {
    ("tpl_tpu.ops", "lqr_smoother_jax"): (
        "lqr_smoother_torch", "the same Riccati scan and rollout on the "
        "port's device; the name says the framework"),
    ("tpl_tpu.ops.lqr", "lqr_smoother_jax"): (
        "lqr_smoother_torch", "as in tpl_tpu.ops"),
    ("tpl_tpu.planning.dyn_prog.poly_lat_kernel", "PolyLatPlannerJax"): (
        "PolyLatPlanner", "the reference's name; the JAX package marked "
        "its own"),
    ("tpl_tpu.planning.dyn_prog.poly_chain_kernel", "select_path_device"): (
        "tpl_tpu_torch.planning.dyn_prog.poly_lat_kernel.sweep_select",
        "the in-program selection: the port selects inside the sweep's "
        "kernel (poly_lat_sweep_select)"),
    ("tpl_tpu.planning.dyn_prog.poly_planner_kernel", "make_edge_eval"): (
        "eval_edges", "the jitted evaluation's maker: the port's kernel "
        "poly_eval_edges, launched by eval_edges"),
    ("tpl_tpu.ops.interp", "primal_only"): (
        None, "a switch of the custom_jvp lookups' tangents; autograd "
        "differentiates the port's lookups and needs none"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "make_action_min"): (
        "action_min", "the pallas_call's maker: the CUDA kernel's "
        "wrapper"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "pad_values"): (
        None, "the TPU tile padding of the kernel's inputs; the CUDA "
        "kernel reads them unpadded"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "pad_sl"): (
        None, "as pad_values"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "unpack_out"): (
        None, "the padded output's unpacking; the CUDA kernel writes it "
        "unpadded"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "S_PAD"): (
        None, "a TPU tile padding (lanes)"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "L_PAD"): (
        None, "a TPU tile padding (sublanes)"),
    ("tpl_tpu.planning.dyn_prog.latlon_pallas", "L_PAD_LO"): (
        None, "a TPU tile padding (the shift reach)"),
}


def jax_modules():
    """The JAX package's modules, by its files (no import)."""
    root = os.path.join(REPO, "tpl_tpu")
    out = []
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append(".".join(parts))
    return out


def _assigned(mod):
    out = set()
    for node in ast.parse(inspect.getsource(mod)).body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            out |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
    return out


def public_names(mod):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    package = hasattr(mod, "__path__")
    own = _assigned(mod)
    out = set()
    for name, v in vars(mod).items():
        if name.startswith("_") or isinstance(v, types.ModuleType):
            continue
        where = getattr(v, "__module__", None) if callable(v) else None
        if where is not None:
            if where == mod.__name__ or (package
                                         and where.startswith("tpl_tpu.")):
                out.add(name)
        elif name in own:
            out.add(name)
    return out


def _has(module, name):
    if "." in name:
        mod, attr = name.rsplit(".", 1)
        return hasattr(importlib.import_module(mod), attr)
    return hasattr(module, name)


@pytest.mark.parametrize("name", jax_modules())
def test_every_public_name_has_a_counterpart(name):
    jmod = importlib.import_module(name)
    tname, _ = MODULE_RENAMES.get(
        name, ("tpl_tpu_torch" + name[len("tpl_tpu"):], None))
    tmod = importlib.import_module(tname)
    missing = []
    for n in sorted(public_names(jmod)):
        if (name, n) in RENAMES:
            other, reason = RENAMES[(name, n)]
            assert reason
            if other is not None and not _has(tmod, other):
                missing.append(f"{n} -> {other}")
        elif not hasattr(tmod, n):
            missing.append(n)
    assert not missing, f"{tname} lacks {missing}"


def test_renames_name_real_jax_names():
    """Every listed rename is of a public name the JAX module has."""
    for (mod, n) in RENAMES:
        assert n in public_names(importlib.import_module(mod)), (mod, n)
    for mod in MODULE_RENAMES:
        assert mod in jax_modules()


# ---------------------------------------------------------------------
# the last counterparts against the JAX functions

def test_lqr_smoother_torch_matches_jax():
    import jax.numpy as jnp
    from tpl_tpu import ops as j_ops
    from tpl_tpu_torch import ops

    rng = np.random.default_rng(4)
    H, X, U, dt = 40, 3, 1, 0.1
    fx = np.eye(X) + dt * np.diag(np.ones(X - 1), 1)
    fu = np.zeros((X, U))
    fu[-1, 0] = dt
    x_ref = np.cumsum(rng.normal(0.0, 0.3, (H, X)), 0)
    lxx = np.stack([np.diag(rng.uniform(0.5, 2.0, X)) for _ in range(H)])
    luu = np.stack([np.diag(rng.uniform(0.05, 0.2, U)) for _ in range(H)])
    x0 = x_ref[0] + rng.normal(0.0, 0.1, X)
    xs, us = ops.lqr_smoother_torch(x0, x_ref, fx, fu, lxx, luu,
                                    device="cpu")
    assert xs.dtype == torch.float64 and xs.device == torch.device("cpu")
    jxs, jus = j_ops.lqr_smoother_jax(*(jnp.asarray(a) for a in (
        x0, x_ref, fx, fu, lxx, luu)))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=1e-12,
                               atol=1e-12)
    # on the port's device unless given
    tpl_tpu_torch.use_device("cpu")
    xs2, _ = ops.lqr_smoother_torch(x0, x_ref, fx, fu, lxx, luu)
    assert torch.equal(xs2, xs)


def test_gen_prediction_geometry_matches_jax():
    from tpl_tpu import ops as j_ops
    from tpl_tpu_torch import ops

    rng = np.random.default_rng(9)
    s = np.arange(0.0, 120.0, 0.5)
    path = np.column_stack([s, 3.0 * np.sin(0.03 * s)])
    c = path[40] + np.array([0.0, 0.4])
    hull = c + np.array([[-2.2, -0.9], [2.2, -0.9], [2.2, 0.9], [-2.2, 0.9]])
    ts = np.arange(0.0, 5.0, 0.5)
    v = 6.0 + rng.normal(0.0, 0.5, len(ts))
    xy = c + np.cumsum(np.column_stack([v * 0.5, np.zeros_like(v)]), 0)
    pred = np.column_stack([ts, xy, np.zeros_like(ts), v])
    for kw in ({}, dict(station_step_size=2.5, sweep_length=1.0)):
        got = ops.gen_prediction_geometry(pred, hull, path, ts, **kw)
        want = j_ops.gen_prediction_geometry(pred, hull, path, ts, **kw)
        assert len(got) == len(want) > 0
        for (q, t), (wq, wt) in zip(got, want):
            np.testing.assert_allclose(q, wq, rtol=1e-12, atol=1e-12)
            assert t == wt


def test_list_data_matches_jax(tmp_path, monkeypatch):
    from tpl_tpu import util as j_util
    from tpl_tpu_torch import util

    for kind in ("scenarios", "maps", "params"):
        assert util.list_data(kind) == j_util.list_data(kind)
    # a user's data root first: its entries win a name clash
    (tmp_path / "scenarios" / "mine").mkdir(parents=True)
    (tmp_path / "scenarios" / "demo").mkdir()
    monkeypatch.setenv("TPL_TPU_DATA", str(tmp_path))
    got, want = util.list_data("scenarios"), j_util.list_data("scenarios")
    assert got == want
    assert got["mine"] == str(tmp_path / "scenarios" / "mine")
