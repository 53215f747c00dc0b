"""
Backward action-min of the DP lat/lon value iteration.

For every (s, ds, l) cell of one time slice: look up the next-slice node of
each of the 7 x 7 (dds, dl) actions, form the action's constraint and cost,
and keep the lexicographic (constraint, cost) minimum, first minimum winning
in dl-outer / dds-inner order.  Returns the slice's nodes
``[state_cost + cost, state_constr + constr, dds_best, dl_best]``.
(reference: lat_lon_planner.cu:160-192; the JAX package's XLA form is
lat_lon_kernel.py backward_slice, its TPU kernel latlon_pallas.py
make_action_min)

:func:`action_min` runs the hand-written CUDA kernel
(``csrc/latlon_action_min.cu``) on a CUDA tensor and the plain PyTorch
version :func:`action_min_reference` on a CPU tensor.  ``launches`` counts
kernel launches.
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency

NB = 7              # backward action samples per dimension

launches = 0        # kernel launches since import (reset freely)

# Operations of one action of one cell as the plain version defines them
# (the occupancy and safety clamps, the five cost terms, the next node's
# cost and the lexicographic comparison) and of one cell beside its actions
# (the safety distance per dl, the two final sums); an add, multiply,
# compare or clamp counts as one.
OPS = dict(action=21, cell=23)
# A cell's critical path: a load of the next node, the longest cost chain
# of one action (8 dependent adds and multiplies) and a min-reduction tree
# over the 49 actions (6 levels, a compare-select counted as an add).
CHAIN_CELL = dict(smem_load=1, f32_add=12, f32_mul=2)

TABLE_KEYS = ("ids", "ks", "kl", "ca", "schg", "qdds", "qdl", "dds_vals",
              "dl_vals", "dss", "consts")
_INT_TABLES = ("ids", "ks", "kl")


def div_const(x, n):
    """x / n for a constant n, computed as x * float32(1 / n): the
    rounding of the JAX package's compiled programs, which turn every
    division by a compile-time constant into that product."""
    return x * float(np.float32(1.0) / np.float32(n))


def dds_samples(pp):
    """Evenly spaced dds action values (NB,)."""
    dev = pp["dds_min"].device
    return pp["dds_min"] + div_const(
        (pp["dds_max"] - pp["dds_min"])
        * torch.arange(NB, dtype=torch.float32, device=dev), NB - 1)


def dl_samples(pp):
    """Center-out dl action values (NB,): 0, +k*step, -k*step
    (lat_lon_planner.cu:202-236)."""
    dev = pp["dl_min"].device
    n2 = NB // 2
    step = div_const(pp["dl_max"] - pp["dl_min"], 2 * n2)
    kk = torch.arange(1, n2 + 1, dtype=torch.float32, device=dev)
    return torch.cat([torch.zeros(1, dtype=torch.float32, device=dev),
                      step * kk, -step * kk])


def make_tables(pp, dss, s_step, ds_step, l_step, DS):
    """Per-action scalar tables of one solve (param-only).

    pp: dict of 0-d float32 tensors; dss (DS,) ds grid values.  Integer
    shifts use ``torch.round`` (half to even, as ``jnp.round``) before the
    clamp and the int cast.
    """
    dt = pp["dt"]
    dds_s = dds_samples(pp)
    dl_s = dl_samples(pp)

    s_change = torch.clamp(dss[:, None] * dt + 0.5 * dds_s[None, :] * dt * dt,
                           min=0.0)                              # (DS, NB)
    ks = torch.round(s_change / s_step).to(torch.int32)
    dsn = torch.clamp(dss[:, None] + dds_s[None, :] * dt, min=0.0)
    ids = torch.clamp(torch.round((dsn - pp["ds_min"]) / ds_step),
                      0, DS - 1).to(torch.int32)
    kl = torch.round(dl_s * dt / l_step).to(torch.int32)

    l_change = dl_s * dt
    slope = torch.abs(l_change[None, None, :] / s_change[:, :, None])
    ca = torch.where(slope > pp["slope_abs_max"],
                     torch.abs(slope - pp["slope_abs_max"]) * 1000.0, 0.0)
    # nan -> 0, +inf -> FLT_MAX (jnp.nan_to_num defaults)
    ca = torch.nan_to_num(ca, nan=0.0)                       # (DS, dds, dl)

    qdds = pp["w_dds"] * (dds_s * dt) ** 2
    qdl = pp["w_dl"] * (dl_s * dt) ** 2
    consts = torch.stack([pp["gap_min"], pp["time_gap"],
                          pp["w_safety_dist"], pp["w_ddds"], pp["w_ddl"]])
    return dict(ids=ids.contiguous(), ks=ks.contiguous(), kl=kl, ca=ca,
                schg=s_change, qdds=qdds, qdl=qdl, dds_vals=dds_s,
                dl_vals=dl_s, dss=dss.contiguous(), consts=consts)


def action_min_reference(nodes_next, state_cost, state_constr, d_fwd,
                         tables, return_actions=False):
    """Plain PyTorch action-min (whole-tensor gathers).

    With ``return_actions`` also returns the per-action (constr, cost)
    tensors (S, DS, L, NB*NB) in scan order, for tie diagnostics.
    """
    S, DS, L, _ = nodes_next.shape
    dev = nodes_next.device
    tb = tables
    gap_min, time_gap, w_safety, w_ddds, w_ddl = tb["consts"]
    dds_s, dl_s = tb["dds_vals"], tb["dl_vals"]

    # next-node lookup: target ds row per (ds, dds), edge-clamped s shift
    # per (ds, dds), edge-clamped l shift per dl
    P = DS * NB
    j_vec = tb["ids"].reshape(P).long()
    k_vec = tb["ks"].reshape(P).long()
    idx_s = torch.clamp(torch.arange(S, device=dev)[None, :]
                        + k_vec[:, None], 0, S - 1)              # (P, S)
    D = nodes_next[idx_s, j_vec[:, None]]                        # (P,S,L,4)
    idx_l = torch.clamp(torch.arange(L, device=dev)[None, :]
                        + tb["kl"].long()[:, None], 0, L - 1)    # (NB, L)
    E = D[:, :, idx_l]                                           # (P,S,NB,L,4)
    nn = E.reshape(DS, NB, S, NB, L, 4).permute(2, 0, 4, 1, 3, 5)
    # nn: (S, DS, L, dds, dl, 4)
    cost_next = nn[..., 0]
    constr_next = nn[..., 1]
    tn_dds = nn[..., 2]
    tn_dl = nn[..., 3]

    d_safety = (d_fwd[:, None, :, :] - gap_min
                - tb["dss"][None, :, None, None] * time_gap)    # (S,DS,L,dl)
    sc_b = tb["schg"][None, :, None, :, None]                    # dds axis 3
    occ_c = torch.clamp(sc_b - d_fwd[:, None, :, None, :], min=0.0)
    constr_all = tb["ca"][None, :, None, :, :] + occ_c + constr_next

    cost_a = w_safety * torch.clamp(sc_b - d_safety[:, :, :, None, :],
                                    min=0.0)
    cost_a = cost_a + tb["qdds"][None, None, None, :, None]
    cost_a = cost_a + w_ddds * (tn_dds - dds_s[None, None, None, :, None]) ** 2
    cost_a = cost_a + tb["qdl"][None, None, None, None, :]
    cost_a = cost_a + w_ddl * (tn_dl - dl_s[None, None, None, None, :]) ** 2
    cost_all = cost_a + cost_next

    # lexicographic (constr, cost) argmin, dl outer / dds inner, first
    # minimum wins
    cost_o = cost_all.transpose(3, 4).reshape(S, DS, L, NB * NB)
    constr_o = constr_all.transpose(3, 4).reshape(S, DS, L, NB * NB)
    cmin = torch.amin(constr_o, dim=-1, keepdim=True)
    cost_m = torch.where(constr_o == cmin, cost_o, float("inf"))
    aidx = torch.argmin(cost_m, dim=-1, keepdim=True)           # (S,DS,L,1)

    tot_cost = torch.gather(cost_o, -1, aidx)[..., 0]
    tot_constr = torch.gather(constr_o, -1, aidx)[..., 0]
    aidx = aidx[..., 0]
    node = torch.stack([state_cost + tot_cost,
                        state_constr + tot_constr,
                        dds_s[aidx % NB], dl_s[aidx // NB]], dim=-1)
    if return_actions:
        return node, constr_o, cost_o
    return node


def traffic_bytes(S, DS, L):
    """Bytes one slice must move: the next nodes, the two state maps, the
    forward distances and the action tables read once, the nodes written
    once (all 4-byte words)."""
    cells = S * DS * L
    tables = (3 * DS * NB + NB) + DS * NB * NB + DS * NB + 4 * NB + DS + 5
    return 4 * (4 * cells + 2 * cells + S * L * NB + tables + 4 * cells)


def operations(S, DS, L):
    """Operations of one slice: every cell tries NB * NB actions."""
    return S * DS * L * (NB * NB * OPS["action"] + OPS["cell"])


def bound_ms(S, DS, L):
    """(ms, "bytes" or "operations"): the roofline bound of one slice."""
    return _latency.roofline_ms(traffic_bytes(S, DS, L),
                                operations(S, DS, L), "float32")


def chain_ops():
    """Dependent operations on one cell's critical path (the cells are
    independent, so the slice's path is one cell's)."""
    return dict(CHAIN_CELL)


def chain_ms(cycles, sm_mhz):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(), cycles, sm_mhz)


def _check(nodes_next, state_cost, state_constr, d_fwd, tables):
    if nodes_next.dim() != 4 or nodes_next.shape[-1] != 4:
        raise ValueError(f"nodes_next must be (S, DS, L, 4), got "
                         f"{tuple(nodes_next.shape)}")
    S, DS, L, _ = nodes_next.shape
    want = {"state_cost": (state_cost, (S, DS, L)),
            "state_constr": (state_constr, (S, DS, L)),
            "d_fwd": (d_fwd, (S, L, NB)),
            "ids": (tables["ids"], (DS, NB)), "ks": (tables["ks"], (DS, NB)),
            "kl": (tables["kl"], (NB,)), "ca": (tables["ca"], (DS, NB, NB)),
            "schg": (tables["schg"], (DS, NB)),
            "qdds": (tables["qdds"], (NB,)), "qdl": (tables["qdl"], (NB,)),
            "dds_vals": (tables["dds_vals"], (NB,)),
            "dl_vals": (tables["dl_vals"], (NB,)),
            "dss": (tables["dss"], (DS,)), "consts": (tables["consts"], (5,))}
    want["nodes_next"] = (nodes_next, (S, DS, L, 4))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        dtype = torch.int32 if name in _INT_TABLES else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
        if t.device != nodes_next.device:
            raise ValueError(f"{name} on {t.device}, nodes_next on "
                             f"{nodes_next.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def action_min(nodes_next, state_cost, state_constr, d_fwd, tables):
    """One backward slice's action-min.

    nodes_next (S, DS, L, 4), state_cost / state_constr (S, DS, L),
    d_fwd (S, L, 7) (already less length_veh / 2), ``tables`` from
    :func:`make_tables`; all float32 (int32 shift tables), contiguous,
    on one device.  Returns (S, DS, L, 4) float32.
    """
    global launches
    _check(nodes_next, state_cost, state_constr, d_fwd, tables)
    dev = nodes_next.device
    if dev.type == "cpu":
        return action_min_reference(nodes_next, state_cost, state_constr,
                                    d_fwd, tables)
    if dev.type != "cuda":
        raise ValueError(f"action_min: unsupported device {dev}")
    if nodes_next.data_ptr() % 16:
        raise ValueError("nodes_next must be 16-byte aligned (float4 loads)")

    lib = _kernel()
    S, DS, L, _ = nodes_next.shape
    smem = lib.latlon_action_min_smem_bytes(DS)
    if smem > 48 * 1024:
        raise ValueError(f"ds_steps={DS} needs {smem} B of action tables, "
                         "above the 48 KB dynamic shared-memory default")
    out = torch.empty_like(nodes_next)
    ptrs = [t.data_ptr() for t in (nodes_next, state_cost, state_constr,
                                   d_fwd)]
    ptrs += [tables[k].data_ptr() for k in TABLE_KEYS]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.latlon_action_min(*ptrs, out.data_ptr(), S, DS, L, stream)
    if err != 0:
        raise RuntimeError(f"latlon_action_min launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("latlon_action_min")
        lib.latlon_action_min.restype = ctypes.c_int
        lib.latlon_action_min.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.latlon_action_min_smem_bytes.restype = ctypes.c_size_t
        lib.latlon_action_min_smem_bytes.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB
