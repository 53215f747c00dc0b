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
version :func:`action_min_reference` on a CPU tensor.
:func:`backward_slice_launch` launches the same source's fused kernel, which
also computes what the action-min consumes (the slice's state costs and
forward distances) per cell; the solve goes through it
(``lat_lon_kernel``'s ``backward_slice``).  It takes a batch of scenarios
in one launch, each with its own next nodes, distance map, reference line
and tables (:class:`BatchTables`); the scenario-batched solve goes through
it so (``lat_lon_kernel``'s ``solve.batch``, the counterpart of the JAX
package's vmap of the solve).  ``launches`` counts the launches of either
kernel, ``slice_launches`` those of the fused kernel for one scenario and
``batch_launches`` those for a batch.  The action tables are checked once,
where :func:`make_tables` makes them (:class:`Tables`).
"""

import ctypes

import numpy as np
import torch

from tpl_tpu_torch import _latency

NB = 7              # backward action samples per dimension
MAX_DS = 65535      # the kernel's grid has one block row per ds
# the batched kernel's resident blocks walk its work items, so a batch is
# bounded only by its int count (and by the card's memory)
MAX_BATCH = 2**31 - 1

# kernel launches since import (reset freely): every launch of the source's
# action-min, alone (action_min) or with the slice's producers fused in
# (backward_slice_launch), those of the fused kernel for one scenario and
# those for a scenario batch
launches = 0
slice_launches = 0
batch_launches = 0

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
# the per-solve scalars the fused backward slice reads beside the tables
# (enum SliceConst of csrc/latlon_action_min.cu): params and grid steps
SLICE_CONSTS = ("s_min", "s_step", "l_min", "l_step", "dt", "dt_start",
                "length_veh", "width_veh", "d_lat_comf", "l_trg", "w_l",
                "w_lat_dist", "w_progress", "t_st_min", "t_st_max", "s_st",
                "w_spatio_temporal")
REF_LINE_CHANNELS = 8
# the phases of the batched slice's profiling instantiation, in a work
# item's order (enum Phase of csrc/latlon_action_min.cu): waiting for the
# item's staged copies, issuing the next item's and preparing this one,
# the producers (reference row, l searches, state cost, forward
# distances), the 7 x 7 action loop, the store
SLICE_PHASES = ("wait", "stage", "producers", "actions", "store")


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
    scalars = dict(pp, s_step=s_step, l_step=l_step)
    slice_consts = torch.stack([scalars[k].reshape(()).to(torch.float32)
                                for k in SLICE_CONSTS])
    return Tables(dict(ids=ids.contiguous(), ks=ks.contiguous(), kl=kl,
                       ca=ca, schg=s_change, qdds=qdds, qdl=qdl,
                       dds_vals=dds_s, dl_vals=dl_s, dss=dss.contiguous(),
                       consts=consts), slice_consts)


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


# Operations of the fused slice beside its action-min, as the plain version
# (lat_lon_kernel.py slice_inputs) defines them.  Per cell: the two
# first-offset searches (per offset a comparison, a step of the first-true
# search and a step of the any-reduction, on each side), the bounds and the
# mid-lane target (4 + 13), the state cost's and constraint's terms (32).
# Per (s, l): 7 lookups, 6 running minima, 7 subtractions.  Per s: its grid
# value (2), the reference row's index (4) and the two lane bounds (3).  Per
# (l, dl): the swept l index (6).  Per ds: its grid value and mean distance
# (4).
SLICE_OPS = dict(cell_per_offset=6, cell=49, s_l=20, s=9, l_dl=6, ds=4)
# the fused cell's critical path beside the action-min's: the reference
# row's division, its load and the state cost's longest chain of terms
CHAIN_SLICE_CELL = dict(f32_div=1, smem_load=2, f32_add=12, f32_mul=4)


def slice_traffic_bytes(S, DS, L):
    """Bytes one fused slice must move: the next nodes, the slice's
    distance map, the S reference-line rows it looks up, the reference
    step, the slice constants and the action tables read once, the nodes
    written once (all 4-byte words)."""
    cells = S * DS * L
    tables = (3 * DS * NB + NB) + DS * NB * NB + DS * NB + 4 * NB + DS + 5
    return 4 * (4 * cells + S * L + S * REF_LINE_CHANNELS + 1
                + len(SLICE_CONSTS) + tables + 4 * cells)


def slice_operations(S, DS, L):
    """Operations of one fused slice: its action-min's and the producers'."""
    o = SLICE_OPS
    return (operations(S, DS, L)
            + S * DS * L * (o["cell_per_offset"] * L + o["cell"])
            + S * L * o["s_l"] + S * o["s"] + L * NB * o["l_dl"]
            + DS * o["ds"])


def slice_bound_ms(S, DS, L):
    """(ms, "bytes" or "operations"): the roofline bound of one fused
    slice."""
    return _latency.roofline_ms(slice_traffic_bytes(S, DS, L),
                                slice_operations(S, DS, L), "float32")


def batch_bound_ms(B, S, DS, L):
    """(ms, "bytes" or "operations"): the roofline bound of one batched
    slice of B scenarios, each with its own inputs: B fused slices' bytes
    and operations."""
    return _latency.roofline_ms(B * slice_traffic_bytes(S, DS, L),
                                B * slice_operations(S, DS, L), "float32")


def slice_chain_ms(cycles, sm_mhz):
    """The fused cell's critical path: the producers' chain, then the
    action-min's."""
    ops = _latency.add_ops(dict(CHAIN_CELL), CHAIN_SLICE_CELL, 1)
    return _latency.chain_ms(ops, cycles, sm_mhz)


def chain_ops():
    """Dependent operations on one cell's critical path (the cells are
    independent, so the slice's path is one cell's)."""
    return dict(CHAIN_CELL)


def chain_ms(cycles, sm_mhz):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(), cycles, sm_mhz)


class Tables(dict):
    """The action tables of one solve (the keys of :data:`TABLE_KEYS`),
    checked once when they are made: shapes, types, one device, contiguous.
    A launch then takes their device pointers from ``ptrs`` and checks only
    the per-slice tensors.  ``slice_consts`` holds the scalars of
    :data:`SLICE_CONSTS` for the fused backward slice (None where the tables
    were not made by :func:`make_tables`).  Read-only after construction."""

    def __init__(self, items, slice_consts=None):
        super().__init__(items)
        DS = self["dss"].shape[0]
        dev = self["dss"].device
        shapes = dict(ids=(DS, NB), ks=(DS, NB), kl=(NB,), ca=(DS, NB, NB),
                      schg=(DS, NB), qdds=(NB,), qdl=(NB,), dds_vals=(NB,),
                      dl_vals=(NB,), dss=(DS,), consts=(5,))
        for name in TABLE_KEYS:
            _check_tensor(name, self[name], shapes[name],
                          torch.int32 if name in _INT_TABLES
                          else torch.float32, dev)
        if slice_consts is not None:
            _check_tensor("slice_consts", slice_consts, (len(SLICE_CONSTS),),
                          torch.float32, dev)
        self.DS = DS
        self.device = dev
        self.ptrs = tuple(self[k].data_ptr() for k in TABLE_KEYS)
        self.slice_consts = slice_consts


class BatchTables(dict):
    """The action tables of B scenarios for the batched fused slice: each
    key of :data:`TABLE_KEYS` the scenarios' tables stacked, (B, ...), and
    ``slice_consts`` (B, len(SLICE_CONSTS)); ``tables`` keeps the
    per-scenario :class:`Tables` (the plain version's).  Made from tables
    of :func:`make_tables` on one grid and one device; read-only."""

    def __init__(self, tables):
        tables = list(tables)
        if not tables or len(tables) > MAX_BATCH:
            raise ValueError(f"a batch of 1 to {MAX_BATCH} scenarios, got "
                             f"{len(tables)}")
        first = tables[0]
        for t in tables:
            if not isinstance(t, Tables) or t.slice_consts is None:
                raise ValueError("the batched slice needs the tables of "
                                 "make_tables")
            if t.DS != first.DS or t.device != first.device:
                raise ValueError("the scenarios' tables differ in ds_steps "
                                 "or device")
        super().__init__({k: torch.stack([t[k] for t in tables])
                          for k in TABLE_KEYS})
        self.slice_consts = torch.stack([t.slice_consts for t in tables])
        self.tables = tables
        self.B = len(tables)
        self.DS = first.DS
        self.device = first.device
        self.ptrs = tuple(self[k].data_ptr() for k in TABLE_KEYS)


def _check_tensor(name, t, shape, dtype, dev):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} != {dtype}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(nodes_next, state_cost, state_constr, d_fwd, tables):
    """The per-slice tensors against the grid of ``nodes_next`` and the
    (already checked) tables; returns the tables as :class:`Tables`."""
    if nodes_next.dim() != 4 or nodes_next.shape[-1] != 4:
        raise ValueError(f"nodes_next must be (S, DS, L, 4), got "
                         f"{tuple(nodes_next.shape)}")
    if not isinstance(tables, Tables):
        tables = Tables(tables)
    S, DS, L, _ = nodes_next.shape
    dev = nodes_next.device
    f32 = torch.float32
    _check_tensor("nodes_next", nodes_next, (S, DS, L, 4), f32, dev)
    _check_tensor("state_cost", state_cost, (S, DS, L), f32, dev)
    _check_tensor("state_constr", state_constr, (S, DS, L), f32, dev)
    _check_tensor("d_fwd", d_fwd, (S, L, NB), f32, dev)
    if tables.DS != DS or tables.device != dev:
        raise ValueError(f"action tables for ds_steps={tables.DS} on "
                         f"{tables.device}, nodes_next has ds_steps={DS} on "
                         f"{dev}")
    return tables


def action_min(nodes_next, state_cost, state_constr, d_fwd, tables):
    """One backward slice's action-min.

    nodes_next (S, DS, L, 4), state_cost / state_constr (S, DS, L),
    d_fwd (S, L, 7) (already less length_veh / 2), ``tables`` from
    :func:`make_tables`; all float32 (int32 shift tables), contiguous,
    on one device.  Returns (S, DS, L, 4) float32.
    """
    global launches
    tables = _check(nodes_next, state_cost, state_constr, d_fwd, tables)
    dev = nodes_next.device
    if dev.type == "cpu":
        return action_min_reference(nodes_next, state_cost, state_constr,
                                    d_fwd, tables)
    if dev.type != "cuda":
        raise ValueError(f"action_min: unsupported device {dev}")
    if nodes_next.data_ptr() % 16:
        raise ValueError("nodes_next must be 16-byte aligned (16-byte copies)")

    lib = _kernel()
    S, DS, L, _ = nodes_next.shape
    if lib.latlon_action_min_tile_rows(L) < 1 or DS > MAX_DS:
        raise ValueError(f"l_steps={L}, ds_steps={DS}: the kernel takes one "
                         "thread per lateral cell (at most 1024) and one "
                         f"block row per ds (at most {MAX_DS})")
    out = torch.empty_like(nodes_next)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.latlon_action_min(
            nodes_next.data_ptr(), state_cost.data_ptr(),
            state_constr.data_ptr(), d_fwd.data_ptr(), *tables.ptrs,
            out.data_ptr(), S, DS, L, stream)
    if err != 0:
        raise RuntimeError(f"latlon_action_min launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def _slice_args(nodes_next, dist_t, ref_line, ref_step, i, tables):
    """The checked arguments of the fused slice entries (see
    :func:`backward_slice_launch`): (library, the entry's arguments before
    the stream, the output, B)."""
    dev = nodes_next.device
    if dev.type != "cuda":
        raise ValueError(f"backward_slice_launch: needs a CUDA device, got "
                         f"{dev}")
    if nodes_next.dim() != 5 or nodes_next.shape[-1] != 4:
        raise ValueError(f"nodes_next must be (B, S, DS, L, 4), got "
                         f"{tuple(nodes_next.shape)}")
    B, S, DS, L, _ = nodes_next.shape
    if isinstance(tables, BatchTables):
        n_tables = tables.B
    elif isinstance(tables, Tables) and tables.slice_consts is not None:
        n_tables = 1
    else:
        raise ValueError("the fused slice needs the tables of make_tables")
    if ref_line.dim() != 3:
        raise ValueError(f"ref_line must be (B, n, {REF_LINE_CHANNELS}), got "
                         f"{tuple(ref_line.shape)}")
    f32 = torch.float32
    _check_tensor("nodes_next", nodes_next, (B, S, DS, L, 4), f32, dev)
    _check_tensor("ref_line", ref_line,
                  (B, ref_line.shape[1], REF_LINE_CHANNELS), f32, dev)
    _check_tensor("ref_step", ref_step.reshape(1), (1,), f32, dev)
    if (tuple(dist_t.shape) != (B, S, L) or dist_t.dtype != f32
            or dist_t.device != dev or dist_t.stride()[1:] != (L, 1)
            or dist_t.stride(0) < S * L):
        raise ValueError(f"dist_t must be float32 (B, S, L) = {(B, S, L)} "
                         f"with contiguous rows on {dev}, got "
                         f"{tuple(dist_t.shape)} {dist_t.dtype} strides "
                         f"{dist_t.stride()} on {dist_t.device}")
    if n_tables != B or tables.DS != DS or tables.device != dev:
        raise ValueError(f"tables of {n_tables} scenarios with ds_steps="
                         f"{tables.DS} on {tables.device}, nodes_next has "
                         f"{B} with ds_steps={DS} on {dev}")
    if nodes_next.data_ptr() % 16:
        raise ValueError("nodes_next must be 16-byte aligned (16-byte copies)")
    lib = _kernel()
    if lib.latlon_backward_slice_grid(S, DS, L, B) < 1 \
            or ref_line.shape[1] < 1 or B > MAX_BATCH:
        raise ValueError(f"{B} scenarios, l_steps={L}, ds_steps={DS}, "
                         f"{ref_line.shape[1]} reference rows: outside what "
                         "the kernel takes")
    out = torch.empty_like(nodes_next)
    args = (nodes_next.data_ptr(), dist_t.data_ptr(), ref_line.data_ptr(),
            ref_step.data_ptr(), tables.slice_consts.data_ptr(),
            (ctypes.c_void_p * len(TABLE_KEYS))(*tables.ptrs),
            out.data_ptr(), S, DS, L, ref_line.shape[1], int(i), B,
            dist_t.stride(0))
    return lib, args, out, B


def backward_slice_launch(nodes_next, dist_t, ref_line, ref_step, i, tables):
    """Backward slice i of B scenarios on the card in one launch of the
    fused kernel: per cell the state cost and constraint and the forward
    distances (what ``lat_lon_kernel``'s ``slice_inputs`` computes with
    tensor operations) and the action-min, each scenario with its own
    inputs and tables and the bits of its own launch.

    nodes_next (B, S, DS, L, 4) contiguous; dist_t (B, S, L), each
    scenario's (S, L) rows contiguous (a slice ``dist_x[:, i]`` of the
    (B, T, S, L) maps is taken as it is, by its batch stride); ref_line
    (B, n, 8) contiguous, one row count for every scenario (a batch of
    reference lines stacked to one tensor has one); ref_step one element
    shared by the batch; ``tables`` the :class:`Tables` of
    :func:`make_tables` for one scenario or a :class:`BatchTables` of the
    B; float32, on one CUDA device.  Returns (B, S, DS, L, 4) float32.  One
    scenario runs the kernel's one-scenario instantiation and counts in
    ``slice_launches``, a batch the batched one and counts in
    ``batch_launches``.  Its plain version is the solver's
    ``backward_slice_reference`` (per scenario); a tensor that is not on a
    CUDA device raises.
    """
    global launches, slice_launches, batch_launches
    lib, args, out, B = _slice_args(nodes_next, dist_t, ref_line, ref_step,
                                    i, tables)
    with torch.cuda.device(out.device):
        err = lib.latlon_backward_slice(
            *args, torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"latlon_backward_slice launch failed: CUDA error "
                           f"{err}")
    launches += 1
    if B == 1:
        slice_launches += 1
    else:
        batch_launches += 1
    return out


def backward_slice_profile(nodes_next, dist_t, ref_line, ref_step, i,
                           tables):
    """:func:`backward_slice_launch` for a batch (B > 1) through the
    batched kernel's profiling instantiation (counted nowhere): the same
    nodes, and per phase of :data:`SLICE_PHASES` thread 0's clock cycles
    summed over the blocks, an int64 tensor on the card."""
    lib, args, out, B = _slice_args(nodes_next, dist_t, ref_line, ref_step,
                                    i, tables)
    if B < 2:
        raise ValueError("the profiling instantiation is the batched one")
    prof = torch.zeros(len(SLICE_PHASES), dtype=torch.int64,
                       device=out.device)
    with torch.cuda.device(out.device):
        err = lib.latlon_backward_slice_profile(
            *args, prof.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"latlon_backward_slice_profile launch failed: "
                           f"CUDA error {err}")
    return out, prof


def slice_kernel_attributes():
    """{kernel: (numRegs, localSizeBytes)} of the fused slice's kernels at
    FEW_THREADS, from cudaFuncGetAttributes."""
    lib = _kernel()
    res = {}
    for which, name in enumerate(("one-scenario", "batched",
                                  "batched profiling")):
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = lib.latlon_backward_slice_attributes(
            which, ctypes.byref(regs), ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes: CUDA error {err}")
        res[name] = (regs.value, local.value)
    return res


_LIB = None


def _kernel():
    """Build (first call) and bind the kernel library, and load its code
    onto the current device with its shared-memory limits raised, so that
    the first launch does not pay for it."""
    global _LIB
    if _LIB is None:
        from tpl_tpu_torch import _build

        lib = _build.load("latlon_action_min")
        lib.latlon_action_min.restype = ctypes.c_int
        lib.latlon_action_min.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.latlon_action_min_tiled.restype = ctypes.c_int
        lib.latlon_action_min_tiled.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.latlon_action_min_tile_rows.restype = ctypes.c_int
        lib.latlon_action_min_tile_rows.argtypes = [ctypes.c_int]
        lib.latlon_backward_slice.restype = ctypes.c_int
        lib.latlon_backward_slice.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_longlong, ctypes.c_void_p])
        lib.latlon_backward_slice_profile.restype = ctypes.c_int
        lib.latlon_backward_slice_profile.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
        lib.latlon_backward_slice_grid.restype = ctypes.c_int
        lib.latlon_backward_slice_grid.argtypes = [ctypes.c_int] * 4
        lib.latlon_backward_slice_attributes.restype = ctypes.c_int
        lib.latlon_backward_slice_attributes.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 2)
        if lib.latlon_n_slice_consts() != len(SLICE_CONSTS) or \
                lib.latlon_backward_slice_n_phases() != len(SLICE_PHASES):
            raise RuntimeError("latlon_action_min.cu and SLICE_CONSTS / "
                               "SLICE_PHASES disagree")
        lib.latlon_empty_launch.restype = ctypes.c_int
        lib.latlon_empty_launch.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.latlon_action_min_prepare.restype = ctypes.c_int
        lib.latlon_action_min_prepare.argtypes = []
        _build.prepare(lib, "latlon_action_min")
        _LIB = lib
    return _LIB
