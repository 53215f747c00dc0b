"""
One full AL-iLQR update of any problem with a problem struct, as one kernel:
a block an instance (the single solve, and a batch that fits on the card a
block an instance at once), or resident warps an instance (a larger
batch).

The kernel body ``csrc/ilqr_generic_body.cuh`` is a template over a problem
struct (sizes, dynamics, cost, end cost, constraints), the real type and
the integrator; it runs :func:`tpl_tpu_torch.optim.ilqr.make_update_fn`'s
algorithm.  Two kinds of struct reach it:

- the native problems without a kernel of their own
  (``ref_line_smoother_k``, ``ref_line_smoother_dk``,
  ``velocity_profile_time``), the two tracking MPCs
  (``trajectory_tracking_mpc``, ``trajectory_tracking_mpc_time``: a solve
  beyond their own kernels' horizons, and the time-indexed one's batch)
  and, for a batch, the RSTP profiles (``lateral_profile``,
  ``velocity_profile_space``), written by hand in ``csrc/ilqr_generic.cu``
  (:data:`NATIVE`);
- every sympy config of :mod:`tpl_tpu_torch.optim.genopt`, whose printer
  writes the struct and a source that includes the body, built by ``nvcc``
  at first use into ``build/tpl_tpu_torch/`` (:class:`Spec` with a
  ``struct``), and every other torch problem, traced into the same
  printer by :mod:`tpl_tpu_torch.optim.trace` (:func:`spec_of` with the
  params' kinds).

The JAX package compiled each of these problems to one XLA program
(``tpl_tpu/optim/ilqr.py:126`` make_update_fn, single, and
``tpl_tpu/optim/batched.py:30`` make_batched_update_fn, batched); there is
no Pallas kernel for them.

Layouts: a batch packs a part every instance shares (:func:`shared_layout`:
the control limits, barrier weights and multiplier limits, dt and the stop
threshold, the line-search steps, the tables) once and a row per instance
(:func:`row_layout`: x0, u, lam, the scalar params, mu_step); a single
update is a batch of one, its packed input the shared part followed by its
row (:func:`input_layout`).  :func:`update` takes that input: on a CUDA
tensor it launches the kernel (one launch, counted in ``launches``), on a
CPU tensor it runs the plain version :func:`update_reference`, the plain
``make_update_fn``.  :func:`update_batched` is the batched update of
:mod:`tpl_tpu_torch.optim.batched` on CUDA tensors (pack, one launch,
unpack); :func:`launch` the bare launcher.  The launcher picks the
geometry on the host (:func:`geometry`): a block an instance while the card
holds every instance's block at once, else resident warps, a block's warps
walking the instances.  :func:`profile` runs the profiling instantiation
(the same bits, cycles per phase of instance 0).  :func:`split` states how
many bytes of a block's (or, for a batch, a resident slot's) arrays sit in
shared memory and how many in the launch's global workspace;
:func:`attributes` a kernel's registers and spill bytes.  :func:`bound_ms`
and :func:`chain_ms` state the kernel's two bounds from shapes and
iteration counts, :func:`design_floor_ms` the resident geometry's least
time.
"""

import ctypes
import dataclasses

import numpy as np
import torch

from tpl_tpu_torch import _latency
from tpl_tpu_torch.optim import ilqr, problems

# the dynamic shared memory a block can use on an H100
SMEM_LIMIT = 227 * 1024

launches = 0        # kernel launches since import, single and batched
by_problem = {}     # the same, by problem name


@dataclasses.dataclass(frozen=True, eq=False)
class Spec:
    """What the kernel needs to know of a problem: its sizes, its scalar
    params and tables in the struct's order, its operation counts (for the
    bounds) and, for a sympy config, the struct's source.

    ``ops`` counts the operations of one evaluation of ``dynamics``,
    ``cost``, ``constraints`` and ``end_cost`` (an add, multiply, divide,
    compare, lookup or transcendental each one, as the plain version
    evaluates them); ``dyn_chain`` the dependent operations of the longest
    path through the dynamics, by the latency probe's names without the
    precision prefix (``add``, ``mul``, ``div``, ``sin``, ``cos``,
    ``atan``, ``smem_load``).  A sympy config's spec carries the struct
    its printer wrote (``struct``, named ``struct_name``), as does a torch
    problem's traced by :mod:`.trace`; a native problem's has none.  A
    traced problem's captured tensors are ``consts``, its constant tables
    (float64, one after another at the offsets its struct reads them at;
    None without any): the launcher uploads them once for each device and
    dtype (:func:`consts_on`)."""

    name: str
    nx: int
    nu: int
    nc: int
    scalars: tuple
    tables: tuple
    ops: dict
    dyn_chain: dict
    id: int = 0
    problem: object = None      # the plain version's Problem
    struct: str = None
    struct_name: str = None
    consts: object = None

    @property
    def ncl(self):
        return max(self.nc, 1)


def _native(name, id, scalars, tables, ops, dyn_chain):
    prob, _ = getattr(problems, name)()
    return Spec(name, prob.nx, prob.nu, prob.nc, scalars, tables, ops,
                dyn_chain, id=id, problem=prob)


# Operation counts of one evaluation, as problems.py writes the functions
# (a lookup counted as its 6 operations: the division, floor, ceil, alpha,
# the difference and the blend).
NATIVE = {s.name: s for s in (
    _native("ref_line_smoother_k", 0, ("w_pos", "w_k", "ref_step"),
            ("ref_x", "ref_y"),
            dict(dynamics=2, cost=2 * 6 + 1 + 10, constraints=0, end_cost=0),
            dict(cos=1)),
    _native("ref_line_smoother_dk", 1,
            ("w_pos", "w_k", "w_dk", "s_start", "ref_step"),
            ("ref_x", "ref_y"),
            dict(dynamics=2, cost=2 * 6 + 2 + 14, constraints=0, end_cost=0),
            dict(cos=1)),
    _native("velocity_profile_time", 2, ("w_v", "w_a", "ref_step"),
            ("ref_v", "ref_s_max", "ref_s_min"),
            dict(dynamics=0, cost=5, constraints=6 + 2 * 3 + 6, end_cost=0),
            {}),
    _native("lateral_profile", 3, ("ref_step", "w_d", "w_v_d", "w_a_d",
                                   "w_k"),
            ("k_ref", "d_offset", "d_lower_constr", "d_upper_constr"),
            dict(dynamics=0, cost=4 * 6 + 20, constraints=2 * 6 + 2,
                 end_cost=6 + 7),
            {}),
    _native("velocity_profile_space", 4, ("p_v", "p_a", "max_a_total",
                                          "ref_step"),
            ("ref_v", "ref_k", "ref_t_max", "ref_t_min", "ref_t_offset",
             "ref_v_weight"),
            dict(dynamics=3 + 3, cost=2 * 6 + 7, constraints=3 * 6 + 2 * 3
                 + 16, end_cost=0),
            dict(div=1)),
    # the course's four lookups at s_r (6 each) and its heading's (6 and
    # the angle distance's 4), phi_dot 7, d_r 7, s_dot 6, the rest 5; the
    # cost takes them again with the speed target's lookup and 29 more
    _native("trajectory_tracking_mpc", 5,
            ("pd", "pv", "pdelta", "min_pdelta_dot", "pdelta_dot",
             "min_p_phi_dot", "p_phi_dot", "p_phi", "p_phi_ref_dot_diff",
             "pa", "pj", "l", "v_ch", "ref_step", "max_delta", "max_acc",
             "min_acc", "a_offset"),
            ("ref_x", "ref_y", "ref_phi", "ref_k", "ref_v"),
            dict(dynamics=4 * 6 + 10 + 7 + 7 + 6 + 5,
                 cost=4 * 6 + 10 + 7 + 7 + 6 + 6 + 29, constraints=4,
                 end_cost=0),
            dict(div=3, fmod=1, cos=1, mul=2, add=4)),
    # the slip angle (tan, atan) and phi_dot 8, the rest 8; the cost: the
    # time 2, four lookups at it (6 each, the heading's angle distance 4),
    # phi_dot again and 30 more
    _native("trajectory_tracking_mpc_time", 6,
            ("pd", "pv", "pdelta", "min_pdelta_dot", "pdelta_dot",
             "min_p_phi_dot", "p_phi_dot", "p_phi", "pa", "pj", "l", "v_ch",
             "cog_pos", "ref_dt", "ref_t_offset", "max_delta", "max_acc",
             "min_acc", "a_offset"),
            ("ref_x", "ref_y", "ref_phi", "ref_v"),
            dict(dynamics=2 + 8 + 8, cost=2 + 4 * 6 + 4 + 10 + 30,
                 constraints=4, end_cost=0),
            dict(tan=1, atan=1, cos=2, mul=2, div=1)))}


def spec_of(prob, kinds=None):
    """The :class:`Spec` of a problem the kernel solves: a sympy config's
    generated one, a native problem's by its ``kernel`` key, or, given the
    params' ``(name, is_table)`` pairs ``kinds``, a torch problem's traced
    (:func:`tpl_tpu_torch.optim.trace.spec`, which raises ``Untraceable``
    for a problem it refuses); else None."""
    if getattr(prob, "generated", None) is not None:
        return prob.generated
    if prob.kernel is not None or kinds is None:
        return NATIVE.get(prob.kernel)
    # imported here: trace prints through genopt, which imports this module
    from tpl_tpu_torch.optim import trace

    return trace.spec(prob, kinds)


def _spec(spec):
    if isinstance(spec, Spec):
        return spec
    try:
        return NATIVE[spec]
    except KeyError:
        raise ValueError(f"ilqr_generic: no kernel for problem {spec!r}")


# ---------------------------------------------------------------------
# layouts

def shared_layout(spec, H, n_ref):
    """(name, shape) of the part of a batch every instance shares."""
    s = _spec(spec)
    return [("u_lims", (H, s.nu, 2)), ("bw_lim", (s.ncl, 2)),
            ("cfg_f", (2,)), ("alphas", (len(ilqr.ALPHAS),)),
            ("tables", (len(s.tables), n_ref))]


def row_layout(spec, H):
    """(name, shape) of one instance's row."""
    s = _spec(spec)
    return [("x0", (s.nx,)), ("u", (H, s.nu)), ("lam", (H, s.ncl)),
            ("scalars", (len(s.scalars),)), ("mu_step", (1,))]


def input_layout(spec, H, n_ref):
    """(name, shape) of a single update's packed input: the shared part,
    then the row."""
    return shared_layout(spec, H, n_ref) + row_layout(spec, H)


def output_layout(spec, H):
    """(name, shape) of one instance's packed result; ``tail`` is (mu_step,
    traj_costs, iterations)."""
    s = _spec(spec)
    return [("x", (H + 1, s.nx)), ("u", (H, s.nu)), ("lam", (H, s.ncl)),
            ("tail", (3,))]


def _size(layout):
    return ilqr.layout(layout)[1]


def n_ref_of(spec, params):
    """The tables' capacity (0 without tables); every table must have
    it."""
    s = _spec(spec)
    sizes = {int(np.shape(params[n])[-1]) for n in s.tables}
    if len(sizes) > 1:
        raise ValueError(f"{s.name}: the tables differ in capacity: {sizes}")
    return sizes.pop() if sizes else 0


def _check_mu_step(mu_step):
    if not 0 <= int(mu_step) <= 7:
        raise ValueError(f"mu_step {mu_step} outside the schedule's 0..7")


def pack_inputs(spec, inputs, params, mu_step, dtype=torch.float64):
    """One host buffer of ``dtype`` from the solver inputs (name -> array:
    x, u, lam, u_lims, bw_lim, cfg_f; x0 is x[0]), the params (name ->
    value) and the integer ``mu_step``."""
    s = _spec(spec)
    _check_mu_step(mu_step)
    H = inputs["u"].shape[0]
    n_ref = n_ref_of(s, params)
    arrays = dict(inputs, x0=np.asarray(inputs["x"])[0], alphas=ilqr.ALPHAS,
                  scalars=[params[n] for n in s.scalars],
                  tables=np.reshape([params[n] for n in s.tables],
                                    (len(s.tables), n_ref)),
                  mu_step=[float(mu_step)])
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return np.concatenate(
        [np.asarray(arrays[k], np.float64).astype(np_dtype).reshape(-1)
         for k, _ in input_layout(s, H, n_ref)])


def unpack_outputs(spec, out, H):
    """Dict of x, u, lam, mu_step, traj_costs and iterations from a packed
    result (numpy or tensor)."""
    v = ilqr.unpack(out, ilqr.layout(output_layout(spec, H))[0])
    mu_step, traj_costs, iterations = (float(a) for a in v.pop("tail"))
    return dict(v, mu_step=int(mu_step), traj_costs=traj_costs,
                iterations=int(iterations))


def pack_inputs_batched(spec, x, u, lam, mu_step, x0, params, cfg,
                        dtype=torch.float64, per_instance=()):
    """``(shared, rows)`` of a batch on the device of ``x``: the shared part
    ``(n_shared,)`` and the ``(B, n_row)`` rows.  ``x``, ``u``, ``lam``,
    ``x0`` carry the batch last (``tpl_tpu_torch.optim.batched``); a
    scalar param is shared or, named in ``per_instance``, ``(B,)``; the
    tables are shared.  Tensor operations, no loop over the instances."""
    s = _spec(spec)
    dev, B, H = x.device, x.shape[-1], u.shape[0]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    n_ref = n_ref_of(s, params)
    for n in s.tables:
        if tuple(params[n].shape) != (n_ref,):
            raise ValueError(f"the table {n} is shared across the batch: "
                             f"expected ({n_ref},), got "
                             f"{tuple(params[n].shape)}")
    tables = (torch.stack([t(params[n]) for n in s.tables]) if s.tables
              else torch.zeros((0, 0), dtype=dtype, device=dev))
    shared = dict(
        u_lims=torch.stack([t(cfg["u_min"]), t(cfg["u_max"])], -1),
        bw_lim=torch.stack([t(cfg["barrier_weight"]).reshape(s.ncl),
                            t(cfg["lg_mult_limit"]).reshape(s.ncl)], -1),
        cfg_f=torch.stack([t(cfg["dt"]).reshape(()),
                           t(cfg["min_rel_cost_change"]).reshape(())]),
        alphas=t(ilqr.ALPHAS), tables=tables)
    scal = [t(params[n]).reshape(B if n in per_instance else ()).expand(B)
            for n in s.scalars]
    rows = dict(
        x0=t(x0).T, u=t(u).movedim(-1, 0), lam=t(lam).movedim(-1, 0),
        scalars=(torch.stack(scal, 1) if scal
                 else torch.zeros((B, 0), dtype=dtype, device=dev)),
        mu_step=t(mu_step.clamp(0, 7)).reshape(B, 1))
    for name, shape in shared_layout(s, H, n_ref):
        if tuple(shared[name].shape) != shape:
            raise ValueError(f"{name} is shared across the batch: expected "
                             f"{shape}, got {tuple(shared[name].shape)}")
    for name, shape in row_layout(s, H):
        if tuple(rows[name].shape) != (B,) + shape:
            raise ValueError(f"{name} must be {(B,) + shape} batch first, "
                             f"got {tuple(rows[name].shape)}")
    return (torch.cat([shared[n].reshape(-1)
                       for n, _ in shared_layout(s, H, n_ref)]),
            torch.cat([rows[n].reshape(B, -1) for n, _ in row_layout(s, H)],
                      1).contiguous())


def rows_of_batch(shared, rows):
    """The ``(B, n_in)`` inputs of single updates, a row per instance: what a
    single launch on instance b takes."""
    B = rows.shape[0]
    return torch.cat([shared.reshape(1, -1).expand(B, -1), rows], 1)


def unpack_outputs_batched(spec, out, H, mu_dtype=torch.int32):
    """``(xs, u, lam, mu_step, traj_costs, iterations)`` of a ``(B,
    n_out)`` packed result, the batch last as the batched update returns
    it."""
    B = out.shape[0]
    offs, _ = ilqr.layout(output_layout(spec, H))
    v = {name: out[:, off:off + int(np.prod(shape))].reshape((B,) + shape)
         for name, (off, shape) in offs.items()}
    tail = v["tail"]
    return (v["x"].movedim(0, -1), v["u"].movedim(0, -1),
            v["lam"].movedim(0, -1), tail[:, 0].to(mu_dtype), tail[:, 1],
            tail[:, 2].to(torch.int64))


# ---------------------------------------------------------------------
# the launches

def _check(spec, buf, H, n_ref, integrator):
    n = _size(input_layout(spec, H, n_ref))
    if (buf.dtype not in (torch.float32, torch.float64) or buf.dim() != 1
            or buf.numel() != n):
        raise ValueError(f"packed input must be a float32 or float64 vector "
                         f"of {n}, got {buf.dtype} {tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("packed input must be contiguous")
    if integrator not in (ilqr.EULER, ilqr.HEUN, ilqr.RK4):
        raise ValueError(f"unknown integrator {integrator}")


def update(spec, buf, H, n_ref, T, max_iterations, max_lg_iterations,
           integrator=ilqr.EULER, smem_limit=SMEM_LIMIT):
    """One update from the packed inputs ``buf`` (float32 or float64, on
    the solve's device); returns the packed result on the same device.
    ``smem_limit`` caps the block's shared memory (the arrays beyond it lie
    in the global workspace)."""
    s = _spec(spec)
    _check(s, buf, H, n_ref, integrator)
    if buf.device.type == "cpu":
        return update_reference(s, buf, H, n_ref, T, max_iterations,
                                max_lg_iterations, integrator)
    n_sh = _size(shared_layout(s, H, n_ref))
    return launch(s, buf[:n_sh], buf[n_sh:].reshape(1, -1), H, n_ref, T,
                  max_iterations, max_lg_iterations, integrator,
                  smem_limit=smem_limit)[0]


def profile(spec, buf, H, n_ref, T, max_iterations, max_lg_iterations,
            integrator=ilqr.EULER):
    """:func:`update` through the profiling instantiation (CUDA only):
    returns the packed result, bit-equal to :func:`update`'s, and thread
    0's cycles per phase, a dict over ``ilqr.PHASES`` (sums over the
    solve)."""
    s = _spec(spec)
    _check(s, buf, H, n_ref, integrator)
    n_sh = _size(shared_layout(s, H, n_ref))
    out, cycles = profile_batch(s, buf[:n_sh], buf[n_sh:].reshape(1, -1), H,
                                n_ref, T, max_iterations, max_lg_iterations,
                                integrator)
    return out[0], cycles


def profile_batch(spec, shared, rows, H, n_ref, T, max_iterations,
                  max_lg_iterations=1, integrator=ilqr.EULER):
    """:func:`launch` through the profiling instantiation: the ``(B,
    n_out)`` results, bit-equal to the normal launch's, and the cycles per
    phase of the thread that solves instance 0 (the block geometry: its
    block's thread 0; resident warps: lane 0 of the warp that takes it), a
    dict over ``ilqr.PHASES``."""
    cycles = torch.zeros(len(ilqr.PHASES), dtype=torch.int64,
                         device=rows.device)
    out = launch(spec, shared, rows, H, n_ref, T, max_iterations,
                 max_lg_iterations, integrator, cycles)
    return out, dict(zip(ilqr.PHASES, cycles.cpu().tolist()))


GEOMETRY = ("resident", "slots", "blocks", "per_sm", "smem", "cap",
            "unit_ws", "units")


def geometry(spec, B, H, n_ref, dtype=torch.float64, smem_limit=SMEM_LIMIT,
             prof=False):
    """The geometry a launch of ``B`` instances takes on the current CUDA
    device, chosen by the source's launcher: ``resident`` 0 (a block of 256
    threads an instance, ``blocks`` = B) or 1 (``blocks`` blocks of
    ``slots`` warps, a warp an instance at a time); ``per_sm`` blocks an SM
    (the occupancy calculator's), ``smem`` bytes of dynamic shared memory a
    block, ``cap`` words of it for a block's (resident: a slot's) arrays,
    ``unit_ws`` words of workspace a block (slot) and ``units`` blocks
    (slots) in all; ``prof``: the profiling instantiation's (its registers
    may allow fewer warps an SM)."""
    s = _spec(spec)
    lib, f64 = _kernel(s, dtype), int(dtype == torch.float64)
    out = (ctypes.c_longlong * len(GEOMETRY))()
    err = lib.ilqr_generic_geometry(s.id, f64, int(prof), B, H, n_ref,
                                    smem_limit, out)
    if err != 0:
        raise RuntimeError(f"ilqr_generic geometry ({s.name}) failed: CUDA "
                           f"error {err}")
    return dict(zip(GEOMETRY, out))


def split(spec, H, n_ref, dtype=torch.float64, smem_limit=SMEM_LIMIT,
          B=None):
    """``(shared_bytes, workspace_bytes)``, computed by the source's own
    carve: a block's bytes of shared memory and of the launch's global
    workspace (the arrays that do not fit); with ``B``, those of the unit
    of the geometry a launch of B instances takes (a block, or a resident
    slot: one warp's instance, its shared part held once a block)."""
    s = _spec(spec)
    lib, f64 = _kernel(s, dtype), int(dtype == torch.float64)
    size = torch.empty((), dtype=dtype).element_size()
    if B is not None:
        g = geometry(s, B, H, n_ref, dtype, smem_limit)
        if g["resident"]:
            return (size * lib.ilqr_generic_slot_split(s.id, f64, H, n_ref,
                                                       g["cap"], 0),
                    size * g["unit_ws"])
    return tuple(size * lib.ilqr_generic_split(s.id, f64, H, n_ref,
                                               smem_limit, which)
                 for which in (0, 1))


def attributes(spec, dtype=torch.float64, resident=False, prof=False):
    """``(registers, local_bytes, static_shared_bytes)`` of a kernel of the
    problem's source (the block geometry's, or the resident one's; each
    serves every integrator; ``prof`` the profiling instantiation)."""
    s = _spec(spec)
    lib, f64 = _kernel(s, dtype), int(dtype == torch.float64)
    out = (ctypes.c_longlong * 3)()
    err = lib.ilqr_generic_attributes(s.id, f64, int(resident), int(prof),
                                      out)
    if err != 0:
        raise RuntimeError(f"ilqr_generic attributes ({s.name}) failed: "
                           f"CUDA error {err}")
    return tuple(out)


_CONSTS = {}


def consts_on(spec, device, dtype):
    """The constant tables of ``spec`` as a tensor on ``device`` in
    ``dtype``, uploaded at the first call for each (device, dtype) and kept;
    None for a spec without any."""
    s = _spec(spec)
    if s.consts is None:
        return None
    key = (id(s), str(device), dtype)
    if key not in _CONSTS:
        _CONSTS[key] = (s, torch.as_tensor(s.consts, dtype=dtype,
                                           device=device))
    return _CONSTS[key][1]


def _consts_ptr(s, rows):
    c = consts_on(s, rows.device, rows.dtype)
    return None if c is None else c.data_ptr()


def _prepare_launch(s, shared, rows, H, n_ref, integrator, smem_limit,
                    prof=False):
    """Checks what a launch takes (``shared`` ``(n_shared,)`` and ``rows``
    ``(B, n_row)`` of one dtype on one CUDA device) and makes its output
    and the workspace of its geometry: (library, f64 flag, out,
    workspace)."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"ilqr_generic: the kernel runs on CUDA tensors, "
                         f"got {dev}")
    if rows.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"no kernel for {rows.dtype}")
    n_sh, n_row = (_size(shared_layout(s, H, n_ref)),
                   _size(row_layout(s, H)))
    if rows.dim() != 2 or rows.shape[1] != n_row or not rows.is_contiguous():
        raise ValueError(f"the rows must be a contiguous (B, {n_row}) "
                         f"tensor, got {tuple(rows.shape)}")
    if (tuple(shared.shape) != (n_sh,) or shared.dtype != rows.dtype
            or shared.device != dev or not shared.is_contiguous()):
        raise ValueError(f"the shared part must be a contiguous ({n_sh},) "
                         f"{rows.dtype} tensor on {dev}")
    if integrator not in (ilqr.EULER, ilqr.HEUN, ilqr.RK4):
        raise ValueError(f"unknown integrator {integrator}")
    B = rows.shape[0]
    lib, f64 = _kernel(s, rows.dtype), int(rows.dtype == torch.float64)
    with torch.cuda.device(dev):
        g = geometry(s, B, H, n_ref, rows.dtype, smem_limit, prof)
    out = torch.empty((B, _size(output_layout(s, H))), dtype=rows.dtype,
                      device=dev)
    ws = torch.empty(max(g["units"] * g["unit_ws"], 1), dtype=rows.dtype,
                     device=dev)
    return lib, f64, out, ws


def launch(spec, shared, rows, H, n_ref, T, max_iterations,
           max_lg_iterations=1, integrator=ilqr.EULER, cycles=None,
           smem_limit=SMEM_LIMIT):
    """The launcher the wrappers call: ``shared`` ``(n_shared,)`` and
    ``rows`` ``(B, n_row)`` of one dtype on one CUDA device, one launch in
    the geometry :func:`geometry` picks (counted in ``launches``); returns
    the ``(B, n_out)`` packed results.  With ``cycles`` (int64,
    ``len(ilqr.PHASES)``, zeros) the profiling instantiation runs and adds
    instance 0's cycles to it.  A block keeps at most ``smem_limit`` bytes
    in shared memory (:func:`split`)."""
    global launches
    s = _spec(spec)
    lib, f64, out, ws = _prepare_launch(s, shared, rows, H, n_ref,
                                        integrator, smem_limit,
                                        cycles is not None)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.ilqr_generic_update_consts(
            s.id, f64, int(integrator), shared.data_ptr(), rows.data_ptr(),
            out.data_ptr(), ws.data_ptr(),
            None if cycles is None else cycles.data_ptr(), rows.shape[0],
            H, n_ref, int(T), int(max_iterations), int(max_lg_iterations),
            smem_limit, stream, _consts_ptr(s, rows))
    if err != 0:
        raise RuntimeError(f"ilqr_generic launch ({s.name}) failed: CUDA "
                           f"error {err}")
    launches += 1
    by_problem[s.name] = by_problem.get(s.name, 0) + 1
    return out


def bare(spec, shared, rows, H, n_ref, T, max_iterations,
         max_lg_iterations=1, integrator=ilqr.EULER, smem_limit=SMEM_LIMIT):
    """The bare launcher, for timing: a callable that launches the kernel on
    ``shared`` / ``rows`` (checked as :func:`launch` checks them) into an
    output and a workspace made once and returns the CUDA error code.  It
    is not the wrapper and adds nothing to ``launches``."""
    s = _spec(spec)
    lib, f64, out, ws = _prepare_launch(s, shared, rows, H, n_ref,
                                        integrator, smem_limit)
    args = (s.id, f64, int(integrator), shared.data_ptr(), rows.data_ptr(),
            out.data_ptr(), ws.data_ptr(), None, rows.shape[0], H, n_ref,
            int(T), int(max_iterations), int(max_lg_iterations), smem_limit,
            torch.cuda.current_stream(rows.device).cuda_stream,
            _consts_ptr(s, rows))
    return lambda: lib.ilqr_generic_update_consts(*args)


def update_batched(spec, x, u, lam, mu_step, x0, params, cfg,
                   integrator=ilqr.EULER, dtype=torch.float64,
                   per_instance=()):
    """The batched update of ``tpl_tpu_torch.optim.batched`` on CUDA
    tensors: pack, one launch, unpack.  Returns ``(xs, u, lam, mu_step,
    traj_costs, iterations)``, the batch last."""
    s = _spec(spec)
    H = u.shape[0]
    shared, rows = pack_inputs_batched(s, x, u, lam, mu_step, x0, params,
                                       cfg, dtype, per_instance)
    n_ref = n_ref_of(s, params)
    out = launch(s, shared, rows, H, n_ref, int(cfg["T"]),
                 int(cfg["max_iterations"]),
                 int(cfg.get("max_lg_iterations", 1)), integrator)
    return unpack_outputs_batched(s, out, H, mu_step.dtype)


# ---------------------------------------------------------------------
# the plain version

_PLAIN = {}


def update_reference(spec, buf, H, n_ref, T, max_iterations,
                     max_lg_iterations, integrator=ilqr.EULER):
    """The plain PyTorch update (``make_update_fn`` in the dtype of
    ``buf``) on the device of ``buf``, with the packed input and result of
    :func:`update`."""
    s = _spec(spec)
    _check(s, buf, H, n_ref, integrator)
    key = (id(s), H, integrator, buf.dtype)
    if key not in _PLAIN:
        _PLAIN[key] = (s, ilqr.make_update_fn(s.problem, H, integrator,
                                              dtype=buf.dtype))
    v = ilqr.unpack(buf, ilqr.layout(input_layout(s, H, n_ref))[0])
    mu_step = int(v["mu_step"][0])
    _check_mu_step(mu_step)
    params = {n: v["scalars"][i] for i, n in enumerate(s.scalars)}
    params.update({n: v["tables"][i] for i, n in enumerate(s.tables)})
    cfg = ilqr.packed_cfg(v["u_lims"], v["bw_lim"], v["cfg_f"], T,
                          max_iterations, max_lg_iterations)
    x = torch.zeros((H + 1, s.nx), dtype=buf.dtype, device=buf.device)
    state = ilqr.SolverState(x, v["u"], v["lam"], mu_step)
    new, info = _PLAIN[key][1](state, v["x0"], params, cfg)
    count = lambda n: torch.full((1,), float(n), dtype=buf.dtype,
                                 device=buf.device)
    return torch.cat([new.x.reshape(-1), new.u.reshape(-1),
                      new.lam.reshape(-1), count(new.mu_step),
                      info["traj_costs"].reshape(1),
                      count(info["iterations"])])


def solve(spec, inputs, params, T, max_iterations, max_lg_iterations,
          mu_step, integrator, device, dtype=torch.float64):
    """One :class:`~tpl_tpu_torch.optim.solver.Solver` update: pack the
    inputs and params (names -> host arrays), one upload to ``device``,
    :func:`update`, one download; returns :func:`unpack_outputs`."""
    s = _spec(spec)
    H = inputs["u"].shape[0]
    buf = torch.from_numpy(pack_inputs(s, inputs, params, mu_step, dtype))
    out = update(s, buf.to(device), H, n_ref_of(s, params), T,
                 max_iterations, max_lg_iterations, integrator)
    return unpack_outputs(s, out.cpu().numpy().astype(np.float64), H)


# ---------------------------------------------------------------------
# bounds

def step_ops(spec, integrator=ilqr.EULER):
    """Operations of one step of each part of the algorithm, as the plain
    version defines them: the closed-loop rollout step (its feedback, clamp,
    the integrator's dynamics evaluations and combinations), the augmented
    step cost, one Riccati step, the derivatives of one step (one pass over
    the dynamics and the step cost and one operation an entry of the
    block) and the multiplier update."""
    s = _spec(spec)
    nx, nu, nc = s.nx, s.nu, s.nc
    nv = nx + nu
    stages = {ilqr.EULER: 1, ilqr.HEUN: 2, ilqr.RK4: 4}[integrator]
    dyn = stages * s.ops["dynamics"] + 2 * nx * stages + nx
    step_cost = s.ops["cost"] + s.ops["constraints"] + 5 * nc
    solve_ops = (nx + 4 if nu == 1 else 8 + 4 * nx if nu == 2
                 else nu ** 3 + 2 * nu * nu * (nx + 1))
    riccati = (2 * nx * nx + 2 * nu * nx + 4 * nx ** 3 + nx * nx
               + 2 * nu * nx * nx + 2 * nu * nu * nx + nu * nu
               + 2 * nu * nx * nx + nu * nx + solve_ops + 4 * nu
               + 2 * nx * nu * nu + 6 * nu * nx * nx + 3 * nx * nx
               + 6 * nu * nx + 3 * nx)
    return dict(
        open_rollout_step=dyn,
        rollout_step=dyn + nu * (2 * nx + 4),
        step_cost=step_cost, riccati_step=riccati,
        derivatives=(s.ops["dynamics"] + step_cost + nv
                     + nv * (nv + 1) // 2 + nx * nv),
        multipliers=s.ops["constraints"] + 4 * s.ncl)


def operations(spec, H, T, iterations, max_lg_iterations=1,
               integrator=ilqr.EULER):
    """Operations of one update that ran ``iterations`` iLQR iterations in
    all: the initial rollout and its cost, the multiplier updates, and per
    iteration the derivatives, the Riccati pass, 8 rollouts with their step
    costs and the 8 ordered sums."""
    o = step_ops(spec, integrator)
    n = min(T, H)
    init = n * (o["open_rollout_step"] + o["step_cost"] + 1)
    per_it = n * (o["derivatives"] + o["riccati_step"]
                  + len(ilqr.ALPHAS) * (o["rollout_step"] + o["step_cost"]
                                        + 1))
    return (init + max_lg_iterations * n * o["multipliers"]
            + iterations * per_it)


def traffic_bytes(spec, H, n_ref, B=1, itemsize=8):
    """Bytes a launch must move: the shared part and the constant tables
    once, each instance's row and its packed result once."""
    s = _spec(spec)
    n_consts = 0 if s.consts is None else len(s.consts)
    return itemsize * (_size(shared_layout(s, H, n_ref)) + n_consts
                       + B * (_size(row_layout(s, H))
                              + _size(output_layout(s, H))))


def bound_ms(spec, H, n_ref, T, iterations, max_lg_iterations=1,
             integrator=ilqr.EULER, dtype=torch.float64):
    """(ms, "bytes" or "operations"): the roofline bound of a launch;
    ``iterations`` is one count, or one count an instance of a batch."""
    its = np.atleast_1d(np.asarray(iterations, np.int64))
    size = torch.empty((), dtype=dtype).element_size()
    n_ops = sum(operations(spec, H, T, int(i), max_lg_iterations,
                           integrator) for i in its)
    return _latency.roofline_ms(
        traffic_bytes(spec, H, n_ref, len(its), size), n_ops,
        str(dtype).replace("torch.", ""))


def chain_ops(spec, H, T, iterations, integrator=ilqr.EULER,
              dtype=torch.float64, rolled=None):
    """Dependent operations on the critical path of one update: the
    initial rollout and its ordered cost sum, then per iteration T Riccati
    steps (fx^T Vxx, Qxx, the action solve, the value update), T rollout
    steps (the feedback dot, the integrator's stages through the dynamics'
    longest path and their combinations) and the ordered cost sum; with
    ``rolled``, that many rounds of rollouts and sums in all, one after the
    other (default: one an iteration, the candidates side by side)."""
    s = _spec(spec)
    nx, nu = s.nx, s.nu
    stages = {ilqr.EULER: 1, ilqr.HEUN: 2, ilqr.RK4: 4}[integrator]
    n = min(T, H)
    riccati = dict(mul=4 + (3 if nu >= 2 else 0) + (nu if nu > 2 else 0),
                   add=(nx - 1) + nx + 3 + (1 if nu >= 2 else 0),
                   div=1 if nu <= 2 else nu)
    stage = _latency.add_ops(dict(s.dyn_chain), dict(mul=1, add=1), 1)
    roll_open = _latency.add_ops({}, stage, stages)
    roll = _latency.add_ops(dict(roll_open), dict(mul=1, add=nx + 1), 1)
    rounds = iterations if rolled is None else rolled
    total = {}
    _latency.add_ops(total, roll_open, n)
    _latency.add_ops(total, roll, n * rounds)
    _latency.add_ops(total, riccati, n * iterations)
    _latency.add_ops(total, dict(add=1), n * (1 + rounds))
    prefix = "f64_" if dtype == torch.float64 else "f32_"
    out = {}
    for op, k in total.items():
        name = op if op == "smem_load" else prefix + op
        if name not in _latency.PROBES:       # no probe: priced as a sine
            name = prefix + "sin"
        out[name] = out.get(name, 0) + k
    return out


def chain_ms(spec, H, T, iterations, cycles, sm_mhz, integrator=ilqr.EULER,
             dtype=torch.float64, rolled=None):
    """The critical path's time from the probe's latencies (``cycles`` per
    operation, :func:`tpl_tpu_torch._latency.measure`) at ``sm_mhz``."""
    return _latency.chain_ms(chain_ops(spec, H, T, iterations, integrator,
                                       dtype, rolled), cycles, sm_mhz)


def design_floor_ms(spec, H, T, iterations, rounds, cycles, sm_mhz,
                    resident, integrator=ilqr.EULER, dtype=torch.float64):
    """The least time of the resident geometry on a batch: ``resident``
    warps (slots on the card at once) take the instances in turn, each at
    least its own dependent chain with its line searches' rounds rolled one
    after the other (``iterations`` and ``rounds``, one count an instance;
    a round rolls 2 candidates in float64, 4 in float32, and at least one
    round runs an iteration), so the batch takes at least the longest chain
    and the chains' sum over the warps."""
    memo = {}
    chains = []
    for it, r in zip(np.atleast_1d(iterations), np.atleast_1d(rounds)):
        key = (int(it), int(r))
        if key not in memo:
            memo[key] = chain_ms(spec, H, T, key[0], cycles, sm_mhz,
                                 integrator, dtype, rolled=key[1])
        chains.append(memo[key])
    return max(max(chains), sum(chains) / resident)


# ---------------------------------------------------------------------
# the libraries

_LIBS = {}


def _bind(lib):
    lib.ilqr_generic_update_consts.restype = ctypes.c_int
    lib.ilqr_generic_update_consts.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p])
    lib.ilqr_generic_split.restype = ctypes.c_size_t
    lib.ilqr_generic_split.argtypes = ([ctypes.c_int] * 4
                                       + [ctypes.c_size_t, ctypes.c_int])
    lib.ilqr_generic_slot_split.restype = ctypes.c_size_t
    lib.ilqr_generic_slot_split.argtypes = ([ctypes.c_int] * 4
                                            + [ctypes.c_size_t, ctypes.c_int])
    lib.ilqr_generic_geometry.restype = ctypes.c_int
    lib.ilqr_generic_geometry.argtypes = ([ctypes.c_int] * 6
                                          + [ctypes.c_size_t, ctypes.c_void_p])
    lib.ilqr_generic_attributes.restype = ctypes.c_int
    lib.ilqr_generic_attributes.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return lib


def source_text(spec, dtype):
    """The source a printed struct's library is built from, for the one
    dtype the solver takes: its struct in a unit that includes the kernel
    body and instantiates it (``csrc/ilqr_generic_entries.cuh``)."""
    s = _spec(spec)
    flag = ("ILQR_GENERIC_F64_ONLY" if dtype == torch.float64
            else "ILQR_GENERIC_F32_ONLY")
    return (f"// the generic AL-iLQR kernel for the printed problem "
            f"{s.name!r}\n"
            f"#define {flag}\n#include \"ilqr_generic_body.cuh\"\n\n"
            f"{s.struct}\n#define ILQR_GENERIC_PROBLEMS(X) "
            f"X(0, {s.struct_name})\n#include \"ilqr_generic_entries.cuh\"\n")


def native_source(dtype):
    """The source of the native problems' library for ``dtype``:
    ``csrc/ilqr_generic.cu`` built for that real type alone."""
    return "ilqr_generic_f64" if dtype == torch.float64 else \
        "ilqr_generic_f32"


def _kernel(spec=None, dtype=torch.float64):
    """Build (first call) and bind the library of ``spec`` for ``dtype``:
    the native problems' ``csrc/ilqr_generic.cu`` (:func:`native_source`),
    or a sympy config's or a traced problem's generated source (built by
    nvcc at its first use, cached by the hash of its text, the headers and
    the flags).  A build that fails raises."""
    s = NATIVE["ref_line_smoother_k"] if spec is None else _spec(spec)
    key = (native_source(dtype) if s.struct is None
           else (s.name, source_text(s, dtype)))
    lib = _LIBS.get(key)
    if lib is None:
        from tpl_tpu_torch import _build

        if s.struct is None:
            lib = _build.load(key)
        else:
            lib = _build.load_generated(_tag(s), key[1])
        _bind(lib)
        _build.prepare(lib, "ilqr_generic")
        _LIBS[key] = lib
    return lib


def _tag(spec):
    """A file name for a generated source: the problem's name, kept to
    letters, digits and underscores."""
    name = "".join(c if c.isalnum() else "_" for c in spec.name)
    return f"genopt_{name}"


def build_generated(specs, dtype):
    """Compile the generated sources of ``specs`` (printed or traced
    structs) that are not built yet, one ``nvcc`` each, all started
    together (the front end's ``build_parallel`` on a CUDA device, and the
    traced structs a run needs at once); ``dtype`` is one dtype for all, or
    one a spec."""
    from tpl_tpu_torch import _build

    dtypes = (list(dtype) if isinstance(dtype, (list, tuple))
              else [dtype] * len(specs))
    _build.build_generated([(_tag(s), source_text(s, d))
                            for s, d in zip(specs, dtypes)])
