"""
Device-mesh scale-out for batched scenario planning.

The port of ``tpl_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh`` ("dp" axis): scenario batches
shard over its devices, solvers run per shard, and reductions (the best
candidate cost) ride collectives inside ``shard_map``.  The port is also one
process over a mesh: :func:`scenario_mesh` is a 1-D tuple of
``torch.device``\\s, :func:`shard_scenarios` splits a batch's leading
dimension over them (``tensor_split``, each shard moved to its device), a
sharded function runs its shards one after the other (a CUDA launch returns
at once, so the cards of a mesh work side by side) and reduces on the first
device.  Several processes (hosts) join with :func:`init_distributed`
(``torch.distributed``: NCCL on CUDA, gloo on the CPU); then
:func:`sharded_best_candidate` all-reduces its minimum over the ranks with
``ReduceOp.MIN``, as ``jax.lax.pmin`` spans the hosts of a multi-host mesh.

Nothing falls back quietly: a mesh asked for the card on a machine without
one, or for more cards than there are, raises.
"""

import numpy as np
import torch
import torch.distributed as dist

import tpl_tpu_torch


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device=None):
    """Join a multi-process run when configured (a no-op, returning False,
    when ``coordinator`` is None).  ``coordinator`` is an init method
    (``tcp://host:port``, ``file:///path``) or a ``host:port`` address;
    the backend is NCCL when ``device`` (``tpl_tpu_torch.device()`` unless
    given) is a CUDA device, each rank on card ``process_id`` modulo the
    cards present, and gloo on the CPU."""
    if coordinator is None:
        return False
    dev = tpl_tpu_torch.device() if device is None else torch.device(device)
    if "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return True


def scenario_mesh(n_devices=None, axis="dp", device=None):
    """A 1-D mesh over the scenario batch axis: a tuple of
    ``torch.device``\\s.  On the card (``tpl_tpu_torch.device()`` unless
    ``device`` is given) the first ``n_devices`` visible CUDA devices (all
    of them unless given); on the CPU ``n_devices`` CPU entries (one unless
    given), which run their shards one after the other.  ``axis`` names the
    mesh's one axis, as in the JAX package; the tuple has no other."""
    kind = (tpl_tpu_torch.device() if device is None
            else torch.device(device)).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"a mesh of {n} cards asked for, {count} "
                             "visible")
        return tuple(torch.device("cuda", i) for i in range(n))
    if kind != "cpu":
        raise ValueError(f"scenario_mesh: unsupported device {kind}")
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh of {n} entries")
    return (torch.device("cpu"),) * n


class Shards(tuple):
    """The per-device shards of a batch, one per mesh device, in mesh
    order (what :func:`shard_scenarios` returns)."""

    def gather(self, device=None):
        """The batch again, its shards concatenated on ``device`` (the
        first shard's device unless given)."""
        return _concat(list(self), 0, device)


def _leaves_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_map(fn, v) for v in tree)
    return fn(tree)


def _split(tree, n):
    """``n`` trees of the leading-dimension pieces of every array leaf
    (``torch.tensor_split``, the leading dimension divisible by ``n``);
    other leaves are repeated."""
    def piece(k):
        def take(leaf):
            if isinstance(leaf, np.ndarray):
                leaf = torch.from_numpy(np.require(leaf, requirements="W"))
            if isinstance(leaf, torch.Tensor) and leaf.dim() > 0:
                if leaf.shape[0] % n:
                    raise ValueError(f"a batch of {leaf.shape[0]} on a mesh "
                                     f"of {n}: the batch must divide evenly")
                return torch.tensor_split(leaf, n)[k]
            return leaf
        return _leaves_map(take, tree)
    return [piece(k) for k in range(n)]


def _to(tree, device):
    return _leaves_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, tree)


def _concat(trees, dim, device=None):
    """The trees' array leaves concatenated along ``dim`` on ``device``
    (the first tree's device unless given)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _concat([t[k] for t in trees], dim, device)
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([t[i] for t in trees], dim, device)
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else device
        return torch.cat([t.to(dev) for t in trees], dim)
    return first


def shard_scenarios(tree, mesh, axis="dp"):
    """Place a batched pytree (tensors, numpy arrays, dicts, lists, tuples)
    with a leading batch dimension onto the mesh: its :class:`Shards`, one
    tree per device, each array leaf's equal share of the batch on that
    device.  A batch that does not divide evenly over the mesh raises, as
    the JAX package's placement does."""
    return Shards(_to(part, dev)
                  for part, dev in zip(_split(tree, len(mesh)), mesh))


def global_min(value):
    """``value`` (a 0-d tensor) reduced with ``ReduceOp.MIN`` over the ranks
    of the process group when one is up; ``value`` otherwise."""
    if not (dist.is_available() and dist.is_initialized()):
        return value
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = value.detach().reshape(1).to(dev).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MIN)
    return buf[0].to(value.device)


def sharded_best_candidate(batched_solve, mesh, axis="dp"):
    """Wrap a batched solve so the batch shards over the mesh and the
    globally best candidate cost is reduced on the first device (and over
    the ranks of a process group).

    batched_solve(batch_inputs...) -> (outputs, costs (B_local,))
    Returns solve(inputs...) -> (outputs, costs, global_best_cost): every
    argument shards along its leading dimension (or arrives as
    :class:`Shards`), which must divide evenly over the mesh; outputs and
    costs come back whole, on the first device.
    """

    def wrapped(*args):
        shards = [a if isinstance(a, Shards) else shard_scenarios(a, mesh)
                  for a in args]
        outs, costs = [], []
        for k in range(len(mesh)):
            out, c = batched_solve(*(s[k] for s in shards))
            outs.append(out)
            costs.append(c)
        out = _concat(outs, 0, mesh[0])
        costs = _concat(costs, 0, mesh[0])
        return out, costs, global_min(torch.min(costs))

    return wrapped
