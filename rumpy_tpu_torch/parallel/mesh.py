"""Process group and data-parallel layer: port of ``rumpy_tpu/parallel/mesh.py``.

The JAX package gets data parallelism from its shardings: a batch sharded
over a mesh's ``data`` axis and replicated parameters make ``jit`` compute
the step of the global batch, inserting the gradient all-reduce itself. The
port runs one process a card in a ``torch.distributed`` group and keeps
those global-view semantics by hand: a step over W ranks, each with its
B / W rows, computes what one process computes on the global batch B.

* :func:`get_mesh` joins (once) the group that ``torchrun`` describes in
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, on
  ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo, and returns a
  :class:`Mesh` that reads as the JAX mesh does (``shape["data"]``), with
  its rank, group and device. Without ``WORLD_SIZE`` it is a mesh of one,
  as the JAX mesh of one device. More ranks on a host than it has cards
  share them, and then the group is gloo: NCCL refuses two ranks on a card.
* :func:`shard_batch`, :func:`replicate`, :func:`local_batch_size` as in the
  JAX package.
* The collectives the port's handlers, BatchNorm, contrastive queues,
  degradation chain, spatial forward and predictor use, and no others:
  ``all_reduce``, ``broadcast`` and ``all_gather``. All three run under NCCL
  and, staged through the host, under gloo on CUDA tensors (several ranks
  on one card, which NCCL refuses). A mesh of one runs no collective, so a
  one-rank group computes bit for bit what a single process computes.

The handlers reach the group through :func:`active_mesh`: the mesh that
``get_mesh`` made, where it has more than one rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rumpy_tpu_torch.device import resolve_device, true_div


class Rows(NamedTuple):
    """This rank's rows of a global batch: rows ``start`` to ``start +
    count`` of ``total``. ``gather`` takes a tensor of this rank's rows to
    the (total, ...) tensor of every rank's rows, in rank order."""
    start: int
    count: int
    total: int
    gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def take(self, x):
        """This rank's rows of ``x``: of a tensor whose first axis is the
        global batch, or of each tensor in a tuple, dict or dataclass (an
        op's draws); anything else as it is."""
        if torch.is_tensor(x):
            return x[self.start:self.start + self.count]
        if isinstance(x, tuple):
            parts = [self.take(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        if isinstance(x, dict):
            return {k: self.take(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: self.take(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x


def take_rows(x, rows: Optional[Rows]):
    """``rows.take(x)``, or ``x`` itself without rows."""
    return x if rows is None else rows.take(x)


class Mesh:
    """A data-parallel group as the JAX mesh reads: ``shape["data"]`` ranks
    (``shape["model"]`` is 1), this process's ``rank``, its ``group``
    (None for the default group, or for a mesh of one) and ``device``."""

    def __init__(self, rank: int, size: int, device: torch.device, group=None):
        self.rank = rank
        self.size = size
        self.device = device
        self.group = group
        self.shape = {"data": size, "model": 1}

    def rows(self, n: int) -> Optional[Rows]:
        """The :class:`Rows` of a batch of ``n`` images a rank; None on a
        mesh of one."""
        if self.size == 1:
            return None
        return Rows(self.rank * n, n, n * self.size, lambda t: all_gather_rows(t, self))

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, data={self.size}, device={self.device})"


_MESH: List[Optional[Mesh]] = [None]


def get_mesh(n_data: Optional[int] = None, device=None, init_method: Optional[str] = None,
             rank: Optional[int] = None, world_size: Optional[int] = None) -> Mesh:
    """The process group as a :class:`Mesh`, joined at the first call.

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``); the device to ``cuda:LOCAL_RANK`` (``device="cpu"`` for
    the CPU; a CUDA device without CUDA raises). The backend is NCCL on the
    cards, gloo on the CPU or where the host's ``LOCAL_WORLD_SIZE`` ranks
    outnumber its cards (rank ``LOCAL_RANK`` then takes card ``LOCAL_RANK``
    modulo their count). Without ``WORLD_SIZE`` and ``init_method`` the
    process joins no group: a mesh of one. ``n_data``, where given, must be
    the group's size: every rank is on the data axis."""
    mesh = _MESH[0]
    if mesh is None:
        env = os.environ
        world = int(world_size if world_size is not None else env.get("WORLD_SIZE", 1))
        me = int(rank if rank is not None else env.get("RANK", 0))
        dev = resolve_device(device)
        backend = "gloo"
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            if dev.index is None:
                dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)) % cards)
            torch.cuda.set_device(dev)
            if int(env.get("LOCAL_WORLD_SIZE", 1)) <= cards:
                backend = "nccl"
        joins = "WORLD_SIZE" in env or init_method is not None or world > 1
        if joins and not dist.is_initialized():
            dist.init_process_group(backend, init_method=init_method or "env://",
                                    rank=me, world_size=world)
        if dist.is_initialized():
            me, world = dist.get_rank(), dist.get_world_size()
        mesh = _MESH[0] = Mesh(me, world, dev)
    if n_data is not None and n_data != mesh.size:
        raise ValueError(f"the data axis must hold every rank of the group: n_data={n_data} "
                         f"against {mesh.size} ranks (start one process a card of the axis)")
    return mesh


def leave_mesh() -> None:
    """Leaves the group (``destroy_process_group``) and forgets the mesh."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH[0] = None


def active_mesh(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """``mesh`` (default: the mesh of :func:`get_mesh`) where it has more
    than one rank, else None: the collectives run over it."""
    mesh = mesh or _MESH[0]
    return mesh if mesh is not None and mesh.size > 1 else None


def joined() -> bool:
    """Whether this process is in a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in its mesh (0 outside a group): only rank 0
    writes files."""
    if _MESH[0] is not None:
        return _MESH[0].rank
    return dist.get_rank() if joined() else 0


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {n}")
    return global_batch // n


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of each array (numpy or tensor) of a global batch,
    as the JAX package's ``shard_batch`` places them: rank r holds rows r *
    B / W to (r + 1) * B / W. An array whose first axis does not divide
    raises, as a JAX sharding does; other values stay as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
            n = local_batch_size(mesh, v.shape[0])
            v = v[mesh.rank * n:(mesh.rank + 1) * n]
        out[k] = v
    return out


def _tensors_of(tree) -> List[torch.Tensor]:
    """The tensors of a module's state dict, a TrainState's params or a
    dict of tensors."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    params = tree.params if hasattr(tree, "params") else tree
    return [t for t in params.values() if isinstance(t, torch.Tensor)]


def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    """Runs ``collective`` on one flat buffer a dtype and device holding
    ``tensors``, and writes the result back into them."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, chunk in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(chunk.view(t.shape))


@torch.no_grad()
def replicate(mesh: Optional[Mesh], tree):
    """Parameters and buffers (of a module, a TrainState or a dict of
    tensors) made equal on every rank, broadcast from rank 0 in place.
    Returns ``tree``."""
    mesh = active_mesh(mesh)
    if mesh is not None:
        src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
        _coalesced(_tensors_of(tree), lambda flat: dist.broadcast(flat, src, group=mesh.group))
    return tree


@torch.no_grad()
def mean_over_group(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh] = None) -> None:
    """Each tensor replaced, in place, by its mean over the group's ranks:
    one ``all_reduce`` of a float32 buffer (float64 where a tensor is), the
    sum divided by the group's size. The gradient average of a step."""
    mesh = active_mesh(mesh)
    if mesh is None or not tensors:
        return
    wide = torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
    flat = torch.cat([t.reshape(-1).to(wide) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat = true_div(flat, mesh.size)
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view(t.shape))


def mean_losses(losses: Dict[str, torch.Tensor],
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A step's losses, detached, as the group's means (the global batch's
    where a loss is a batch mean)."""
    out = {k: v.detach().clone() for k, v in losses.items()}
    mean_over_group(list(out.values()), mesh)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's rows of ``t``, in rank order: (W * n, ...) from (n, ...).
    Carries no gradient."""
    mesh = active_mesh(mesh)
    if mesh is None:
        return t
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Every rank waits for the others (an ``all_reduce`` of one value), as
    where rank 0 has written a file the others read."""
    mesh = active_mesh(mesh)
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


class _GroupSum(torch.autograd.Function):
    """The sum over the group's ranks, whose gradient is the sum over the
    ranks of the gradients (each rank's loss depends on every rank's
    input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def group_sum(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``t`` summed over the group, differentiable: the global batch's sums
    from each rank's (BatchNorm's statistics, a batch mean inside a
    loss). ``t`` itself on a mesh of one."""
    mesh = active_mesh(mesh)
    return t if mesh is None else _GroupSum.apply(t, mesh.group)


def global_mean(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean of every element of ``t`` over the global batch (equal
    local batches), differentiable: ``t.mean()`` on a mesh of one."""
    mesh = active_mesh(mesh)
    if mesh is None:
        return t.mean()
    return true_div(group_sum(t.sum(), mesh), t.numel() * mesh.size)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows; the gradient of this rank's rows is their
    gradient summed over the ranks' losses."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_gather_rows(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=mesh.group)
        n = grad.shape[0] // mesh.size
        return grad[mesh.rank * n:(mesh.rank + 1) * n], None


def gather_rows_with_grad(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """:func:`all_gather_rows` with a gradient, for a loss over the whole
    global batch (SupCon's pairs)."""
    mesh = active_mesh(mesh)
    return t if mesh is None else _GatherRows.apply(t, mesh)
