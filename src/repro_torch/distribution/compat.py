"""Meshes and cross-process collectives for the sharded k-core engines.

The port of ``repro.distribution.compat`` onto ``torch.distributed``. A
``Mesh`` names the shards the sharded engines lay a graph over (the layout
contract of ``graph/partition.py``: shard d owns vertices [d*V, (d+1)*V)
and their outgoing arcs) and says which of them this process holds:

* **one process** (``make_mesh``): every shard lives in this process, on
  one device. Its ``all_gather`` is the shards' concatenation and its
  ``psum`` the value itself, so nothing calls a collective. This is what
  the reference gets from ``--xla_force_host_platform_device_count=N``.
* **several processes** (``init_multiprocess`` + ``global_mesh``): each
  rank holds ``local_shards`` consecutive shards, and ``all_gather`` /
  ``psum`` are ``torch.distributed`` collectives on the process group.

The reference's ``shard_map`` runs one body per device with the mesh's
collectives inside it. Here the body runs once per process over all of its
local shards, stacked, and reaches the other processes through
``all_gather`` and ``psum`` below; that is all of ``shard_map``'s purpose
the engines need. Multi-axis meshes flatten to the product of their axes,
as the reference lays its leading shard dimension over every axis.

The process group is gloo, on the CPU and on the card alike: the card
holds one device, and NCCL refuses two ranks on one GPU. Gloo's
``all_gather`` and ``all_reduce`` take CUDA tensors (they stage them
through host memory themselves); bool masks travel as uint8. The group has
a timeout, so ranks that fall out of step fail instead of hanging.
``cpu_collectives_hint`` (a jax backend flag) has no torch meaning and is
not ported. Each ``all_gather``, ``psum`` and ``reduce_scatter`` over a mesh
of more than one shard is noted, from its shapes, in any open
``distribution.collectives.collective_bytes`` tally, whether or not it
crosses a process.

The GNN family's flat-row sharding (``models/gnn/common.py``) runs its
models through these collectives with autograd. A tensor is either this
process's row blocks (complete: no other process holds those rows) or
held whole by every process. A whole tensor's gradient is held as shares,
one a process, that add up to it; a row block's gradient is held complete.
So a train step seeds its replicated loss with 1/world on every process and
sums the parameters' gradients (whole tensors) over the processes. Under
that rule ``all_gather``'s backward is the reduce-scatter (this process's
rows of the shares' sum), ``reduce_scatter``'s backward is the all-gather
of the row blocks' gradients, and ``psum``'s backward is the ``psum`` of the
shares. Float sums over processes or shards are taken in a fixed order, from
0 in float32 (float64 for float64) and rounded once, so that a mesh of D
shards in one process and the same D shards over several processes give
the same bits.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distribution.collectives import note_collective
from repro_torch.platform import resolve_device

# seconds a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Shards of the sharded engines and where this process's live.

    ``axis_shape``/``axis_names`` are the mesh's axes; their product is the
    global shard count ``size``. Rank ``rank`` of ``world`` processes holds
    shards ``[shard_offset, shard_offset + local_shards)`` on ``device``;
    ``group`` is the ``torch.distributed`` process group, None on one
    process.
    """

    axis_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device
    group: Any = None
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if len(self.axis_shape) != len(self.axis_names) or not self.axis_shape:
            raise ValueError(f"axis shape {self.axis_shape} and names {self.axis_names} "
                             "must be non-empty and of one length")
        if min(self.axis_shape) < 1 or self.size % self.world:
            raise ValueError(f"{self.size} shards cannot be split over {self.world} "
                             "process(es)")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a jax mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shape)

    @property
    def local_shards(self) -> int:
        return self.size // self.world

    @property
    def shard_offset(self) -> int:
        return self.rank * self.local_shards


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh whose every shard lives in this process, on ``device``
    (default CUDA; raises without a card unless ``"cpu"`` is asked for)."""
    return Mesh(tuple(int(s) for s in axis_shapes), tuple(axis_names), resolve_device(device))


def shard_count(mesh: Mesh, axis_names: Sequence[str]) -> int:
    """Global shard count of ``mesh`` over ``axis_names``, which must name
    every axis of the mesh: the port shards over all of them."""
    if sorted(axis_names) != sorted(mesh.axis_names):
        raise ValueError(f"axis_names {tuple(axis_names)} must name every axis of the mesh "
                         f"{mesh.axis_names}")
    return mesh.size


# ------------------------------------------------------------------ #
# Multi-process topology
# ------------------------------------------------------------------ #

def init_multiprocess(coordinator_address: str, num_processes: int, process_id: int, *,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process into a gloo process group of ``num_processes``
    ranks rendezvousing at ``coordinator_address`` (``host:port``). Every
    rank calls this before ``global_mesh``; a repeat call is a no-op."""
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(axis_name: str = "shard", *, local_shards: int = 1,
                device: str | torch.device | None = None) -> Mesh:
    """1-D mesh over every process's shards, ``local_shards`` a process (on
    one process: a mesh of ``local_shards`` shards)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh((world * int(local_shards),), (axis_name,), resolve_device(device),
                group=dist.group.WORLD if world > 1 else None, rank=rank, world=world)


def is_multiprocess_mesh(mesh: Mesh) -> bool:
    """True when ``mesh`` spans shards held by more than one process."""
    return mesh.world > 1


# ------------------------------------------------------------------ #
# Staging and collectives
# ------------------------------------------------------------------ #

def stage_to_mesh(arr, mesh: Mesh) -> torch.Tensor:
    """This process's rows of a host array whose leading dimension is the
    mesh's global shard count, as a tensor on the mesh's device. Every
    process holds the whole host array; on one process it is all staged."""
    arr = np.asarray(arr)
    if arr.ndim == 0 or arr.shape[0] != mesh.size:
        raise ValueError(f"leading dimension {arr.shape[:1]} is not the mesh's "
                         f"{mesh.size} shards")
    lo = mesh.shard_offset
    return torch.as_tensor(np.ascontiguousarray(arr[lo:lo + mesh.local_shards]),
                           device=mesh.device)


def _gathered(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every process's ``x``, in rank order (gloo; bool masks as uint8)."""
    send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.world)]
    dist.all_gather(parts, send, group=mesh.group)
    return [p.to(x.dtype) for p in parts] if x.dtype == torch.bool else parts


def _ordered_sum(parts, dtype: torch.dtype) -> torch.Tensor:
    """``parts`` added in order from 0, in float32 (float64 for float64),
    rounded once to ``dtype``."""
    acc = torch.zeros(parts[0].shape, device=parts[0].device,
                      dtype=torch.float64 if dtype == torch.float64 else torch.float32)
    for p in parts:
        acc += p
    return acc.to(dtype)


def _own_rows_of_sum(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's rows of the sum over processes of ``g`` (every
    process's whole array): the reduce-scatter."""
    note_collective("reduce-scatter", g.numel() * g.element_size(), mesh.size)
    rows = g.shape[0] // mesh.world
    lo = mesh.rank * rows
    return _ordered_sum([p[lo:lo + rows] for p in _gathered(g, mesh)], g.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(_gathered(x, mesh))

    @staticmethod
    def backward(ctx, g):
        return _own_rows_of_sum(g, ctx.mesh), None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's shards ``x`` (leading dimension over the local
    shards, or the rows of its row blocks) concatenated with every other
    process's, in shard order. Differentiable: the backward is this
    process's rows of the gradient's sum over processes."""
    if mesh.size > 1:
        note_collective("all-gather", x.numel() * x.element_size() * mesh.world, mesh.size)
    if mesh.world == 1:
        return x
    return _AllGather.apply(x, mesh)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dtype):
        ctx.mesh, ctx.shape, ctx.dtype = mesh, x.shape, x.dtype
        L, blk = mesh.local_shards, x.shape[1] // mesh.size
        parts = x.unbind(0) if mesh.world == 1 else torch.cat(_gathered(x, mesh)).unbind(0)
        lo, hi = mesh.shard_offset * blk, (mesh.shard_offset + L) * blk
        return _ordered_sum([p[lo:hi] for p in parts], dtype)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if mesh.size > 1:
            note_collective("all-gather", g.numel() * g.element_size() * mesh.world, mesh.size)
        whole = g if mesh.world == 1 else torch.cat(_gathered(g.contiguous(), mesh))
        return whole.to(ctx.dtype).unsqueeze(0).expand(ctx.shape), None, None


def reduce_scatter(x: torch.Tensor, mesh: Mesh, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The tiled reduce-scatter of this process's shard partials: ``x`` (L,
    R, ...) holds the partials of its L = ``mesh.local_shards`` shards, each
    over all R rows (R a multiple of the mesh's D shards). Returns this
    process's L row blocks, (L * R / D, ...): each row the sum of the D
    shards' partials of it, added in shard order from 0 in float32 (float64
    for float64) and rounded once to ``dtype`` (default ``x``'s). The same
    bits on one process and across processes. Differentiable: the backward
    gives every local partial the all-gathered gradient of the rows."""
    L, R = x.shape[0], x.shape[1]
    if L != mesh.local_shards or R % mesh.size:
        raise ValueError(f"reduce_scatter takes ({mesh.local_shards}, R, ...) partials with R a "
                         f"multiple of {mesh.size}, got {tuple(x.shape)}")
    if mesh.size > 1:
        note_collective("reduce-scatter", x[0].numel() * x.element_size(), mesh.size)
    return _ReduceScatter.apply(x, mesh, dtype or x.dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _ordered_sum(_gathered(x.contiguous(), mesh), x.dtype)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh), None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over every process of the mesh. Integers add exactly
    (an all-reduce); floats in rank order from 0 in float32 (float64 for
    float64), rounded once, and differentiably: the backward is the
    ``psum`` of the gradient's shares (the module docstring)."""
    if mesh.size > 1:
        note_collective("all-reduce", x.numel() * x.element_size(), mesh.size)
    if mesh.world == 1:
        return x
    if x.is_floating_point():
        return _PSum.apply(x, mesh)
    total = x.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


def fetch_replicated(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Host copy of the global array whose local shards are ``x``, the
    same on every process."""
    return all_gather(x, mesh).cpu().numpy()
