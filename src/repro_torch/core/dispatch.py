"""Superstep dispatch: the hand-written CUDA kernels or their plain versions.

The port of ``repro.core.dispatch``. The reference routes the superstep's
reductions to its Pallas kernels or to XLA segment ops by a switch; here the
route follows the device the caller asked for, with no switch:

* on ``cuda`` the plan is ``kind="kernel"``: the superstep runs the
  ``kcore_hindex`` and ``segment_sum`` CUDA kernels, and a kernel that fails
  to build or launch raises — nothing falls back;
* on ``cpu`` the plan is ``kind="torch"``: the same code reaches the same
  wrappers, which compute their plain PyTorch versions on CPU tensors.

``masked_round_program`` / ``fused_convergence_program`` stage the arc
arrays (and the ELL tiles) on the device once and return closures with the
contract of ``core.kcore.masked_round_segment`` / ``core.kcore.fused_convergence``.
With the static degree-bucketed ``EllGraph`` the per-vertex h-index runs
through ``kcore_hindex`` per bucket; with ``ell=None`` it is the binary
search with segment-sum hit counts (the route the streaming engine needs).
Either way the receivers are a segment sum. ``block_gs_round_program``
stages the block-Gauss-Seidel sweep the same way (``stage_blocks``: each
vertex block's arcs and row pointer once), the blocks swept in order within
a round, and ``stage_shards`` a mesh's shards for the sharded engines of
``core.kcore``. Dispatch
is an execution-placement choice, never an accounting one: cores and bills
are bit-equal across routes and devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kcore import (_finish_round, _fused_loop, _hindex_by_bsearch, _receivers,
                                    masked_round_segment)
from repro_torch.distribution import compat
from repro_torch.graph.partition import ShardedGraph, shard_layout
from repro_torch.graph.structs import EllGraph
from repro_torch.kernels.kcore_hindex.ops import hindex_rows
from repro_torch.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """``kind`` is ``"kernel"`` (the CUDA kernels) on a CUDA device and
    ``"torch"`` (their plain versions) on the CPU."""

    kind: str
    device: torch.device


def resolve_plan(device: str | torch.device | None = None) -> DispatchPlan:
    """The plan for ``device`` (default CUDA; see ``platform.resolve_device``)."""
    dev = resolve_device(device)
    return DispatchPlan(kind="kernel" if dev.type == "cuda" else "torch", device=dev)


# ---------------------------------------------------------------------- #
# Staging — once per program, never per round
# ---------------------------------------------------------------------- #

def stage_arcs(src, dst, n: int, device: torch.device):
    """Arc arrays on ``device``: src/dst as int32 gather indices (they go
    through ``index_select``), and the CSR row pointer of the src-sorted
    arcs as int64, found on the device by a binary search of ``src``.
    ``src``/``dst`` may be numpy arrays or tensors already on ``device``
    (then nothing is copied)."""
    src, dst = (torch.as_tensor(a if torch.is_tensor(a) else np.ascontiguousarray(a),
                                dtype=torch.int32, device=device) for a in (src, dst))
    if src.numel() > 1 and bool((src[1:] < src[:-1]).any()):
        raise ValueError("arcs must be sorted by source (CSR order)")
    rows = torch.arange(n + 1, dtype=torch.int32, device=device)
    return src, dst, torch.searchsorted(src, rows)


@dataclasses.dataclass(frozen=True)
class StagedShards:
    """The shards of a ``ShardedGraph`` this process holds, on the mesh's
    device, stacked into one CSR: local shard l's vertex v is row
    ``l * V + v`` and its arcs (src-sorted, the padding arcs on local row
    V - 1 with the mask False) follow shard l - 1's, so one ``segment_sum``
    launch serves every local shard. ``dst`` stays global: an index into
    the estimates gathered over the mesh."""

    mesh: compat.Mesh
    V: int
    src: torch.Tensor       # (L * A,) int32 stacked local rows
    dst: torch.Tensor       # (L * A,) int32 global vertex ids
    row_ptr: torch.Tensor   # (L * V + 1,) int64
    arc_mask: torch.Tensor  # (L * A,) bool
    deg: torch.Tensor       # (L * V,) int32


def stage_shards(sg: ShardedGraph, mesh: compat.Mesh, axis_names) -> StagedShards:
    """Stage this process's shards of ``sg`` (laid over ``mesh``'s axes
    ``axis_names``) on the mesh's device, once."""
    if compat.shard_count(mesh, axis_names) != sg.n_shards:
        raise ValueError(f"{sg.n_shards} shards staged on a mesh of {mesh.size}")
    L, V = mesh.local_shards, sg.verts_per_shard
    local = compat.stage_to_mesh(sg.src, mesh)
    first = torch.arange(L, dtype=torch.int32, device=mesh.device)[:, None] * V
    src, dst, row_ptr = stage_arcs((local + first).reshape(-1),
                                   compat.stage_to_mesh(sg.dst, mesh).reshape(-1), L * V,
                                   mesh.device)
    return StagedShards(mesh, V, src, dst, row_ptr,
                        compat.stage_to_mesh(sg.arc_mask, mesh).reshape(-1),
                        compat.stage_to_mesh(sg.deg, mesh).reshape(-1))


@dataclasses.dataclass(frozen=True)
class _Tile:
    ids: torch.Tensor    # (rows,) int64 — the bucket's real rows only
    nbrs: torch.Tensor   # (rows * width,) int32 gather indices, padding = n
    rows: int
    width: int


def _stage_ell(ell: EllGraph, device: torch.device) -> list[_Tile]:
    """The ELL buckets' real rows on ``device``. Padded rows (id ``n``) are
    dropped here: scattering their results would write the sentinel."""
    tiles = []
    for b in ell.buckets:
        r = b.rows_real
        if r == 0:
            continue
        tiles.append(_Tile(
            ids=torch.as_tensor(b.ids[:r].astype(np.int64), device=device),
            nbrs=torch.as_tensor(np.ascontiguousarray(b.nbrs[:r]).reshape(-1), device=device),
            rows=r, width=int(b.width)))
    return tiles


def _hindex_ell(est, tiles: list[_Tile], n_iters: int):
    """Per-vertex h-index through ``hindex_rows``, bucket by bucket.

    ``est_ext[n] = 0``: padded neighbor slots never count for k >= 1.
    Vertices of degree 0 are in no bucket and keep their estimate, which is
    0 from the degree seed — the precondition of this route.
    """
    est_ext = torch.cat([est, est.new_zeros(1)])
    h = est.clone()
    for t in tiles:
        nbr_est = est_ext.index_select(0, t.nbrs).view(t.rows, t.width)
        h.index_copy_(0, t.ids, hindex_rows(nbr_est, est.index_select(0, t.ids), n_iters))
    return h


# ---------------------------------------------------------------------- #
# Round body — the dispatched superstep
# ---------------------------------------------------------------------- #

def masked_round_program(n: int, n_iters: int, plan: DispatchPlan, src, dst,
                         ell: EllGraph | None = None, row_ptr=None):
    """Dispatched superstep ``round_body(est, arc_mask, active) -> (new_est,
    changed, recv)`` — ``core.kcore.masked_round_segment`` with the arcs
    staged on ``plan.device`` (``arc_mask`` None: every arc is live). With
    ``row_ptr`` given, ``(src, dst, row_ptr)`` is already the triple of
    ``stage_arcs`` and nothing is staged again.

    With ``ell`` (static fully-live adjacency only — the from-scratch
    decomposition) the h-index runs through ``kcore_hindex`` per degree
    bucket; otherwise it is the binary search with segment-sum hit counts.
    """
    if row_ptr is None:
        src_t, dst_t, row_ptr = stage_arcs(src, dst, n, plan.device)
    else:
        src_t, dst_t = src, dst
    if ell is None:
        def round_body(est, arc_mask, active):
            return masked_round_segment(est, src_t, dst_t, row_ptr, arc_mask, active, n_iters)

        return round_body

    tiles = _stage_ell(ell, plan.device)

    def round_body(est, arc_mask, active):
        h = _hindex_ell(est, tiles, n_iters)
        return _finish_round(est, h, active, dst_t, row_ptr, arc_mask)

    return round_body


def fused_convergence_program(n: int, n_iters: int, max_rounds: int,
                              plan: DispatchPlan, src, dst,
                              ell: EllGraph | None = None, row_ptr=None):
    """Dispatched fused convergence ``prog(est, arc_mask, active, deg) ->
    (est', rounds, stopped, final_active, msgs_buf, changed_buf, recv_buf)``
    — the contract of ``core.kcore.fused_convergence``; the arcs as in
    ``masked_round_program``."""
    round_body = masked_round_program(n, n_iters, plan, src, dst, ell, row_ptr)

    def prog(est, arc_mask, active, deg):
        return _fused_loop(lambda e, a: round_body(e, arc_mask, a), est, active, deg, max_rounds)

    return prog


@dataclasses.dataclass(frozen=True)
class StagedBlocks:
    """The block-Gauss-Seidel layout on the device: the staged arcs'
    ``dst`` and ``row_ptr`` (for the receivers), and per block ``(v0, src,
    dst, row_ptr)`` — its first vertex, its arcs' local sources and global
    destinations and its ``(V + 1,)`` local row pointer."""

    V: int
    n_pad: int
    dst: torch.Tensor
    row_ptr: torch.Tensor
    blocks: list


def stage_blocks(n: int, src, dst, n_blocks: int, device: torch.device) -> StagedBlocks:
    """Stage the arcs once and cut them into the vertex blocks of
    ``partition.shard_layout`` (the reference's geometry: ``n`` padded up to
    a multiple of the block count; padding vertices have no arcs)."""
    src_t, dst_t, row_ptr = stage_arcs(src, dst, n, device)
    V, _, bounds = shard_layout(n, np.asarray(src), n_blocks)
    n_pad = V * n_blocks
    E = src_t.numel()
    row_ptr_pad = torch.cat([row_ptr, row_ptr.new_full((n_pad - n,), E)])
    blocks = []
    for b in range(n_blocks):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        blocks.append((b * V, src_t[lo:hi] - b * V, dst_t[lo:hi],
                       row_ptr_pad[b * V:(b + 1) * V + 1] - lo))
    return StagedBlocks(V, n_pad, dst_t, row_ptr, blocks)


def block_gs_round_program(n: int, src, dst, n_blocks: int, n_iters: int, plan: DispatchPlan):
    """Dispatched block-Gauss-Seidel round ``round_body(est) -> (new_est,
    changed, recv)`` over a static fully-live adjacency (src-sorted arcs).

    The port of the reference's ``_make_round_block_gs``: the vertices fall
    into ``n_blocks`` contiguous blocks of ``V`` (``stage_blocks``; padding
    vertices stay at estimate 0). Within a round the blocks are swept in
    order, and each block's h-index (the binary search with segment-sum hit
    counts over the block's own arcs) reads the estimates the blocks before
    it wrote in the same round.
    ``changed`` marks the vertices whose estimate dropped this round and
    ``recv`` those with an arc to one of them. Every block's arcs and row
    pointer are slices of arrays staged on the device once, here.
    """
    st = stage_blocks(n, src, dst, n_blocks, plan.device)
    V, n_pad = st.V, st.n_pad

    def round_body(est):
        new = torch.cat([est, est.new_zeros(n_pad - n)])
        changed = torch.zeros(n_pad, dtype=torch.bool, device=est.device)
        for v0, b_src, b_dst, b_ptr in st.blocks:
            est_u = new[v0:v0 + V]
            h = _hindex_by_bsearch(est_u, new.index_select(0, b_dst), b_src, b_ptr, n_iters)
            changed[v0:v0 + V] = h < est_u
            new[v0:v0 + V] = h
        changed = changed[:n]
        return new[:n], changed, _receivers(changed, st.dst, st.row_ptr)

    return round_body
