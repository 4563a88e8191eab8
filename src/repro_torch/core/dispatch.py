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
Either way the receivers are a segment sum. Dispatch is an execution-
placement choice, never an accounting one: cores and bills are bit-equal
across routes and devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kcore import _finish_round, _fused_loop, masked_round_segment
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

def _stage_arcs(src, dst, n: int, device: torch.device):
    """Arc arrays on ``device``: src/dst as int32 gather indices (they go
    through ``index_select``), and the CSR row pointer of the src-sorted
    arcs as int64 (built on the host)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if src.size and (src[1:] < src[:-1]).any():
        raise ValueError("arcs must be sorted by source (CSR order)")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_ptr[1:])
    return (torch.as_tensor(src, device=device), torch.as_tensor(dst, device=device),
            torch.as_tensor(row_ptr, device=device))


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
                         ell: EllGraph | None = None):
    """Dispatched superstep ``round_body(est, arc_mask, active) -> (new_est,
    changed, recv)`` — ``core.kcore.masked_round_segment`` with the arcs
    staged on ``plan.device``.

    With ``ell`` (static fully-live adjacency only — the from-scratch
    decomposition) the h-index runs through ``kcore_hindex`` per degree
    bucket; otherwise it is the binary search with segment-sum hit counts.
    """
    src_t, dst_t, row_ptr = _stage_arcs(src, dst, n, plan.device)
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
                              ell: EllGraph | None = None):
    """Dispatched fused convergence ``prog(est, arc_mask, active, deg) ->
    (est', rounds, stopped, final_active, msgs_buf, changed_buf, recv_buf)``
    — the contract of ``core.kcore.fused_convergence``."""
    round_body = masked_round_program(n, n_iters, plan, src, dst, ell)

    def prog(est, arc_mask, active, deg):
        return _fused_loop(lambda e, a: round_body(e, arc_mask, a), est, active, deg, max_rounds)

    return prog
