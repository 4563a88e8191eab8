"""Wrapper of the segment-sum kernel (``csrc/segment_sum.cu``).

``segment_sum(vals, row_ptr)`` sums int32 values over CSR rows: the arcs of
a graph sorted by source, with ``Graph.offsets`` as ``row_ptr``. On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it computes the
plain version, ``ref.segment_sum_ref``. ``launches`` counts the kernel's
launches and nothing else: one a call, which runs the search for the
blocks' starts, the merge-path pass and the small pass over its carries.

Segment ids in any order go through ``csr_layout``, a host-side stable
argsort: ``segment_sum(vals[layout.order], layout.row_ptr)``. The reference's
``blocked_layout`` padding exists for the TPU's sequential grid and is not
ported.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

launches = 0

# The kernel's split of the merge path (csrc/segment_sum.cu's kThreads and
# kItemsPerThread): each block takes ITEMS_PER_BLOCK items of the n row ends
# and E arcs, each thread ITEMS_PER_THREAD of them. The kernel refuses any
# other ITEMS_PER_BLOCK. Its scratch holds each block's start on the path
# and each block's carry.
THREADS = 256
ITEMS_PER_THREAD = 16
ITEMS_PER_BLOCK = THREADS * ITEMS_PER_THREAD

_SYMBOLS = {
    "segment_sum_i32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_void_p],
}


@dataclasses.dataclass(frozen=True)
class CsrLayout:
    """Row order of unsorted segment ids: ``order`` (E,) int64 is a stable
    argsort of the ids, ``row_ptr`` (n+1,) int64 the CSR offsets after it."""

    order: np.ndarray
    row_ptr: np.ndarray


def csr_layout(seg_ids, n: int) -> CsrLayout:
    seg_ids = np.asarray(seg_ids, np.int64)
    if seg_ids.size and (seg_ids.min() < 0 or seg_ids.max() >= n):
        raise ValueError(f"segment ids must lie in [0, {n})")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(seg_ids, minlength=n), out=row_ptr[1:])
    return CsrLayout(order=np.argsort(seg_ids, kind="stable"), row_ptr=row_ptr)


def _check(vals: torch.Tensor, row_ptr: torch.Tensor) -> None:
    if vals.dtype != torch.int32 or vals.dim() != 1 or not vals.is_contiguous():
        raise ValueError(f"vals must be a contiguous 1-D int32 tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if row_ptr.dtype != torch.int64 or row_ptr.dim() != 1 or row_ptr.numel() < 1 \
            or not row_ptr.is_contiguous():
        raise ValueError(f"row_ptr must be a contiguous 1-D int64 tensor of n+1 "
                         f"offsets, got {row_ptr.dtype} {tuple(row_ptr.shape)}")
    if vals.device != row_ptr.device:
        raise ValueError(f"vals on {vals.device} but row_ptr on {row_ptr.device}")


def segment_sum(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-row sums: vals (E,) int32 in row order, row_ptr (n+1,) int64
    non-decreasing with row_ptr[0] == 0 and row_ptr[n] == E -> (n,) int32.
    Empty rows are 0."""
    global launches
    _check(vals, row_ptr)
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, row_ptr)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {vals.device}")
    n, E = row_ptr.numel() - 1, vals.numel()
    out = torch.empty(n, dtype=torch.int32, device=vals.device)
    if n == 0:
        return out
    lib = _build.load("segment_sum", _SYMBOLS)
    blocks = -(-(n + E) // ITEMS_PER_BLOCK)
    scratch = torch.empty(4 * blocks + 2, dtype=torch.int64, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = lib.segment_sum_i32(vals.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
                              scratch.data_ptr(), n, E, ITEMS_PER_BLOCK, stream)
    _build.check(lib, err, "segment_sum")
    launches += 1
    return out

