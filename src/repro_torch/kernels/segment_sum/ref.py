"""Plain PyTorch versions of the segment-sum kernels.

``segment_sum_ref`` (int32): a prefix sum and a difference at the row
pointers, a different algorithm from the kernel's per-row reduction, exact
in int64 and wrapped to int32 as the kernel's (and ``jax.ops.segment_sum``'s)
int32 sums wrap.

``segment_sum_float_ref``: a float32 ``index_add_`` (float64 for float64
values) cast back to the values' dtype. On the CPU ``index_add_`` adds in
index order, one edge after another, which is the kernel's order within a
row, so there the two agree bit for bit; on the card its atomics add in no
fixed order.
"""

from __future__ import annotations

import torch


def segment_sum_ref(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """vals (E,) int32 in row order, row_ptr (n+1,) int64 -> (n,) int32."""
    csum = torch.zeros(vals.numel() + 1, dtype=torch.int64, device=vals.device)
    torch.cumsum(vals, 0, dtype=torch.int64, out=csum[1:])
    return (csum[row_ptr[1:]] - csum[row_ptr[:-1]]).to(torch.int32)


def segment_sum_float_ref(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """vals (E, ...) float in edge order, ids (E,) int64 in [0, n) -> (n, ...)."""
    acc = torch.float64 if vals.dtype == torch.float64 else torch.float32
    out = torch.zeros((n, *vals.shape[1:]), dtype=acc, device=vals.device)
    return out.index_add_(0, ids, vals.to(acc)).to(vals.dtype)
