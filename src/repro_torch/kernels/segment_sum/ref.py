"""Plain PyTorch version of the segment-sum kernel.

A prefix sum and a difference at the row pointers: a different algorithm
from the kernel's per-row reduction, exact in int64 and wrapped to int32 as
the kernel's (and ``jax.ops.segment_sum``'s) int32 sums wrap.
"""

from __future__ import annotations

import torch


def segment_sum_ref(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """vals (E,) int32 in row order, row_ptr (n+1,) int64 -> (n,) int32."""
    csum = torch.zeros(vals.numel() + 1, dtype=torch.int64, device=vals.device)
    torch.cumsum(vals, 0, dtype=torch.int64, out=csum[1:])
    return (csum[row_ptr[1:]] - csum[row_ptr[:-1]]).to(torch.int32)
