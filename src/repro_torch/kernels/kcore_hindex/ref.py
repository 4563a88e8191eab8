"""Plain PyTorch version of the kcore_hindex kernel.

The same ``n_iters``-probe binary search as the kernel and as the reference's
``repro.core.kcore.hindex_rows_ref`` (probe ``k = max(mid, 1)``), written as
whole-tile tensor operations: with too few probes it returns the same
partial answer they do.
"""

from __future__ import annotations

import torch


def hindex_rows_ref(nbr_est: torch.Tensor, est_u: torch.Tensor, n_iters: int) -> torch.Tensor:
    """nbr_est (R, W) int32 (sentinel slots 0), est_u (R,) int32 -> (R,) int32."""
    vals = torch.minimum(nbr_est, est_u[:, None])
    lo = torch.zeros_like(est_u)
    hi = est_u
    for _ in range(n_iters):
        mid = (lo + hi + 1) // 2
        cnt = (vals >= torch.clamp(mid, min=1)[:, None]).sum(dim=1)
        ok = cnt >= mid
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo
