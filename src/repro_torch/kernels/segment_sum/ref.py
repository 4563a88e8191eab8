"""Plain PyTorch versions of the segment-sum kernels.

``segment_sum_ref`` (int32): a prefix sum and a difference at the row
pointers, a different algorithm from the kernel's per-row reduction, exact
in int64 and wrapped to int32 as the kernel's (and ``jax.ops.segment_sum``'s)
int32 sums wrap.

``segment_sum_float_ref``: the float form's definition, computed from the
segment ids alone. Each row's terms, in edge order, are cut into stretches
of ``ops.STRETCH`` consecutive arcs (the last may be shorter); each stretch
is summed in float32 from 0 in edge order, the row's stretch partials are
added in float32 from 0 in stretch order, and the sum is rounded once to
the values' dtype (float64 values are summed in float64). It takes two
``index_add_`` passes: the values into the stretch partials, indexed by each
arc's stretch slot, then the partials into the rows. On the CPU
``index_add_`` adds in index order, one term after another, which is the
kernel's order, so there the two agree bit for bit; on the card its atomics
add in no fixed order. Where no row is wider than a stretch, one
``index_add_`` of the values into the rows gives the same bits (``0 + p ==
p``), and is what runs.
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
    from repro_torch.kernels.segment_sum.ops import STRETCH as stretch  # ops imports this module
    acc = torch.float64 if vals.dtype == torch.float64 else torch.float32
    out = torch.zeros((n, *vals.shape[1:]), dtype=acc, device=vals.device)
    counts = torch.bincount(ids, minlength=n)
    if ids.numel() == 0 or int(counts.max()) <= stretch:
        return out.index_add_(0, ids, vals.to(acc)).to(vals.dtype)
    # arc e's stretch slot: its row's first slot + (its rank among the row's arcs) // stretch
    per_row = (counts + stretch - 1) // stretch
    first = torch.cumsum(per_row, 0) - per_row
    sorted_ids, order = torch.sort(ids, stable=True)
    rank = torch.empty_like(ids)
    rank[order] = torch.arange(ids.numel(), device=ids.device) - (torch.cumsum(counts, 0)
                                                                   - counts)[sorted_ids]
    slots = int(per_row.sum())
    partials = torch.zeros((slots, *vals.shape[1:]), dtype=acc, device=vals.device)
    partials.index_add_(0, first[ids] + rank // stretch, vals.to(acc))
    slot_row = torch.repeat_interleave(torch.arange(n, device=ids.device), per_row,
                                       output_size=slots)
    return out.index_add_(0, slot_row, partials).to(vals.dtype)
