"""Plain PyTorch version of the embedding-bag kernel.

The masked gather and sum of ``repro.models.recsys.embedding_bag`` in its
``mode="sum"``: padding (an index < 0) reads row 0 and is multiplied by 0.
It sums in float32 (in float64 for a float64 table) and returns the table's
dtype, as the kernel does; the order of the float32 additions is PyTorch's.
"""

from __future__ import annotations

import torch


def embedding_bag_sum_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table (V, D), indices (B, L) int32 (< 0 is padding) -> (B, D)."""
    acc = torch.promote_types(table.dtype, torch.float32)
    mask = (indices >= 0).unsqueeze(-1).to(acc)
    emb = table.index_select(0, indices.clamp(min=0).reshape(-1))
    emb = emb.reshape(*indices.shape, table.shape[1]).to(acc)
    return (emb * mask).sum(dim=1).to(table.dtype)
