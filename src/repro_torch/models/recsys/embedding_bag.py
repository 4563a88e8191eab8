"""EmbeddingBag of the port (a copy of ``repro.models.recsys.embedding_bag``).

``embedding_bag(table, indices, weights=None, mode=)`` takes dense (B, L)
bags with padding as an index < 0; ``ragged_embedding_bag`` takes CSR-style
flat indices and segment ids. An unweighted ``sum`` (and the ``mean`` made
from it) goes through ``kernels.embedding_bag.ops``: the CUDA kernel on the
card, its plain version on the CPU. ``max``, weighted bags and the ragged
form stay plain PyTorch, as XLA computes them in the reference, where no
Pallas kernel does.

The kernel has no backward (the reference's has none either: JAX
differentiates its XLA path). ``bag_sum`` wraps it in an autograd Function
whose backward is plain PyTorch: the output gradient of each bag added into
the table rows of its valid indices (padding slots add 0 into row 0).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops

MODES = ("sum", "mean", "max")


class _BagSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices):
        ctx.save_for_backward(indices)
        ctx.table_shape = table.shape
        return bag_ops.embedding_bag_sum(table, indices)

    @staticmethod
    def backward(ctx, grad):
        # every slot adds its bag's gradient into its row, a padding slot 0 into row 0: shapes
        # that do not depend on the data, as the reference's scatter-add has
        (indices,) = ctx.saved_tensors
        valid = (indices >= 0).unsqueeze(-1)
        rows = indices.clamp(min=0).long().reshape(-1)
        src = torch.where(valid, grad.unsqueeze(1), 0).reshape(-1, grad.shape[-1])
        return grad.new_zeros(ctx.table_shape).index_add_(0, rows, src), None


def bag_sum(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The sum of each bag's valid rows, one kernel launch on the card;
    differentiable in ``table``."""
    return _BagSum.apply(table, indices)


def bag_mean_from_sum(total: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``mode="mean"`` from the bags' sums: the sum over ``max(count, 1e-9)``,
    the reference's arithmetic (an empty bag gives 0)."""
    count = (indices >= 0).sum(dim=1, keepdim=True).to(total.dtype)
    return total / count.clamp(min=1e-9)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """Dense-batch bag: indices (B, L) int32 -> (B, D). Padding = index < 0."""
    if mode not in MODES:
        raise ValueError(mode)
    if weights is None and mode != "max":
        total = bag_sum(table, indices)
        return total if mode == "sum" else bag_mean_from_sum(total, indices)
    mask = indices >= 0
    emb = table[indices.clamp(min=0).long()]             # (B, L, D)
    m = mask.unsqueeze(-1).to(emb.dtype)
    if weights is not None:
        m = m * weights.unsqueeze(-1).to(emb.dtype)
    emb = emb * m
    if mode == "sum":
        return emb.sum(dim=1)
    if mode == "mean":
        return emb.sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)
    return torch.where(mask.unsqueeze(-1), emb, float("-inf")).amax(dim=1)


def ragged_embedding_bag(table: torch.Tensor, flat_indices: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int, mode: str = "sum"):
    """CSR-style ragged bag: flat indices + segment ids -> (n_bags, D). An
    empty bag is 0 for ``sum`` and ``mean`` and -inf for ``max``."""
    if mode not in MODES:
        raise ValueError(mode)
    emb = table[flat_indices.long()]
    seg = segment_ids.long()
    if mode == "max":
        out = emb.new_full((n_bags, emb.shape[-1]), float("-inf"))
        return out.scatter_reduce(0, seg.unsqueeze(-1).expand_as(emb), emb, "amax")
    total = emb.new_zeros((n_bags, emb.shape[-1])).index_add(0, seg, emb)
    if mode == "sum":
        return total
    count = emb.new_zeros(n_bags).index_add(0, seg, torch.ones_like(seg, dtype=emb.dtype))
    return total / count.clamp(min=1e-9).unsqueeze(-1)
