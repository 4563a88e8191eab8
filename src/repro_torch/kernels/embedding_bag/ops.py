"""Wrapper of the embedding-bag kernel (``csrc/embedding_bag.cu``).

``embedding_bag_sum(table, indices)`` keeps the signature of the reference's
``repro.kernels.embedding_bag.ops.embedding_bag_fused``: table ``(V, D)``,
indices ``(B, L)`` int32 with -1 (any negative) as padding, every index
below V, -> ``(B, D)`` sums in the table's dtype, accumulated in float32. On a
CUDA tensor it launches the kernel (float32 or bfloat16 tables) or raises; on
a CPU tensor it computes the plain version, ``ref.embedding_bag_sum_ref``;
on a ``meta`` tensor it returns an empty result. ``launches`` counts the
kernel's launches and nothing else. Every call books ``cost`` of its shapes
with the counters open on its thread (``kernels/cost.py``). The reference
pads B to a multiple of 8 for the TPU's grid; nothing here is padded.

The kernel has no backward, as the Pallas kernel has none:
``repro_torch.models.recsys.embedding_bag`` differentiates through it in
plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import kernel_call
from repro_torch.kernels.embedding_bag.ref import embedding_bag_sum_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SYMBOLS = {
    "embedding_bag_sum": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _check(table: torch.Tensor, indices: torch.Tensor) -> None:
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (V, D) tensor, got {tuple(table.shape)}")
    if indices.dtype != torch.int32 or indices.dim() != 2 or not indices.is_contiguous():
        raise ValueError(f"indices must be a contiguous (B, L) int32 tensor, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    if table.device != indices.device:
        raise ValueError(f"table on {table.device} but indices on {indices.device}")
    if indices.shape[1] >= 2**31 or table.shape[1] >= 2**31:
        raise ValueError("L and D must fit an int32")


def cost(B: int, L: int, D: int, V: int, itemsize: int,
         rows: int | None = None) -> tuple[float, float]:
    """``(flops, bytes)`` of one call: the (B, L) int32 indices read, the
    (B, D) sums written and ``rows`` table rows of D read once each. ``rows``
    is the number of distinct rows the indices name; from the shapes alone
    (``None``) it is the most they can name, min(V, B x L). No matrix product."""
    rows = min(V, B * L) if rows is None else rows
    return 0.0, float(B * L * 4 + B * D * itemsize + rows * D * itemsize)


def embedding_bag_sum(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table (V, D), indices (B, L) int32 (< 0 is padding) -> (B, D) in the
    table's dtype. L = 0 gives zeros."""
    _check(table, indices)
    (B, L), (V, D) = indices.shape, table.shape
    with kernel_call("embedding_bag", cost, B, L, D, V, table.element_size()):
        return _embedding_bag_sum(table, indices)


def _embedding_bag_sum(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    global launches
    if table.device.type == "cpu":
        return embedding_bag_sum_ref(table, indices)
    if table.device.type == "meta":
        return torch.empty((indices.shape[0], table.shape[1]), dtype=table.dtype, device="meta")
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag_sum runs on cuda or cpu, not {table.device}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16 tables, got {table.dtype}")
    (B, L), D = indices.shape, table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    lib = _build.load("embedding_bag", _SYMBOLS)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = lib.embedding_bag_sum(table.data_ptr(), indices.data_ptr(), out.data_ptr(), B, L, D,
                                _DTYPES[table.dtype], stream)
    _build.check(lib, err, "embedding_bag_sum")
    launches += 1
    return out
