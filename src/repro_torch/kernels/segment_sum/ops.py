"""Wrappers of the segment-sum kernels (``csrc/segment_sum.cu``).

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

``segment_sum_float(vals, layout)`` is the float form, the GNNs' scatter:
``vals`` (E,) or (E, F) float32 or bf16 in the edges' own order, summed per
segment into (n,) or (n, F) through a ``SegmentLayout`` (``segment_layout``
builds one on the ids' device, once per graph or batch). Each row's terms
are added in float32 in edge order and rounded once, so the result is the
same run to run. On the CPU it is the plain version,
``ref.segment_sum_float_ref``; on the card it launches its kernel or raises.
It is differentiable on both devices through one ``torch.autograd.Function``:
the backward is the gather ``grad_out[ids]`` in ``vals``' dtype, which is
what ``jax.ops.segment_sum``'s VJP is, so no kernel runs there.
``float_launches`` counts the forward's launches apart from the int32
kernel's.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum.ref import segment_sum_float_ref, segment_sum_ref

launches = 0
float_launches = 0

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
    **{f"segment_sum_float_{t}": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_void_p] for t in ("f32", "bf16")},
}
_FLOAT_SYMBOL = {torch.float32: "segment_sum_float_f32", torch.bfloat16: "segment_sum_float_bf16"}


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



@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """CSR layout of segment ids on a device: ``ids`` (E,) int64 as given,
    ``order`` (E,) int64 a stable argsort of them, ``row_ptr`` (n+1,) int64
    the offsets of each segment's run in ``order``."""

    ids: torch.Tensor
    order: torch.Tensor
    row_ptr: torch.Tensor

    @property
    def n(self) -> int:
        return self.row_ptr.numel() - 1


def segment_layout(ids, n: int, device=None) -> SegmentLayout:
    """The layout of segment ids ``ids`` (E,) in [0, n), on ``device`` (the
    ids' own if None): a stable ``torch.sort`` and a search of its result."""
    ids = torch.as_tensor(ids, device=device).to(torch.int64)
    if ids.dim() != 1:
        raise ValueError(f"segment ids must be 1-D, got {tuple(ids.shape)}")
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"segment ids must lie in [0, {n})")
    sorted_ids, order = torch.sort(ids, stable=True)
    row_ptr = torch.searchsorted(sorted_ids, torch.arange(n + 1, device=ids.device))
    return SegmentLayout(ids=ids, order=order, row_ptr=row_ptr)


class _SegmentSumFloat(torch.autograd.Function):
    """The float segment sum with the gather as its backward; the forward is
    the kernel on a CUDA tensor and the plain version on a CPU one."""

    @staticmethod
    def forward(ctx, vals, layout):
        ctx.layout, ctx.dtype = layout, vals.dtype
        if vals.device.type == "cpu":
            return segment_sum_float_ref(vals, layout.ids, layout.n)
        return _launch_float(vals, layout)

    @staticmethod
    def backward(ctx, grad_out):
        return grad_out.index_select(0, ctx.layout.ids).to(ctx.dtype), None


def segment_sum_float(vals: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Per-segment sums: vals (E,) or (E, F) in edge order -> (n,) or (n, F)
    in vals' dtype. Empty segments are 0. Differentiable in ``vals``."""
    if vals.dim() not in (1, 2) or vals.shape[0] != layout.ids.numel():
        raise ValueError(f"vals must be (E,) or (E, F) with E = {layout.ids.numel()}, got "
                         f"{tuple(vals.shape)}")
    if vals.device != layout.order.device:
        raise ValueError(f"vals on {vals.device} but the layout on {layout.order.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_sum_float runs on cuda or cpu, not {vals.device}")
    if vals.device.type == "cuda" and vals.dtype not in _FLOAT_SYMBOL:
        raise ValueError(f"the float segment-sum kernel takes float32 or bfloat16, not {vals.dtype}")
    return _SegmentSumFloat.apply(vals, layout)


def _launch_float(vals: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """One launch of the float kernel on checked CUDA ``vals``."""
    global float_launches
    v = vals.unsqueeze(1) if vals.dim() == 1 else vals
    E, F = v.shape
    if F == 0:
        return vals.new_zeros((layout.n, 0))
    if v.stride(1) != 1 or (E > 1 and v.stride(0) < F):
        v = v.contiguous()
    ld = v.stride(0) if E > 1 else F
    out = torch.empty((layout.n, F), dtype=vals.dtype, device=vals.device)
    if layout.n:
        lib = _build.load("segment_sum", _SYMBOLS)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = getattr(lib, _FLOAT_SYMBOL[vals.dtype])(
            v.data_ptr(), ld, layout.order.data_ptr(), layout.row_ptr.data_ptr(),
            out.data_ptr(), layout.n, F, stream)
        _build.check(lib, err, "segment_sum_float")
        float_launches += 1
    return out.squeeze(1) if vals.dim() == 1 else out
