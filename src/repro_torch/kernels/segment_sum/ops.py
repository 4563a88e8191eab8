"""Wrappers of the segment-sum kernels (``csrc/segment_sum.cu``).

``segment_sum(vals, row_ptr)`` sums int32 values over CSR rows: the arcs of
a graph sorted by source, with ``Graph.offsets`` as ``row_ptr``. On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it computes the
plain version, ``ref.segment_sum_ref``; on a ``meta`` tensor it returns an
empty result. ``launches`` counts the kernel's launches and nothing else:
one a call, which runs the search for the blocks' starts, the merge-path
pass and the small pass over its carries. Every call of either form books
its cost function's ``(flops, bytes)`` (``cost``, ``float_cost``) with the
counters open on its thread (``kernels/cost.py``).

Segment ids in any order go through ``csr_layout``, a host-side stable
argsort: ``segment_sum(vals[layout.order], layout.row_ptr)``. The reference's
``blocked_layout`` padding exists for the TPU's sequential grid and is not
ported.

``segment_sum_float(vals, layout)`` is the float form, the GNNs' scatter:
``vals`` (E,) or (E, F) float32 or bf16 in the edges' own order, summed per
segment into (n,) or (n, F) through a ``SegmentLayout`` (``segment_layout``
builds one on the ids' device, once per graph or batch). Each row's terms,
in edge order, are cut into stretches of ``STRETCH`` consecutive arcs (the
last may be shorter); each stretch is summed in float32 from 0 in edge
order, the row's stretch partials are added in float32 from 0 in stretch
order, and the sum is rounded once. A row of at most ``STRETCH`` arcs is
one stretch, summed in edge order as a single float32 sum. The result
depends on nothing but the row's own terms, so it is the same run to run
and wherever the other rows lie. Every layout carries the kernel's work
table (``StretchTable``: its rows wider than a stretch and their stretches,
and the other rows in batches), derived from ``row_ptr`` when the layout is
made. On the CPU it is the plain
version, ``ref.segment_sum_float_ref``; on the card it launches its kernel
or raises. It is differentiable on both devices through one
``torch.autograd.Function``: the backward is the gather ``grad_out[ids]`` in
``vals``' dtype, which is what ``jax.ops.segment_sum``'s VJP is, so no
kernel runs there. ``float_launches`` counts the forward's calls of the
kernel apart from the int32 kernel's: one a call, which runs the stretches'
pass and, where some row is wider than a stretch, the pass that adds their
partials. A layout of ``meta`` ids carries no work table and its ids are not
range-checked: it serves to count a step's work (``launch/step_cost.py``),
where the forward returns an empty result.

``segment_sum_float_partial(vals, layout)`` is the same sum left unrounded:
float32 out of float32 or bf16 values (float64 out of float64 on the CPU),
the bits that the float form rounds once. A shard's partial of the GNNs'
sharded scatter is one (``models/gnn/common.py``): the shards' partials are
added in shard order before the one rounding. On the card bf16 values go
through the kernel's bf16-in, float32-out entry; it is counted in
``float_launches`` and booked as ``segment_sum_float`` with
``float_partial_cost``. Its backward is the gather in ``vals``' dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import kernel_call, uncounted
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

# The float form's stretch (csrc/segment_sum.cu's kStretch): arcs summed
# together before a row's partials are added. Part of the function's
# definition, so changing it changes bits; the kernel refuses any other value.
STRETCH = 128
# Rows and arcs a batch of the float kernel's whole rows spans (``StretchTable``;
# csrc/segment_sum.cu's kBatchItems): the kernel merges batches into items of
# about 8 KB a warp for the row width at hand. No bits depend on it.
BATCH_ITEMS = 4

_SYMBOLS = {
    "segment_sum_i32": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_void_p],
    **{f"segment_sum_float_{t}": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
       for t in ("f32", "bf16", "bf16_f32")},
}
_FLOAT_SYMBOL = {torch.float32: "segment_sum_float_f32", torch.bfloat16: "segment_sum_float_bf16"}
# float32 out: the unrounded sums of ``segment_sum_float_partial``
_PARTIAL_SYMBOL = {torch.float32: "segment_sum_float_f32",
                   torch.bfloat16: "segment_sum_float_bf16_f32"}
# The float kernel's two int64 ticket counters, one pair a (device, stream),
# zeroed once: a call leaves them at 0, and calls on one stream never overlap.
_TICKETS: dict = {}


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


def cost(E: int, n: int) -> tuple[float, float]:
    """``(flops, bytes)`` of one int32 call over E arcs and n rows: the values
    and the n+1 int64 offsets read once, the sums written once; no floating
    point."""
    return 0.0, float(4 * E + 8 * (n + 1) + 4 * n)


def float_cost(E: int, n: int, F: int, itemsize: int) -> tuple[float, float]:
    """``(flops, bytes)`` of one float call, (E, F) values of ``itemsize``
    bytes into n rows: the values, the int64 order and offsets read once, the
    sums written once. Additions only, so no FLOPs are booked, as no matrix
    product is done."""
    return 0.0, float(E * F * itemsize + 8 * E + 8 * (n + 1) + n * F * itemsize)


def float_partial_cost(E: int, n: int, F: int, itemsize: int) -> tuple[float, float]:
    """``(flops, bytes)`` of one unrounded call: as ``float_cost``, but the
    n x F sums are written as float32."""
    return 0.0, float(E * F * itemsize + 8 * E + 8 * (n + 1) + n * F * 4)


def float_backward_cost(E: int, n: int, F: int, itemsize: int) -> tuple[float, float]:
    """``(flops, bytes)`` of the float form's backward, the gather
    ``grad_out[ids]``: the (n, F) gradient and the int64 ids read, the (E, F)
    result written. It is no kernel: ``step_cost`` counts it as the
    ``index_select`` it is."""
    return 0.0, float(n * F * itemsize + 8 * E + E * F * itemsize)


def segment_sum(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-row sums: vals (E,) int32 in row order, row_ptr (n+1,) int64
    non-decreasing with row_ptr[0] == 0 and row_ptr[n] == E -> (n,) int32.
    Empty rows are 0."""
    _check(vals, row_ptr)
    with kernel_call("segment_sum", cost, vals.numel(), row_ptr.numel() - 1):
        return _segment_sum(vals, row_ptr)


def _segment_sum(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    global launches
    if vals.device.type == "cpu":
        return segment_sum_ref(vals, row_ptr)
    n, E = row_ptr.numel() - 1, vals.numel()
    if vals.device.type == "meta":
        return torch.empty(n, dtype=torch.int32, device="meta")
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {vals.device}")
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
class StretchTable:
    """The float kernel's work table of a layout, built with it. The rows
    wider than ``STRETCH`` arcs and their stretches: ``rows`` (W,) int64
    ascending; ``ptr`` (W+1,) int64, row ``rows[w]``'s ceil(d / STRETCH)
    stretches being [ptr[w], ptr[w+1]) (their slots in the kernel's float32
    scratch of partials); ``owner`` (ptr[W],) int64, each stretch's w. The
    other rows, empty ones included, are summed whole, in batches:
    ``batches`` (B+1,) int64, the first row of each batch and then n. A batch
    holds the rows whose start falls in one block of ``BATCH_ITEMS`` rows and
    arcs (a wide row's arcs not counted), so it has at most ``BATCH_ITEMS``
    rows and ``BATCH_ITEMS + STRETCH`` arcs."""

    rows: torch.Tensor
    ptr: torch.Tensor
    owner: torch.Tensor
    batches: torch.Tensor


def stretch_table(row_ptr: torch.Tensor, width: int | None = None) -> StretchTable:
    """The ``StretchTable`` of CSR offsets ``row_ptr`` (n+1,) int64, on their
    device. Where every row has ``width`` arcs, it is computed from n and
    ``width`` alone, without reading ``row_ptr`` back from the device."""
    dev, n = row_ptr.device, row_ptr.numel() - 1
    if width is not None:
        return _uniform_table(n, width, dev)
    d = row_ptr[1:] - row_ptr[:-1]
    wide = d > STRETCH
    rows = torch.nonzero(wide).flatten()
    ptr = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=dev)
    owner = rows[:0]
    if rows.numel():
        per_row = (d[rows] + STRETCH - 1) // STRETCH
        torch.cumsum(per_row, 0, out=ptr[1:])
        owner = torch.repeat_interleave(torch.arange(rows.numel(), device=dev), per_row)
    # a row's start on the path of rows and narrow arcs, and the block of it
    narrow = torch.where(wide, 0, d)
    block = (torch.arange(n, device=dev) + torch.cumsum(narrow, 0) - narrow) // BATCH_ITEMS
    first = torch.ones_like(wide)
    first[1:] = block[1:] != block[:-1]
    batches = torch.cat([torch.nonzero(first).flatten(),
                         torch.tensor([n], dtype=torch.int64, device=dev)])
    return StretchTable(rows=rows, ptr=ptr, owner=owner, batches=batches)


def _uniform_table(n: int, width: int, dev) -> StretchTable:
    """``stretch_table`` of n rows of ``width`` arcs each, by arithmetic."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=dev)
    end = torch.tensor([n], dtype=torch.int64, device=dev)
    if width > STRETCH:
        per = -(-width // STRETCH)
        return StretchTable(rows=ar(n), ptr=ar(n + 1) * per,
                            owner=ar(n).repeat_interleave(per, output_size=n * per),
                            batches=torch.cat([ar(0, n, BATCH_ITEMS), end]))
    step = width + 1  # row r starts at r x step on the path; its block is that // BATCH_ITEMS
    if step >= BATCH_ITEMS:
        batches = ar(n + 1)
    else:  # every block holds a start; block k's first is ceil(k x BATCH_ITEMS / step)
        k = ar((n - 1) * step // BATCH_ITEMS + 1 if n else 0)
        batches = torch.cat([(k * BATCH_ITEMS + step - 1) // step, end])
    return StretchTable(rows=ar(0), ptr=end * 0, owner=ar(0), batches=batches)


@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """CSR layout of segment ids on a device: ``ids`` (E,) int64 as given,
    ``order`` (E,) int64 a stable argsort of them, ``row_ptr`` (n+1,) int64
    the offsets of each segment's run in ``order``; ``width``, where the
    caller built ``row_ptr`` with the same number of arcs in every row, that
    number. ``stretches``, the ``StretchTable`` of ``row_ptr``, is derived
    when the layout is made (by arithmetic where ``width`` is given)."""

    ids: torch.Tensor
    order: torch.Tensor
    row_ptr: torch.Tensor
    width: int | None = None
    stretches: StretchTable = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.row_ptr.device.type != "meta":
            with uncounted():      # the kernel's own table: a meta layout has none to count
                object.__setattr__(self, "stretches", stretch_table(self.row_ptr, self.width))

    @property
    def n(self) -> int:
        return self.row_ptr.numel() - 1


def segment_layout(ids, n: int, device=None) -> SegmentLayout:
    """The layout of segment ids ``ids`` (E,) in [0, n), on ``device`` (the
    ids' own if None): a stable ``torch.sort`` and a search of its result."""
    ids = torch.as_tensor(ids, device=device).to(torch.int64)
    if ids.dim() != 1:
        raise ValueError(f"segment ids must be 1-D, got {tuple(ids.shape)}")
    if ids.numel() and ids.device.type != "meta" and (int(ids.min()) < 0 or int(ids.max()) >= n):
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
        F = vals.shape[1] if vals.dim() == 2 else 1
        with kernel_call("segment_sum_float", float_cost, vals.shape[0], layout.n, F,
                         vals.element_size()):
            if vals.device.type == "cpu":
                return segment_sum_float_ref(vals, layout.ids, layout.n)
            if vals.device.type == "meta":
                return vals.new_empty((layout.n, *vals.shape[1:]))
            return _launch_float(vals, layout)

    @staticmethod
    def backward(ctx, grad_out):
        return grad_out.index_select(0, ctx.layout.ids).to(ctx.dtype), None


class _SegmentSumPartial(torch.autograd.Function):
    """The unrounded float segment sum with the gather as its backward."""

    @staticmethod
    def forward(ctx, vals, layout):
        ctx.layout, ctx.dtype = layout, vals.dtype
        wide = torch.float64 if vals.dtype == torch.float64 else torch.float32
        F = vals.shape[1] if vals.dim() == 2 else 1
        with kernel_call("segment_sum_float", float_partial_cost, vals.shape[0], layout.n, F,
                         vals.element_size()):
            if vals.device.type == "cpu":
                return segment_sum_float_ref(vals.to(wide), layout.ids, layout.n)
            if vals.device.type == "meta":
                return vals.new_empty((layout.n, *vals.shape[1:]), dtype=wide)
            return _launch_float(vals, layout, partial=True)

    @staticmethod
    def backward(ctx, grad_out):
        return grad_out.index_select(0, ctx.layout.ids).to(ctx.dtype), None


def _check_float(vals: torch.Tensor, layout: SegmentLayout, name: str) -> None:
    if vals.dim() not in (1, 2) or vals.shape[0] != layout.ids.numel():
        raise ValueError(f"vals must be (E,) or (E, F) with E = {layout.ids.numel()}, got "
                         f"{tuple(vals.shape)}")
    if vals.device != layout.order.device:
        raise ValueError(f"vals on {vals.device} but the layout on {layout.order.device}")
    if vals.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cuda or cpu, not {vals.device}")
    if vals.device.type == "cuda" and vals.dtype not in _FLOAT_SYMBOL:
        raise ValueError(f"the float segment-sum kernel takes float32 or bfloat16, not {vals.dtype}")


def segment_sum_float(vals: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Per-segment sums: vals (E,) or (E, F) in edge order -> (n,) or (n, F)
    in vals' dtype. Empty segments are 0. Differentiable in ``vals``."""
    _check_float(vals, layout, "segment_sum_float")
    return _SegmentSumFloat.apply(vals, layout)


def segment_sum_float_partial(vals: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """``segment_sum_float``'s sums before their rounding: (n,) or (n, F)
    in float32 (float64 for float64 values). Differentiable in ``vals``."""
    _check_float(vals, layout, "segment_sum_float_partial")
    return _SegmentSumPartial.apply(vals, layout)


def _tickets(device: torch.device) -> torch.Tensor:
    """The float kernel's ticket counters for the current stream on ``device``."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _TICKETS[key]


def _launch_float(vals: torch.Tensor, layout: SegmentLayout, partial: bool = False) -> torch.Tensor:
    """One call of the float kernel on checked CUDA ``vals``: the stretches'
    and batches' pass and, where ``layout`` has rows wider than a stretch,
    the pass that adds their partials (float32 scratch, one row of F a
    stretch; the stream's ticket counters, ``_tickets``). With ``partial``
    the sums are written unrounded, as float32."""
    global float_launches
    v = vals.unsqueeze(1) if vals.dim() == 1 else vals
    E, F = v.shape
    if F == 0:
        return vals.new_zeros((layout.n, 0), dtype=torch.float32 if partial else vals.dtype)
    if v.stride(1) != 1 or (E > 1 and v.stride(0) < F):
        v = v.contiguous()
    ld = v.stride(0) if E > 1 else F
    out = torch.empty((layout.n, F), dtype=torch.float32 if partial else vals.dtype,
                      device=vals.device)
    if layout.n:
        lib = _build.load("segment_sum", _SYMBOLS)
        st = layout.stretches
        partials = (torch.empty((st.owner.numel(), F), dtype=torch.float32, device=vals.device)
                    if st.owner.numel() else None)
        tickets = _tickets(vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = getattr(lib, (_PARTIAL_SYMBOL if partial else _FLOAT_SYMBOL)[vals.dtype])(
            v.data_ptr(), ld, layout.order.data_ptr(), layout.row_ptr.data_ptr(),
            st.rows.data_ptr(), st.ptr.data_ptr(), st.owner.data_ptr(), st.batches.data_ptr(),
            out.data_ptr(), partials.data_ptr() if partials is not None else None,
            tickets.data_ptr(), layout.n, F,
            st.rows.numel(), st.owner.numel(), st.batches.numel() - 1, STRETCH, stream)
        _build.check(lib, err, "segment_sum_float")
        float_launches += 1
    return out.squeeze(1) if vals.dim() == 1 else out
