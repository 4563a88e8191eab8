"""FLOPs and bytes of one step (the port of ``repro.launch.jaxpr_cost``).

The reference walks a step's jaxpr. The port has no jaxpr: ``step_cost``
runs the step under ``StepCounter``, a ``TorchDispatchMode`` that sees every
aten op the step runs, on whatever device its tensors lie (``meta`` tensors
give the count of a full-size step without memory or a card):

  * FLOPs: the matrix products ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``dot`` and convolutions at 2 x batch x M x N x K, as the
    reference counts ``dot_general`` and ``conv_general_dilated``;
  * bytes: every input and output of the memory-traffic ops, the aten
    counterparts of the reference's ``_MEM_OPS`` (``MEM_OPS``): gathers and
    scatters, ``index_select``/``index_add``, sort, topk, cumsum, sum
    reductions, slice updates and the products themselves. Elementwise ops
    are not counted: a fusing compiler folds them into these;
  * the hand-written kernels: each books its cost function's work once a
    call (``kernels/cost.py``), on the card, on the CPU's plain version and
    on ``meta``, and the aten ops of a plain version are left out.
    ``by_kernel`` keeps each kernel's calls, FLOPs and bytes.

The reference multiplies a ``lax.scan`` body by its trip count; the port's
loops are Python loops, which the mode sees once an iteration, so the
count is exact without it (and ``repro.models.util.scan_unroll`` has no
counterpart). A recompute under ``torch.utils.checkpoint`` is counted when
the backward runs it, as the reference counts remat.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as kcost

aten = torch.ops.aten

_MM = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
       aten.mv.default, aten.addmv.default, aten.dot.default}
_CONV = {aten.convolution.default, aten._convolution.default}

# the aten ops whose operands stream through memory once each (the reference's
# _MEM_OPS: dot_general, conv, gather, scatter(-add), dynamic_(update_)slice,
# take, sort, top_k, reduce_sum, segment_sum, cumsum, argsort)
MEM_OPS = {
    "matmul": _MM | _CONV | {aten.convolution_backward.default},
    "gather": {aten.gather.default, aten.index_select.default, aten.index.Tensor,
               aten.embedding.default, aten.take.default},
    "scatter": {aten.scatter.src, aten.scatter.value, aten.scatter_add.default,
                aten.scatter_reduce.two, aten.index_add.default, aten.index_add_.default,
                aten.index_put.default, aten.index_put_.default, aten.index_copy.default,
                aten.embedding_dense_backward.default, aten.scatter_add_.default,
                aten.scatter_.src, aten.scatter_.value},
    "slice_update": {aten.slice_scatter.default, aten.select_scatter.default},
    "sort": {aten.sort.default, aten.sort.stable},
    "topk": {aten.topk.default},
    "cumsum": {aten.cumsum.default},
    "reduce_sum": {aten.sum.dim_IntList, aten.sum.default},
}
_KIND = {op: kind for kind, ops in MEM_OPS.items() for op in ops}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_flops(func, args, out) -> float:
    """2 x batch x M x N x K of one product (convolutions: 2 x output
    elements x the kernel's elements per output channel)."""
    if func in _CONV:
        w = args[1]
        return 2.0 * out.numel() * (w.numel() / max(w.shape[0], 1))
    if func in (aten.addmm.default, aten.baddbmm.default, aten.addmv.default):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if func == aten.dot.default:
        return 2.0 * a.numel()
    if func in (aten.mv.default, aten.addmv.default):
        return 2.0 * a.shape[0] * a.shape[1]
    return 2.0 * math.prod(a.shape) * b.shape[-1]


class StepCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of the aten ops run under it, and the kernels'
    bookings. ``flops``/``bytes`` are the totals; ``flops_by_dtype`` the
    FLOPs by the products' dtype (their name: ``"bfloat16"``); ``by_kind``
    maps each ``MEM_OPS`` kind to its ``[calls, flops, bytes]``;
    ``by_kernel`` each hand-written kernel to its ``{"calls", "flops",
    "bytes"}``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_dtype: dict[str, float] = {}
        self.by_kind: dict[str, list] = {}
        self.by_kernel: dict[str, dict] = {}

    def _add_flops(self, flops: float, dtype) -> None:
        if flops:
            name = str(dtype).removeprefix("torch.")
            self.flops_by_dtype[name] = self.flops_by_dtype.get(name, 0.0) + flops
            self.flops += flops

    def book(self, kernel: str, flops: float, nbytes: float, dtype=None) -> None:
        rec = self.by_kernel.setdefault(kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self._add_flops(flops, dtype)
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _KIND.get(func)
        if kind is None or kcost.is_uncounted():
            return out
        flops = matmul_flops(func, args, out) if func in _MM or func in _CONV else 0.0
        if func == aten.convolution_backward.default:
            # the input's and the weight's gradient: each a convolution's FLOPs
            w = args[2]
            per = 2.0 * args[0].numel() * (w.numel() / max(w.shape[0], 1))
            flops = per * sum(bool(m) for m in args[-1][:2])
        nbytes = sum(_nbytes(t) for t in _tensors(list(args) + list((kwargs or {}).values())))
        nbytes += sum(_nbytes(t) for t in _tensors(out))
        rec = self.by_kind.setdefault(kind, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self._add_flops(flops, args[0].dtype if isinstance(args[0], torch.Tensor) else out.dtype)
        self.bytes += nbytes
        return out


def step_cost(fn, *args, counter: StepCounter | None = None) -> tuple[float, float]:
    """``(FLOPs, bytes)`` of ``fn(*args)`` run once under a ``StepCounter``
    (``counter``, to keep its ``by_kind`` and ``by_kernel``)."""
    counter = StepCounter() if counter is None else counter
    with counter:
        fn(*args)
    return counter.flops, counter.bytes
