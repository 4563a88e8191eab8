"""The hand-written kernels' work, booked once per call from their shapes.

Each kernel's ``ops.py`` has a cost function that returns ``(flops, bytes)``
for one call: the bytes count each input read once and each output written
once, the FLOPs the multiply-adds of its matrix products (2 a product), as
``launch/step_cost.py`` counts an ``mm``. The wrappers book that cost on
every device (the CUDA kernel, the plain version on the CPU, and a
``meta`` tensor's empty result) through ``kernel_call``, so that a
counter (``launch.step_cost.StepCounter``) sees the kernel once, whatever
implements it: the kernels are bound with ``ctypes`` and no dispatch mode
sees them, and the aten ops of a plain version run inside ``kernel_call``
are left uncounted (``is_uncounted``).

A counter is a ``TorchDispatchMode`` with a ``book`` method, and it is open
where its mode is: on the thread that entered it, and on the autograd
engine's threads while they run that thread's backward (a checkpoint's
recompute), to which PyTorch carries the mode stack. A kernel called on
another thread is not booked with it. Nothing here touches a device. With
no dispatch mode on the calling thread, ``kernel_call`` and ``uncounted``
read the stack's length and do nothing else: the cost function is not
called.
"""

from __future__ import annotations

import threading

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

_local = threading.local()     # depth of uncounted (and kernel_call) bodies on this thread


def open_counters() -> list:
    """The counters open on this thread: the dispatch modes on its stack
    that take bookings, outermost first."""
    if not torch._C._len_torch_dispatch_stack():
        return []
    return [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "book")]


class uncounted:
    """Run the body with its aten ops left out of every count: a kernel's
    own work, booked apart, or the float kernel's work table, which a
    ``meta`` layout does not build."""

    __slots__ = ("_on",)

    def __enter__(self):
        self._on = bool(torch._C._len_torch_dispatch_stack())
        if self._on:
            _local.depth = getattr(_local, "depth", 0) + 1

    def __exit__(self, *exc):
        if self._on:
            _local.depth -= 1


class kernel_call(uncounted):
    """Book one call of ``kernel``, whose ``(flops, bytes)`` are
    ``cost(*shape)`` (products in ``dtype``), with every counter open on
    this thread, and run the body (a launch, a plain version, an empty meta
    result) with the aten ops in it uncounted. ``cost`` runs only while a
    counter is open."""

    __slots__ = ()

    def __init__(self, kernel: str, cost, *shape, dtype=None):
        counters = open_counters()
        if counters:
            flops, nbytes = cost(*shape)
            for c in counters:
                c.book(kernel, flops, nbytes, dtype)


def is_uncounted() -> bool:
    """Whether this thread is inside ``uncounted`` (or ``kernel_call``)."""
    return getattr(_local, "depth", 0) > 0
