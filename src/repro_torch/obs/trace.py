"""Nested-span tracer with Chrome ``trace_event`` export (copy of
``repro.obs.trace``).

The hot paths carry spans permanently: ``kcore.decompose`` and
``kcore.round`` around the host round loop (core/kcore.py),
``fused-converge`` with its ``device-converge`` and ``stats-reconstruct``
children (core/runtime.py), the streaming engine's ``batch`` with its
phases (streaming/engine.py), ``window.advance`` with ``window.diff``
(temporal/window.py). ``record`` adds the nvcc builds' ``kernel.build``
spans (core/jit_telemetry.py) and the invariant monitor's
``health.anomaly`` events (obs/health.py).

Design constraints, in order:

  1. **Zero cost when disabled.** The disabled path is one attribute check
     returning a shared no-op span: no timestamps, no allocation.
  2. **Dependency-free.** stdlib only.
  3. **Thread-safe.** Spans nest per thread (a ``threading.local`` stack);
     the finished-event list is lock-protected.

Phase spans may tile their parent: a span opened with ``start_ns`` (the
previous phase's ``end_ns``, or the parent's ``start_ns``) starts where
that one ended, and a parent closed with ``end_at`` (its last phase's
``end_ns``) ends where it did, so no stretch of the parent lies outside its
children however the thread is scheduled between them (the streaming
engine's ``batch``).

Export is the Chrome ``trace_event`` JSON array-of-complete-events format
(``ph: "X"``), loadable in Perfetto or ``chrome://tracing``. Timestamps come
from ``time.perf_counter_ns`` (monotonic), reported in microseconds. Spans
time the host: a span around device work measures the device only where
the code inside it synchronizes (``device-converge`` does).

    from repro_torch.obs import trace

    trace.enable()
    with trace.span("kcore.decompose", graph="EEN") as sp:
        sp.set(rounds=3, messages=1234)
    trace.export("out.json")
"""

from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op span returned while tracing is disabled."""

    __slots__ = ()
    start_ns = end_ns = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end_at(self, t_ns) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One live span: a context manager that records a complete event.
    ``start_ns`` is its start on ``time.perf_counter_ns``'s clock (given, or
    the clock at entry) and ``end_ns`` its end once it has closed (the clock
    at exit, or the time ``end_at`` gave)."""

    __slots__ = ("_tracer", "name", "attrs", "start_ns", "end_ns")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict, start_ns: int | None = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.start_ns = start_ns
        self.end_ns = None

    def set(self, **attrs) -> "Span":
        """Attach attributes to this span (shows up under ``args``)."""
        self.attrs.update(attrs)
        return self

    def end_at(self, t_ns: int | None) -> None:
        """Close at ``t_ns`` (a time already passed, such as the end of
        this span's last child) instead of the clock at exit."""
        self.end_ns = t_ns

    def __enter__(self) -> "Span":
        self._tracer._stack().append(self)
        if self.start_ns is None:
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.end_ns is None:
            self.end_ns = time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._emit(self.name, self.start_ns, self.end_ns - self.start_ns, self.attrs)
        return False


class Tracer:
    """A span recorder. Most callers use the module-level default tracer."""

    def __init__(self):
        self._enabled = False
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------------------ #
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Drop every recorded event (keeps the enabled flag)."""
        with self._lock:
            self._events = []

    # ------------------------------------------------------------------ #
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _emit(self, name: str, t0_ns: int, dur_ns: int, attrs: dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": t0_ns / 1e3,          # Chrome wants microseconds
            "dur": max(dur_ns, 0) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if attrs:
            ev["args"] = dict(attrs)
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------------ #
    def span(self, name: str, start_ns: int | None = None, **attrs):
        """Context manager for one nested span (no-op while disabled),
        starting at ``start_ns`` where given (the end of the sibling before
        it, or its parent's start, so that phase spans tile their parent)."""
        if not self._enabled:
            return NULL_SPAN
        return Span(self, name, attrs, start_ns)

    def current(self) -> Span | None:
        """The innermost open span on this thread, if any."""
        stack = self._stack()
        return stack[-1] if stack else None

    def annotate(self, **attrs) -> None:
        """Attach attributes to the innermost open span (no-op otherwise)."""
        if not self._enabled:
            return
        cur = self.current()
        if cur is not None:
            cur.set(**attrs)

    def record(self, name: str, dur_s: float, **attrs) -> None:
        """Record an already-elapsed duration as a span ending *now*.

        For work measured elsewhere, where only the duration is known (the
        invariant monitor's ``health.anomaly`` events, of duration 0): the
        span is synthesized as ending at the current clock, so it lands
        inside whatever span was open while the work ran.
        """
        if not self._enabled:
            return
        dur_ns = max(int(dur_s * 1e9), 0)
        self._emit(name, time.perf_counter_ns() - dur_ns, dur_ns, attrs)

    # ------------------------------------------------------------------ #
    def events(self) -> list[dict]:
        """A snapshot copy of every finished event."""
        with self._lock:
            return [dict(e) for e in self._events]

    def chrome_trace(self) -> dict:
        """The Chrome ``trace_event`` document (Perfetto-loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ---------------------------------------------------------------------- #
# Process-wide default tracer — what the engines instrument against.
# ---------------------------------------------------------------------- #

_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT


def enabled() -> bool:
    return _DEFAULT.enabled


def enable() -> None:
    _DEFAULT.enable()


def disable() -> None:
    _DEFAULT.disable()


def reset() -> None:
    _DEFAULT.reset()


def span(name: str, **attrs):
    return _DEFAULT.span(name, **attrs)


def current() -> Span | None:
    return _DEFAULT.current()


def annotate(**attrs) -> None:
    _DEFAULT.annotate(**attrs)


def record(name: str, dur_s: float, **attrs) -> None:
    _DEFAULT.record(name, dur_s, **attrs)


def events() -> list[dict]:
    return _DEFAULT.events()


def chrome_trace() -> dict:
    return _DEFAULT.chrome_trace()


def export(path: str) -> str:
    return _DEFAULT.export(path)
