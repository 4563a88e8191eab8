"""Sliding-window k-core maintenance over a timestamped event stream (the
port of ``repro.temporal.window``).

``WindowedKCoreEngine`` slides a window over an ``EventLog`` and turns each
advance into one ``EdgeBatch`` for the port's ``StreamingKCoreEngine``:
events entering at the head whose edges become present are inserts, edges
expiring out of the tail (or removed by in-window remove events) are
deletes. The engine therefore maintains EXACT core numbers of the window
graph at every boundary — the window semantics are defined by
``EventLog.edges_between`` (replay-from-empty / last-event-wins), and the
batch fed downstream is precisely the set difference between consecutive
window edge sets, so advancing by k strides is equivalent to applying one
explicit EdgeBatch.

Two window kinds, both with configurable stride:

  * ``by="count"`` — the window covers the last ``window`` events; a stride
    admits ``stride`` new events (uniform event-rate slicing);
  * ``by="time"``  — the window covers timestamps in [t_hi - window, t_hi);
    a stride advances t_hi by ``stride`` (wall-clock slicing; steps see as
    many events as actually arrived).

The vertex universe is fixed to ``log.n`` up front so core vectors are
comparable across the whole replay (an absent vertex has core 0), and the
frontier modes (and a mesh, with its ``axis_names``) pass straight through
to the maintenance engine. The window size
pre-seeds the CSR's per-row slack (``min_slack``) so a replay-from-empty
does not compact on every insert. The reference also pre-seeds a padded
live-arc shape; the port stages the live arcs unpadded and compiles nothing
per shape, so it has no such floor.

The as-of store (``CoreCheckpointRing``) lives with the serving layer in
``streaming/server.py`` and is re-exported from ``repro_torch.temporal``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.kcore import KCoreConfig
from repro_torch.graph.structs import Graph
from repro_torch.obs import flight as _flight
from repro_torch.obs import trace as _trace
from repro_torch.streaming.delta import EdgeBatch, edge_keys
from repro_torch.streaming.engine import BatchResult, StreamingConfig, StreamingKCoreEngine
from repro_torch.temporal.events import EventLog

WINDOW_KINDS = ("count", "time")


@dataclasses.dataclass(frozen=True)
class WindowStep:
    """Outcome of one window advance."""

    step: int                 # 0-based advance index
    lo: int                   # event index range [lo, hi) of the window
    hi: int
    t_lo: float               # timestamps covered by the window
    t_hi: float
    batch: EdgeBatch          # the delta fed to the streaming engine
    result: BatchResult       # its outcome (exact cores, stats, health)
    m: int                    # edges in the window graph after the step

    @property
    def core(self) -> np.ndarray:
        return self.result.core


class WindowedKCoreEngine:
    """Exact k-core maintenance of a sliding window over an EventLog.

    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the kernels' plain versions. ``mesh`` and
    ``axis_names`` go to the maintenance engine (the engine then runs on the
    mesh's device).
    """

    def __init__(self, log: EventLog, window, stride, by: str = "count",
                 config: StreamingConfig = StreamingConfig(),
                 kcore_config: KCoreConfig = KCoreConfig(),
                 mesh=None, axis_names=("data",), *, device=None):
        if by not in WINDOW_KINDS:
            raise ValueError(f"unknown window kind {by!r}")
        if window <= 0 or stride <= 0:
            raise ValueError("window and stride must be positive")
        if by == "count":
            # count mode truncates to whole events; a fractional stride
            # would truncate to 0 and the window would never advance
            if int(window) < 1 or int(stride) < 1:
                raise ValueError("count-based window and stride must be >= 1 event")
            window, stride = int(window), int(stride)
        self.log = log
        self.by = by
        self.window = window
        self.stride = stride
        self.n = log.n
        # The engine starts on an EMPTY graph, so degree-proportional CSR
        # slack would size every row at min_slack and the first windows
        # would compact on almost every insert. Bump min_slack to the mean
        # degree the window will actually carry (slack never changes cores
        # or message bills — only patch cost and ``csr_compactions``).
        if self.n:
            if by == "count":
                w_events = float(window)
            else:
                span = max(log.t_max - log.t_min, 1e-12)
                w_events = float(window) / span * max(len(log), 1)
            est = int(np.ceil(3.0 * min(w_events, len(log)) / max(self.n, 1)))
            if est > config.min_slack:
                config = dataclasses.replace(config, min_slack=est)
        self.config = config
        empty = Graph.from_edges(np.zeros((0, 2), np.int64), n=self.n)
        self.engine = StreamingKCoreEngine(empty, config, kcore_config, mesh=mesh,
                                           axis_names=axis_names, device=device)
        # cursor: hi event index (count) / t_hi timestamp (time); the
        # window starts empty and slides in from the stream's beginning
        self._hi = 0
        self._t_hi = log.t_min
        self._edges = np.zeros((0, 2), np.int64)
        self._edges.setflags(write=False)
        self.steps_taken = 0

    # ------------------------------------------------------------------ #
    @property
    def core(self) -> np.ndarray:
        """Exact core numbers of the current window graph."""
        return self.engine.core

    @property
    def bounds(self) -> tuple[int, int]:
        """Current window as an event index range [lo, hi)."""
        if self.by == "count":
            hi = min(self._hi, len(self.log))
            return max(0, hi - int(self.window)), hi
        lo = self.log.index_at_time(self._t_hi - self.window)
        return lo, self.log.index_at_time(self._t_hi)

    @property
    def t_bounds(self) -> tuple[float, float]:
        """Current window's time span [t_lo, t_hi)."""
        if self.by == "time":
            return float(self._t_hi - self.window), float(self._t_hi)
        lo, hi = self.bounds
        t_lo = float(self.log.time[lo]) if hi > lo else float(self._t_hi)
        t_hi = float(self.log.time[hi - 1]) if hi > lo else float(self._t_hi)
        return t_lo, t_hi

    @property
    def window_edges(self) -> np.ndarray:
        """Canonical (m, 2) edge set of the current window (read-only —
        the delta bookkeeping diffs against it; callers copy to mutate)."""
        return self._edges

    @property
    def done(self) -> bool:
        """True once the window head has consumed the whole stream."""
        if self.by == "count":
            return self._hi >= len(self.log)
        return self._t_hi > self.log.t_max

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Checkpointable state: inner engine state + window position.

        The EventLog itself is NOT captured — it is an input, deterministic
        from its source (path or generator spec + seed), and typically far
        larger than the engine state. A restore therefore needs the same
        log the checkpointed run was replaying and resumes the replay in
        lockstep: identical window batches, cores, and message bills.
        """
        return {
            "engine": self.engine.state_dict(),
            "hi": np.asarray(self._hi, np.int64),
            "t_hi": np.asarray(self._t_hi, np.float64),
            "edges": np.asarray(self._edges, np.int64),
            "steps_taken": np.asarray(self.steps_taken, np.int64),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict`` output in place, onto the same log and
        window geometry this engine was constructed with, and on its
        device. No decomposition runs — the restored cores are the fixpoint
        of the restored CSR."""
        self.engine = StreamingKCoreEngine.from_state_dict(
            state["engine"], config=self.config, mesh=self.engine.mesh,
            axis_names=self.engine.axis_names, device=self.engine.device)
        self._hi = int(np.asarray(state["hi"]))
        self._t_hi = float(np.asarray(state["t_hi"]))
        edges = np.array(np.asarray(state["edges"]), np.int64).reshape(-1, 2)
        edges.setflags(write=False)
        self._edges = edges
        self.steps_taken = int(np.asarray(state["steps_taken"]))

    # ------------------------------------------------------------------ #
    def window_graph(self) -> Graph:
        """Materialize the current window graph independently of the
        engine (oracle/verification path — O(w log w))."""
        return Graph.from_edges(self._edges, n=self.n)

    def peek_batch(self, k: int = 1) -> tuple[EdgeBatch, np.ndarray]:
        """The EdgeBatch that advancing by ``k`` strides would apply, and
        the resulting window edge set — without touching the engine."""
        if k < 1:
            raise ValueError("k must be >= 1")
        if self.by == "count":
            hi = min(self._hi + k * int(self.stride), len(self.log))
            lo = max(0, hi - int(self.window))
        else:
            t_hi = self._t_hi + k * self.stride
            lo = self.log.index_at_time(t_hi - self.window)
            hi = self.log.index_at_time(t_hi)
        new_edges = self.log.edges_between(lo, hi)
        old_keys = edge_keys(self._edges, self.n)
        new_keys = edge_keys(new_edges, self.n)
        insert = new_edges[~np.isin(new_keys, old_keys)]
        delete = self._edges[~np.isin(old_keys, new_keys)]
        return EdgeBatch.make(insert=insert, delete=delete), new_edges

    def advance(self, k: int = 1) -> WindowStep:
        """Slide the window forward by ``k`` strides and re-converge.

        The k strides collapse into ONE EdgeBatch (the net difference of
        the window edge sets), so a coarse replay pays one re-convergence
        per advance, not per stride. With tracing on, each advance is a
        ``window.advance`` span: ``window.diff`` (the edge-set diff) plus
        the engine's ``batch`` tree."""
        with _trace.span("window.advance", step=self.steps_taken) as sp:
            # label the streaming engine's upcoming flight run as a
            # temporal window advance (consumed by its next start_run)
            rec = _flight.recorder()
            if rec.active:
                rec.set_context(engine="temporal", step=self.steps_taken)
            with _trace.span("window.diff"):
                batch, new_edges = self.peek_batch(k)
            if self.by == "count":
                self._hi = min(self._hi + k * int(self.stride), len(self.log))
            else:
                self._t_hi = self._t_hi + k * self.stride
            res = self.engine.apply_batch(batch)
            new_edges.setflags(write=False)
            self._edges = new_edges
            lo, hi = self.bounds
            t_lo, t_hi = self.t_bounds
            step = WindowStep(step=self.steps_taken, lo=lo, hi=hi, t_lo=t_lo, t_hi=t_hi,
                              batch=batch, result=res, m=int(new_edges.shape[0]))
            sp.set(inserts=int(batch.insert.shape[0]), deletes=int(batch.delete.shape[0]),
                   rounds=res.rounds, mode=res.mode, messages=res.stats.total_messages)
        self.steps_taken += 1
        return step

    def steps(self, max_steps: int | None = None):
        """Iterate window advances until the stream is consumed."""
        while not self.done:
            if max_steps is not None and self.steps_taken >= max_steps:
                return
            yield self.advance()
