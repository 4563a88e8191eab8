"""Core-number query server (the port of ``repro.streaming.server``): update
batches interleaved with batched queries.

Models the paper's million-client scenario from the serving side: clients do
not run the decomposition, they ask a maintained index. The server owns a
``StreamingKCoreEngine``; updates mutate the graph and re-converge
incrementally on the card, queries are O(1)/O(n) numpy reads of the
maintained fixpoint (the engine keeps its cores as a host vector), so query
latency is decoupled from graph size and churn.

Supported ops
  * ``core``      — core numbers for a batch of vertex ids;
  * ``in_kcore``  — k-core membership for a batch of vertex ids;
  * ``members``   — all vertices of the k-core;
  * ``max_k``     — the degeneracy (largest non-empty k);
  * ``update``    — apply an EdgeBatch through the incremental engine;
  * ``core_asof`` — core numbers AT TIME t, from the ring of core vectors
    checkpointed at window boundaries (``CoreCheckpointRing``, temporal
    mode): O(log capacity) per lookup for any retained boundary;
  * ``advance_window`` — slide the window (temporal mode; a method, not a
    request of ``serve``).

Every request's wall is observed into a PER-SERVER metrics registry
(``obs.metrics``, so several servers in one process never merge their
latency distributions): ``stats()`` reports p50/p95/p99 seconds per op under
``"latency"`` and raw-float cumulative walls; the registry is
``server.metrics``, for JSON/Prometheus export. With span tracing on, each
request, update and advance emits a ``serve.request`` / ``server.update`` /
``window.advance`` span.

A server is constructed over a static Graph (churn arrives as explicit
``update`` batches, the engine on ``device``, CUDA by default) or over a
``WindowedKCoreEngine`` (temporal mode, on the window's device:
``advance_window`` slides the window and every boundary's core vector is
checkpointed into the as-of ring). ``state_dict``/``load_state_dict`` keep
the reference's layout, so a checkpoint crosses between the packages.
``mesh``/``axis_names`` run the static server's engine mesh-native.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Iterable

import numpy as np

from repro_torch.core.kcore import KCoreConfig
from repro_torch.graph.structs import Graph
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.streaming.delta import EdgeBatch
from repro_torch.streaming.engine import BatchResult, StreamingConfig, StreamingKCoreEngine

if TYPE_CHECKING:   # temporal depends on streaming, never the reverse
    from repro_torch.temporal.window import WindowedKCoreEngine, WindowStep


@dataclasses.dataclass(frozen=True)
class Request:
    op: str          # core | in_kcore | members | max_k | update | core_asof
    vertices: np.ndarray | None = None   # core / in_kcore / core_asof
    k: int | None = None                 # in_kcore / members
    batch: EdgeBatch | None = None       # update
    t: float | None = None               # core_asof


@dataclasses.dataclass
class Response:
    op: str
    payload: Any
    wall_s: float
    # structured failure: a malformed request (bad vertex id, missing
    # argument, unknown op) yields payload=None + this message instead of
    # an exception — a worker pool must never die on a bad request
    error: str | None = None
    # snapshot version the read was answered from (concurrent front end
    # only; None for the sequential serve loop)
    version: int | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


def _asof_lookup(times, cores, t: float) -> tuple[float, np.ndarray]:
    """Shared as-of search over parallel (times, cores) sequences."""
    if not times:
        raise KeyError("no checkpoints retained")
    i = int(np.searchsorted(np.asarray(times), float(t),
                            side="right")) - 1
    if i < 0:
        raise KeyError(
            f"t={t} predates the oldest retained boundary "
            f"({times[0]}); increase the ring capacity")
    return times[i], cores[i]


@dataclasses.dataclass(frozen=True)
class AsofView:
    """Immutable as-of store: a frozen (times, cores) snapshot of a
    CoreCheckpointRing. Core arrays are the ring's read-only copies, so
    the view can be shared across reader threads freely."""

    times: tuple[float, ...]
    cores: tuple[np.ndarray, ...]

    def __len__(self) -> int:
        return len(self.times)

    def asof(self, t: float) -> tuple[float, np.ndarray]:
        return _asof_lookup(self.times, self.cores, t)


class CoreCheckpointRing:
    """Bounded ring of (t, core) snapshots for as-of queries.

    ``push`` records the core vector at a window boundary (a read-only
    copy — retained history cannot be corrupted through the returned
    references); ``asof(t)`` returns the snapshot at the latest retained
    boundary with boundary-time <= t — an O(log capacity) searchsorted
    plus an O(1) vector reference, independent of graph size or stream
    length. Callers that want to mutate the result must copy it."""

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._times: list[float] = []
        self._cores: list[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._times)

    @property
    def times(self) -> np.ndarray:
        """Retained boundary times, oldest first."""
        return np.asarray(self._times, np.float64)

    def push(self, t: float, core: np.ndarray) -> None:
        t = float(t)
        if self._times and t < self._times[-1]:
            raise ValueError("checkpoint times must be non-decreasing")
        snap = np.asarray(core, np.int32).copy()
        snap.setflags(write=False)
        self._times.append(t)
        self._cores.append(snap)
        if len(self._times) > self.capacity:
            del self._times[0], self._cores[0]

    def asof(self, t: float) -> tuple[float, np.ndarray]:
        """(boundary_time, core) at the latest boundary <= t."""
        return _asof_lookup(self._times, self._cores, t)

    def snapshot(self) -> "AsofView":
        """Immutable view of the currently retained boundaries.

        O(len) tuple copy of the (already read-only) snapshot references —
        the concurrent server freezes one of these into each published
        ``CoreSnapshot`` so as-of reads stay consistent with the core
        vector they were flipped with, no matter how far the writer's ring
        has advanced since."""
        return AsofView(tuple(self._times), tuple(self._cores))

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Checkpointable pytree: boundary times (k,) + cores stacked to
        (k, n). Fixed leaf COUNT regardless of occupancy, so a restore
        target's structure never depends on how full the ring was."""
        if self._cores:
            cores = np.stack([np.asarray(c, np.int32) for c in self._cores])
        else:
            cores = np.zeros((0, 0), np.int32)
        return {"times": np.asarray(self._times, np.float64), "cores": cores}

    def load_state(self, state: dict) -> None:
        """Restore retained boundaries in place (capacity is config)."""
        times = np.asarray(state["times"], np.float64).reshape(-1)
        cores = np.asarray(state["cores"], np.int32)
        keep = min(times.shape[0], self.capacity)
        times, cores = times[-keep:] if keep else times[:0], \
            cores[-keep:] if keep else cores[:0]
        self._times, self._cores = [], []
        for t, core in zip(times.tolist(), cores):
            snap = core.copy()
            snap.setflags(write=False)
            self._times.append(float(t))
            self._cores.append(snap)


class KCoreServer:
    """Serving facade over the incremental maintenance engine.

    Pass exactly one of ``g`` (static mode: the engine is built here on
    ``device``, CUDA unless ``"cpu"`` is asked for) or ``windowed`` (temporal
    mode: the window's engine, config and device are used as they are).
    """

    OPS = ("core", "in_kcore", "members", "max_k", "core_asof", "update",
           "advance_window")

    def __init__(self, g: Graph | None = None,
                 config: StreamingConfig = StreamingConfig(),
                 kcore_config: KCoreConfig = KCoreConfig(),
                 mesh=None, axis_names=("data",),
                 windowed: WindowedKCoreEngine | None = None,
                 asof_capacity: int = 16, *, device=None):
        if (g is None) == (windowed is None):
            raise ValueError("pass exactly one of g / windowed")
        if windowed is not None:
            if (mesh is not None or tuple(axis_names) != ("data",) or device is not None
                    or config != StreamingConfig()
                    or kcore_config != KCoreConfig()):
                raise ValueError(
                    "windowed mode: config/kcore_config/mesh/axis_names/device belong to the "
                    "WindowedKCoreEngine — pass them to its constructor, the server "
                    "would silently ignore them")
            self.windowed = windowed
            self.engine = windowed.engine
        else:
            self.windowed = None
            self.engine = StreamingKCoreEngine(g, config, kcore_config, mesh=mesh,
                                               axis_names=axis_names, device=device)
        self.asof_ring = CoreCheckpointRing(asof_capacity)
        self.queries_served = 0
        self.clients_answered = 0     # total vertex ids answered
        self.errors_returned = 0      # malformed requests answered with
        self.updates_applied = 0      # a structured error Response
        self.update_messages = 0
        self.update_rounds = 0
        self.query_wall_s = 0.0
        self.update_wall_s = 0.0
        # per-server registry, every op pre-registered so stats(), latency()
        # and the scrape endpoint expose a stable schema: zero-request ops
        # show count 0 / null quantiles instead of a missing key
        self.metrics = MetricsRegistry()
        for op in self.OPS:
            self.metrics.counter("server_requests_total", op=op)
            self.metrics.histogram("server_request_seconds", op=op)
            self.metrics.counter("server_errors_total", op=op)
        self.metrics.counter("server_errors_total", op="unknown")

    def _observe(self, op: str, wall_s: float) -> None:
        self.metrics.counter("server_requests_total", op=op).inc()
        self.metrics.histogram("server_request_seconds", op=op).observe(wall_s)

    # ---------------- queries (reads of the maintained fixpoint) -------- #
    @property
    def core(self) -> np.ndarray:
        return self.engine.core

    def core_number(self, vertices) -> np.ndarray:
        v = np.asarray(vertices, np.int64).reshape(-1)
        self._check_ids(v)
        return self.core[v]

    def in_kcore(self, vertices, k: int) -> np.ndarray:
        return self.core_number(vertices) >= int(k)

    def kcore_members(self, k: int) -> np.ndarray:
        return np.flatnonzero(self.core >= int(k))

    def max_k(self) -> int:
        return int(self.core.max()) if self.core.size else 0

    def _check_ids(self, v: np.ndarray) -> None:
        # engine.n is O(1); engine.graph would materialize the full CSR
        if v.size and (v.min() < 0 or v.max() >= self.engine.n):
            raise IndexError("vertex id out of range")

    # ---------------- as-of queries (temporal mode) --------------------- #
    def core_asof(self, t: float, vertices=None) -> tuple[float, np.ndarray]:
        """Core numbers at time ``t``: the vector checkpointed at the latest
        retained window boundary <= t (KeyError if t predates the ring).
        Returns (boundary_time, cores)."""
        if t is None:
            raise ValueError("core_asof requires t")
        if vertices is None:
            return self.asof_ring.asof(t)
        # ids are validated BEFORE the ring lookup: a bad request must not
        # touch retained state at all
        v = np.asarray(vertices, np.int64).reshape(-1)
        self._check_ids(v)
        bt, core = self.asof_ring.asof(t)
        return bt, core[v]

    def asof_boundaries(self) -> np.ndarray:
        """Boundary times currently answerable by ``core_asof``."""
        return self.asof_ring.times

    # ---------------- updates ------------------------------------------ #
    def update(self, batch: EdgeBatch) -> BatchResult:
        if self.windowed is not None:
            # mutating the engine behind the window's edge-set bookkeeping
            # would silently corrupt every later boundary delta
            raise ValueError("windowed mode: the event stream owns the "
                             "graph — advance_window() instead of update()")
        t0 = time.perf_counter()
        with _trace.span("server.update"):
            res = self.engine.apply_batch(batch)
        dt = time.perf_counter() - t0
        self.update_wall_s += dt
        self.updates_applied += 1
        self.update_messages += res.total_messages
        self.update_rounds += res.rounds
        self._observe("update", dt)
        return res

    def advance_window(self, k: int = 1) -> WindowStep:
        """Temporal mode: slide the window k strides, re-converge, and
        checkpoint the boundary's core vector into the as-of ring."""
        if self.windowed is None:
            raise ValueError("server was not constructed over a "
                             "WindowedKCoreEngine")
        t0 = time.perf_counter()
        ws = self.windowed.advance(k)
        dt = time.perf_counter() - t0
        self.update_wall_s += dt
        self.updates_applied += 1
        self.update_messages += ws.result.total_messages
        self.update_rounds += ws.result.rounds
        self.asof_ring.push(ws.t_hi, ws.result.core)
        self._observe("advance_window", dt)
        return ws

    # ---------------- request loop ------------------------------------- #
    def validate(self, req: Request) -> np.ndarray | None:
        """Validate a request BEFORE any state is touched.

        Returns the normalized (int64, flat) vertex array for ops that carry
        one, raising ValueError/IndexError/TypeError on a malformed request.
        Every front end (``serve`` here, the snapshot readers of
        ``streaming/concurrent.py``) rejects bad requests through it without
        acquiring a snapshot or mutating anything.
        """
        if req.op not in self.OPS:
            raise ValueError(f"unknown op {req.op!r}")
        v = None
        if req.op in ("core", "in_kcore", "core_asof"):
            if req.vertices is None and req.op != "core_asof":
                raise ValueError(f"{req.op} requires vertices")
            if req.vertices is not None:
                v = np.asarray(req.vertices, np.int64).reshape(-1)
                self._check_ids(v)
        if req.op in ("in_kcore", "members") and req.k is None:
            raise ValueError(f"{req.op} requires k")
        if req.op == "core_asof" and req.t is None:
            raise ValueError("core_asof requires t")
        if req.op == "update" and req.batch is None:
            raise ValueError("update requires batch")
        return v

    def serve(self, requests: Iterable[Request]) -> list[Response]:
        out = []
        for req in requests:
            t0 = time.perf_counter()
            error = None
            payload = None
            with _trace.span("serve.request", op=req.op):
                try:
                    self.validate(req)
                    if req.op == "core":
                        payload = self.core_number(req.vertices)
                        self.clients_answered += payload.size
                    elif req.op == "in_kcore":
                        payload = self.in_kcore(req.vertices, req.k)
                        self.clients_answered += payload.size
                    elif req.op == "members":
                        payload = self.kcore_members(req.k)
                    elif req.op == "max_k":
                        payload = self.max_k()
                    elif req.op == "core_asof":
                        payload = self.core_asof(req.t, req.vertices)
                        self.clients_answered += payload[1].size
                    elif req.op == "update":
                        payload = self.update(req.batch)
                    else:   # advance_window is a method, not a request
                        raise ValueError("advance_window is not a request: call "
                                         "advance_window()")
                except (ValueError, IndexError, KeyError, TypeError) as exc:
                    # malformed request -> structured error Response; a
                    # request must never raise through the serving loop
                    error = str(exc)
                    self.errors_returned += 1
                    op = req.op if req.op in self.OPS else "unknown"
                    self.metrics.counter("server_errors_total", op=op).inc()
            dt = time.perf_counter() - t0
            if error is None and req.op != "update":
                # update() already tracks its wall; errors are counted
                # separately so latency histograms stay reads-only
                self.queries_served += 1
                self.query_wall_s += dt
                self._observe(req.op, dt)
            out.append(Response(op=req.op, payload=payload, wall_s=dt,
                                error=error))
        return out

    def latency(self) -> dict:
        """Per-op latency summaries (seconds): ``{op: {count, sum, min,
        max, mean, p50, p95, p99}}`` from the per-server histograms."""
        out: dict = {}
        for entries in (
                self.metrics.to_json().get("server_request_seconds") or []):
            snap = {k: v for k, v in entries.items()
                    if k not in ("labels", "type")}
            out[entries["labels"]["op"]] = snap
        return out

    def stats(self) -> dict:
        # walls are RAW float seconds: a batched query runs tens of
        # microseconds, so rounding here would zero real signal; the CLI
        # (launch/kcore_serve) formats
        return {
            "n": self.engine.n,
            "m": self.engine.m,
            "max_k": self.max_k(),
            "queries_served": self.queries_served,
            "clients_answered": self.clients_answered,
            "errors_returned": self.errors_returned,
            "updates_applied": self.updates_applied,
            "update_messages": self.update_messages,
            "update_rounds": self.update_rounds,
            "query_wall_s": self.query_wall_s,
            "update_wall_s": self.update_wall_s,
            "asof_boundaries": len(self.asof_ring),
            "latency": self.latency(),
        }

    # ---------------- warm restart ------------------------------------- #
    def state_dict(self) -> dict:
        """Checkpointable tree of everything a warm restart needs.

        Windowed mode captures the full windowed engine (inner streaming
        engine + window cursor), static mode the streaming engine alone; the
        as-of ring rides along. Counters and latency are not state. The
        keys and leaves are the reference's, so ``save_checkpoint`` output
        restores into either package's server.
        """
        if self.windowed is not None:
            state = {"windowed": self.windowed.state_dict()}
        else:
            state = {"engine": self.engine.state_dict()}
        state["asof"] = self.asof_ring.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict`` output in place (same serving mode), on
        this server's device. No decomposition runs: the restored cores ARE
        the fixpoint of the restored CSR, so the stream continues exactly
        (bit-equal cores and message bills)."""
        if self.windowed is not None:
            if "windowed" not in state:
                raise ValueError("checkpoint was taken from a static "
                                 "server; this one is windowed")
            self.windowed.load_state_dict(state["windowed"])
            self.engine = self.windowed.engine
        else:
            if "engine" not in state:
                raise ValueError("checkpoint was taken from a windowed "
                                 "server; this one is static")
            self.engine = StreamingKCoreEngine.from_state_dict(
                state["engine"], config=self.engine.config, mesh=self.engine.mesh,
                axis_names=self.engine.axis_names, device=self.engine.device)
        self.asof_ring.load_state(state["asof"])
