"""Snapshot-isolated concurrent serving (the port of
``repro.streaming.concurrent``): reads proceed during re-convergence.

The sequential ``KCoreServer.serve`` loop interleaves update batches and
queries strictly, so every re-convergence stalls all reads. This module is
the threaded front end that decouples them:

* **Double-buffered core state.** The maintenance engine is the *back*
  buffer: ``apply_batch`` / ``advance_window`` converge in place on the
  engine's device. The *front* buffer is an immutable ``CoreSnapshot``: a
  read-only host copy of the last converged fixpoint's core vector (never a
  tensor, and never a view of the engine's vector), its as-of ring view and
  a monotone version, published through a seqlock-style ``SnapshotBox``.
  Readers never see intermediate estimates: every read is answered
  bit-exactly from SOME converged fixpoint.

* **Worker pool for reads, single writer.** ``submit_read`` dispatches read
  ops onto a thread pool; ``update``/``advance_window`` run under the
  single-writer lock and flip the snapshot after converging. A read
  validates its request BEFORE acquiring a snapshot
  (``KCoreServer.validate``) and returns a structured error ``Response``
  instead of raising through the pool. A read touches only the snapshot's
  numpy arrays and ``engine.n``: no read calls into torch or the card.

* **Staleness is bounded and observable.** During a re-convergence readers
  serve the previous fixpoint. Exposed as ``kcore_snapshot_age_seconds``
  (gauge, refreshed on every read) and ``kcore_reads_inflight``; every flip
  emits a ``snapshot.flip`` span, bumps ``kcore_snapshot_flips_total`` and
  lands as a ``snapshot_flip`` event in the flight recorder.

* **Warm restart.** ``drain()`` (the SIGTERM path of
  ``launch/kcore_serve.py``) stops accepting reads, drains in-flight ones,
  waits out the writer, and saves the full server state
  (``KCoreServer.state_dict``) through ``repro_torch.checkpoint`` in the
  reference's layout. A restarted server, of either package, loads it and
  resumes in lockstep: identical cores and message bills.

The writer holds the interpreter lock through the host parts of a batch
(the per-edge CSR patch), so reader latency under load follows the
interpreter's switch interval, not the microseconds of an idle server.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable

import numpy as np

from repro_torch.obs import flight as _flight
from repro_torch.obs import trace as _trace
from repro_torch.streaming.server import AsofView, KCoreServer, Request, Response

READ_OPS = ("core", "in_kcore", "members", "max_k", "core_asof")


def _json_payload(payload):
    """Flatten a Response payload to plain JSON types."""
    if isinstance(payload, np.ndarray):
        return payload.tolist()
    if isinstance(payload, tuple):              # core_asof: (boundary_t, cores)
        bt, core = payload
        return {"t": float(bt), "core": np.asarray(core).tolist()}
    if isinstance(payload, (np.integer, np.floating, np.bool_)):
        return payload.item()
    return payload


@dataclasses.dataclass(frozen=True)
class CoreSnapshot:
    """One published converged fixpoint — everything a read can touch."""

    version: int              # monotone publication counter (1-based)
    core: np.ndarray          # read-only copy of the converged core vector
    n: int
    m: int                    # edge count at the fixpoint
    max_k: int
    asof: AsofView            # frozen as-of ring view at flip time
    batches_applied: int      # engine batch counter at flip time
    t_hi: float | None        # window head time (windowed mode only)
    published_at: float       # perf_counter at the flip

    def age_s(self) -> float:
        """Seconds since this fixpoint was published — the staleness any
        read answered from it carries."""
        return time.perf_counter() - self.published_at


class SnapshotBox:
    """Seqlock-style publication point for the front buffer.

    ``publish`` bumps the version to odd, swaps the snapshot reference,
    and bumps back to even; ``read`` retries while the counter is odd or
    moved mid-read. Under CPython the reference swap is itself atomic, so
    the retry loop effectively never spins — the protocol is kept explicit
    so the old-or-new-never-torn contract is enforced by construction,
    not by interpreter implementation detail.
    """

    def __init__(self):
        self._version = 0             # even = stable, odd = flip in progress
        self._snap: CoreSnapshot | None = None
        self._write_lock = threading.Lock()
        self.flips = 0

    def publish(self, snap: CoreSnapshot) -> None:
        with self._write_lock:
            self._version += 1        # odd: flip in progress
            self._snap = snap
            self._version += 1        # even: stable again
            self.flips += 1

    def read(self) -> CoreSnapshot:
        while True:
            v1 = self._version
            snap = self._snap
            if (v1 & 1) == 0 and self._version == v1 and snap is not None:
                return snap
            if snap is None and self._version == v1 and (v1 & 1) == 0:
                raise RuntimeError("no snapshot published yet")
            time.sleep(0)             # flip mid-publication; yield + retry


class ConcurrentKCoreServer:
    """Threaded snapshot-isolated front end over a ``KCoreServer``.

    Reads (``submit_read`` / ``read`` / ``serve_concurrent``) execute on a
    worker pool against the latest published ``CoreSnapshot``; writes
    (``update`` / ``advance_window``) run under the single-writer lock and
    flip a fresh snapshot when the engine has converged. ``drain`` is the
    graceful-shutdown path (optionally checkpointing for a warm restart).
    """

    def __init__(self, server: KCoreServer, read_workers: int = 4,
                 checkpoint_dir: str | None = None):
        if read_workers < 1:
            raise ValueError("read_workers must be >= 1")
        self.server = server
        self.checkpoint_dir = checkpoint_dir
        self.box = SnapshotBox()
        self._pool = ThreadPoolExecutor(max_workers=int(read_workers),
                                        thread_name_prefix="kcore-read")
        self._write_lock = threading.RLock()
        self._draining = threading.Event()
        m = server.metrics
        self._reads_total = m.counter("kcore_reads_total")
        self._reads_inflight = m.gauge("kcore_reads_inflight")
        self._snapshot_age = m.gauge("kcore_snapshot_age_seconds")
        self._flips_total = m.counter("kcore_snapshot_flips_total")
        self._version_gauge = m.gauge("kcore_snapshot_version")
        self._flip()                  # publish the initial fixpoint

    # ---------------- front buffer ------------------------------------- #
    @property
    def snapshot(self) -> CoreSnapshot:
        """The currently published fixpoint (what reads are seeing)."""
        return self.box.read()

    def snapshot_age_s(self) -> float:
        return self.box.read().age_s()

    def _flip(self) -> CoreSnapshot:
        """Publish the engine's converged state as the new front buffer.

        Called by the writer after every converged batch/advance (and once
        at construction). The core vector is copied and frozen — the back
        buffer keeps churning, the snapshot never moves. The engine keeps
        its cores on the host, so the copy reads nothing from the card.
        """
        srv = self.server
        version = self.box.flips + 1
        with _trace.span("snapshot.flip", version=version):
            core = np.array(srv.engine.core, np.int32, copy=True)
            core.setflags(write=False)
            t_hi = (float(srv.windowed.t_bounds[1])
                    if srv.windowed is not None else None)
            snap = CoreSnapshot(
                version=version, core=core, n=srv.engine.n, m=srv.engine.m,
                max_k=int(core.max()) if core.size else 0,
                asof=srv.asof_ring.snapshot(),
                batches_applied=srv.engine.batches_applied, t_hi=t_hi,
                published_at=time.perf_counter())
            self.box.publish(snap)
        self._flips_total.inc()
        self._version_gauge.set(version)
        self._snapshot_age.set(0.0)
        rec = _flight.recorder()
        if rec.active:
            rec.note_event("snapshot_flip", version=version,
                           batch=snap.batches_applied, n=snap.n, m=snap.m,
                           max_k=snap.max_k)
        return snap

    # ---------------- writes (single writer) --------------------------- #
    def update(self, batch):
        """Apply a churn batch in the back buffer, then flip."""
        with self._write_lock:
            res = self.server.update(batch)
            self._flip()
            return res

    def advance_window(self, k: int = 1):
        """Advance the sliding window in the back buffer, then flip."""
        with self._write_lock:
            ws = self.server.advance_window(k)
            self._flip()
            return ws

    # ---------------- reads (worker pool) ------------------------------ #
    def submit_read(self, req: Request) -> Future:
        """Dispatch one read op to the pool; resolves to a Response."""
        if self._draining.is_set():
            raise RuntimeError("server is draining")
        return self._pool.submit(self._read, req)

    def read(self, req: Request) -> Response:
        """Execute one read op on the calling thread (same snapshot path
        as the pool — the HTTP front end already runs per-connection
        threads, so it reads inline instead of double-dispatching)."""
        return self._read(req)

    def serve_concurrent(self, requests: Iterable[Request]
                         ) -> list[Response]:
        """Submit a batch of reads and gather their responses in order."""
        futures = [self.submit_read(r) for r in requests]
        return [f.result() for f in futures]

    def _read(self, req: Request) -> Response:
        t0 = time.perf_counter()
        srv = self.server
        payload, error, version = None, None, None
        self._reads_inflight.inc()
        try:
            with _trace.span("serve.read", op=req.op):
                try:
                    if req.op not in READ_OPS:
                        raise ValueError(
                            f"op {req.op!r} is not a read — writes go "
                            "through the single writer (update / "
                            "advance_window)")
                    # validate BEFORE acquiring the snapshot: a malformed
                    # request must not touch serving state at all
                    v = srv.validate(req)
                    snap = self.box.read()
                    version = snap.version
                    self._snapshot_age.set(snap.age_s())
                    if req.op == "core":
                        payload = snap.core[v]
                    elif req.op == "in_kcore":
                        payload = snap.core[v] >= int(req.k)
                    elif req.op == "members":
                        payload = np.flatnonzero(snap.core >= int(req.k))
                    elif req.op == "max_k":
                        payload = snap.max_k
                    else:                         # core_asof
                        bt, core = snap.asof.asof(req.t)
                        payload = (bt, core if v is None else core[v])
                except (ValueError, IndexError, KeyError, TypeError) as exc:
                    # structured error instead of raising through the pool
                    error = str(exc)
                    op = req.op if req.op in srv.OPS else "unknown"
                    srv.metrics.counter("server_errors_total", op=op).inc()
        finally:
            self._reads_inflight.inc(-1.0)
        dt = time.perf_counter() - t0
        self._reads_total.inc()
        if error is None:
            srv.metrics.counter("server_requests_total", op=req.op).inc()
            srv.metrics.histogram("server_request_seconds",
                                  op=req.op).observe(dt)
        return Response(op=req.op, payload=payload, wall_s=dt, error=error,
                        version=version)

    def handle_query(self, op: str, vertices=None, k=None, t=None) -> dict:
        """JSON-safe adapter for HTTP front ends (obs/http.py).

        Builds the Request, reads inline on the calling thread (the HTTP
        server is already one-thread-per-connection), and serializes the
        payload to plain JSON types. Kept here so the obs layer never has
        to import streaming — it just calls whatever backend is attached.
        """
        if self._draining.is_set():
            return {"op": op, "ok": False, "error": "server is draining"}
        resp = self._read(Request(op=op, vertices=vertices, k=k, t=t))
        out = {"op": resp.op, "ok": resp.ok, "wall_s": resp.wall_s,
               "version": resp.version}
        if resp.error is not None:
            out["error"] = resp.error
        else:
            out["payload"] = _json_payload(resp.payload)
        return out

    # ---------------- shutdown / warm restart -------------------------- #
    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, save: bool = True, step: int | None = None
              ) -> str | None:
        """Graceful shutdown: refuse new reads, drain in-flight ones, wait
        for the writer to finish its batch, then (optionally) checkpoint.

        Returns the committed checkpoint path (None when not saving).
        Idempotent — the SIGTERM handler and a normal exit can both call
        it. The checkpoint is written through ``repro_torch.checkpoint``'s
        atomic-rename commit, so a kill mid-save leaves the previous
        complete step loadable.
        """
        self._draining.set()
        self._pool.shutdown(wait=True)
        with self._write_lock:        # writer finished its current batch
            if not (save and self.checkpoint_dir):
                return None
            from repro_torch.checkpoint import save_checkpoint
            if step is None:
                step = self.server.updates_applied
            path = save_checkpoint(self.checkpoint_dir, int(step),
                                   self.server.state_dict())
            rec = _flight.recorder()
            if rec.active:
                rec.note_event("checkpoint_save", step=int(step), path=path)
            return path

    def stats(self) -> dict:
        """Server stats plus the concurrency counters."""
        snap = self.box.read()
        out = self.server.stats()
        out.update({
            "snapshot_version": snap.version,
            "snapshot_flips": self.box.flips,
            "snapshot_age_s": snap.age_s(),
            "reads_total": int(self._reads_total.value),
            "reads_inflight": int(self._reads_inflight.value),
        })
        return out
