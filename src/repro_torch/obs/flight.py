"""Convergence flight recorder: a bounded ring of per-round records.

The port's copy of ``repro.obs.flight``. It records WHAT THE CONVERGENCE
DID, round by round, in every execution mode: frontier size, messages,
changed/sender count, the estimate-decrease histogram, device vs host wall
and dispatch — one ``FlightRecord`` per accounting round, held in a bounded
ring — plus the query server's out-of-band events (``note_event``: snapshot
flips, checkpoint saves) in a ring of their own.

Capture points (all guarded by ``recorder().active``):

* the host round loop (``core/kcore.py``) records ONLINE, one record per
  productive round, with an exact per-round estimate-decrease histogram
  computed from host copies of the estimate vectors;
* the fused loop records POST-HOC from the device stat buffers
  (``core/runtime.py``): per-round messages/changed/frontier are bit-equal
  to the host loop by construction, the device wall is amortized over the
  rounds, and the estimate-decrease histogram is the aggregate seed-vs-final
  drop attached to the last round;
* the streaming engine (``streaming/engine.py``) opens one run per churn
  batch (round 0 = the seed rebroadcast + link handshakes), and temporal
  window advances label those runs via ``set_context``.

The per-round ``frontier`` is the ACCOUNTING active series
(``MessageStats.active_per_round``), so a ring recorded under any mode — or
by the reference package — is directly comparable to any other.

Opt-in per-vertex trajectories: ``watch(ids)`` selects a watchlist of
vertex ids whose estimate is sampled at every round that hands the recorder
a host estimate vector (``timelines``, ``trajectory``). The engines already
pass host numpy vectors, so sampling reads nothing from the device, and an
empty watchlist costs one size test a round.

Zero cost when disabled: ``recorder()`` returns the shared no-op
``NULL_RECORDER`` whose ``.active`` is False, and every engine guards its
estimate-vector device copies and per-round clock reads behind that flag.

An observer hook (``add_observer``) streams run/round/run-end events to
the online invariant monitor (``obs/health.py``) as rounds complete.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque

import numpy as np

# estimate-decrease buckets: drops of exactly 1, 2, 3-4, 5-8, and >8 —
# log-spaced because the h-index cascade's tail is what distinguishes a
# local repair from a core-structure collapse
DROP_BUCKETS = (1, 2, 4, 8)


def drop_histogram(prev_est, est) -> tuple[int, ...]:
    """Bucketed histogram of per-vertex estimate decreases prev -> new.

    Returns ``(=1, =2, <=4, <=8, >8)`` counts over vertices that dropped.
    Rises are NOT counted here — they are reported separately as
    ``est_rises`` (a monotonicity violation).
    """
    drop = np.asarray(prev_est, np.int64) - np.asarray(est, np.int64)
    drop = drop[drop > 0]
    if not drop.size:
        return (0,) * (len(DROP_BUCKETS) + 1)
    out = []
    lo = 0
    for b in DROP_BUCKETS:
        out.append(int(((drop > lo) & (drop <= b)).sum()))
        lo = b
    out.append(int((drop > lo).sum()))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FlightRecord:
    """One accounting round of one convergence run (flat — JSON-ready)."""

    seq: int                # monotone over the recorder's lifetime
    run: int                # run id (one run = one convergence)
    engine: str             # "static" | "streaming" | "temporal"
    mode: str               # execution mode ("jacobi/segment", "fused", ...)
    batch: int | None       # batch / window-step id, None for static runs
    round: int              # accounting round index (0 = seed broadcast)
    frontier: int           # accounting active count this round
    messages: int
    changed: int            # senders (estimate decreases) this round
    est_rises: int          # vertices whose estimate ROSE (must be 0)
    drop_hist: tuple[int, ...] | None   # see drop_histogram; None = unknown
    est_sum: int | None     # sum of the estimate vector after the round
    host_s: float           # host wall of this round (0 when amortized)
    device_s: float         # device wall share of this round
    dispatch: str           # "kernel" | "torch" | ""
    compiles: int           # kernel-library builds attributed to this round
    t: float                # perf_counter timestamp at record time

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if d["drop_hist"] is not None:
            d["drop_hist"] = list(d["drop_hist"])
        return d


class _NullRecorder:
    """Shared no-op recorder returned while flight recording is disabled."""

    __slots__ = ()
    active = False

    def set_context(self, **ctx) -> None:
        pass

    def start_run(self, *a, **kw) -> int:
        return -1

    def record_round(self, *a, **kw) -> None:
        pass

    def record_fused_rounds(self, *a, **kw) -> None:
        pass

    def note_event(self, *a, **kw) -> None:
        pass

    def end_run(self, *a, **kw) -> None:
        pass


NULL_RECORDER = _NullRecorder()


class FlightRecorder:
    """Bounded ring of FlightRecords plus per-run bookkeeping."""

    active = True

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("flight ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: deque[FlightRecord] = deque(maxlen=self.capacity)
        self._lock = threading.RLock()
        self._seq = 0
        self._runs = 0
        self._run: dict | None = None      # open-run state
        self._context: dict = {}           # merged into the next start_run
        self._watch: np.ndarray = np.zeros(0, np.int64)
        self._timelines: dict[int, list] = {}
        # out-of-band events (snapshot flips, checkpoint saves, ...) — a
        # separate ring so they never evict convergence rounds
        self._events: deque[dict] = deque(maxlen=self.capacity)
        self._observers: list = []
        self.last_run_rounds = 0           # rounds of the last FINISHED run
        self.rounds_recorded = 0           # total rounds ever recorded

    # -------------------------------------------------------------- #
    # run lifecycle
    # -------------------------------------------------------------- #
    def set_context(self, **ctx) -> None:
        """Stash context merged into the NEXT ``start_run`` (then cleared).

        The temporal layer uses this to label the streaming engine's runs
        (``engine="temporal"``, the window step) without the engine knowing
        who drives it.
        """
        with self._lock:
            self._context.update(ctx)

    def start_run(self, engine: str, mode: str = "", batch: int | None = None,
                  dispatch: str = "", n: int = 0) -> int:
        """Open a convergence run; returns its id. An unfinished previous
        run is closed implicitly (converged=None stays unreported)."""
        with self._lock:
            if self._run is not None:
                self._finish_run(converged=None)
            ctx = self._context
            self._context = {}
            run_id = self._runs
            self._runs += 1
            self._run = {
                "id": run_id,
                "engine": str(ctx.get("engine", engine)),
                "mode": mode,
                "batch": ctx.get("step", batch),
                "dispatch": dispatch,
                "n": int(n),
                "rounds": 0,
            }
            self._notify({"kind": "run_start", "run": run_id,
                          "engine": self._run["engine"], "mode": mode,
                          "batch": self._run["batch"], "n": int(n)})
            return run_id

    def annotate_run(self, **kw) -> None:
        """Update open-run fields (e.g. dispatch resolved after start)."""
        with self._lock:
            if self._run is not None:
                self._run.update(kw)

    def record_round(self, frontier: int, messages: int, changed: int, *,
                     round: int | None = None, est=None, prev_est=None,
                     host_s: float = 0.0, device_s: float = 0.0,
                     compiles: int = 0, dispatch: str | None = None) -> None:
        """Record one accounting round of the open run.

        ``est``/``prev_est`` are OPTIONAL host int vectors: when given, the
        estimate-decrease histogram, rise count, estimate sum and watchlist
        samples are computed from them (numpy, O(n) — the callers only copy
        device tensors when ``recorder().active``).
        """
        with self._lock:
            if self._run is None:
                self.start_run("unknown")
            run = self._run
            rnd = run["rounds"] if round is None else int(round)
            run["rounds"] = rnd + 1
            est_rises = 0
            hist = None
            est_sum = None
            if est is not None:
                est = np.asarray(est)
                est_sum = int(est.sum())
                if prev_est is not None:
                    prev = np.asarray(prev_est)
                    est_rises = int((est > prev).sum())
                    hist = drop_histogram(prev, est)
                self._sample_watch(run, rnd, est)
            rec = FlightRecord(
                seq=self._seq, run=run["id"], engine=run["engine"],
                mode=run["mode"], batch=run["batch"], round=rnd,
                frontier=int(frontier), messages=int(messages),
                changed=int(changed), est_rises=est_rises, drop_hist=hist,
                est_sum=est_sum, host_s=float(host_s),
                device_s=float(device_s),
                dispatch=run["dispatch"] if dispatch is None else dispatch,
                compiles=int(compiles), t=time.perf_counter())
            self._seq += 1
            self.rounds_recorded += 1
            self._ring.append(rec)
            self._notify({"kind": "round", "record": rec})

    def record_fused_rounds(self, msgs, changed, recv, *, frontier1: int,
                            device_s: float = 0.0, compiles: int = 0,
                            dispatch: str = "", seed=None,
                            final=None) -> None:
        """Post-hoc recording of a fused convergence's productive rounds.

        ``msgs``/``changed``/``recv`` are the host-reconstructed per-round
        arrays (``FusedOutcome`` / ``fused_round_stats``). ``frontier1`` is
        the accounting round-1 active count (the fused loop activates
        everyone but the accounting bills only ``deg > 0`` receivers). The
        device wall is amortized uniformly over the rounds; the
        seed-vs-final estimate drop histogram is attached to the LAST round.
        """
        k = len(msgs)
        if k == 0:
            return
        with self._lock:
            per_round = float(device_s) / k
            for i in range(k):
                frontier = int(frontier1) if i == 0 else int(recv[i - 1])
                last = i == k - 1
                self.record_round(
                    frontier, int(msgs[i]), int(changed[i]),
                    est=np.asarray(final) if last and final is not None
                    else None,
                    prev_est=np.asarray(seed) if last and seed is not None
                    else None,
                    device_s=per_round, compiles=compiles if i == 0 else 0,
                    dispatch=dispatch or None)

    def note_event(self, kind: str, **attrs) -> None:
        """Record an out-of-band serving event (a snapshot flip, a checkpoint
        save) beside the convergence rounds.

        Events live in their own bounded ring, are exported under
        ``"events"`` in ``to_json()``, and stream to observers as
        ``{"kind": "event", ...}``, so ``/debug/flight`` shows buffer flips
        in sequence with the re-convergence they raced against.
        """
        with self._lock:
            ev = {"kind": str(kind), "t": time.perf_counter(), **attrs}
            self._events.append(ev)
            self._notify({"kind": "event", "event": ev})

    def events(self, last: int | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if last is None else evs[-int(last):]

    def end_run(self, converged: bool = True, **attrs) -> None:
        with self._lock:
            self._finish_run(converged=bool(converged), **attrs)

    def _finish_run(self, converged, **attrs) -> None:
        run, self._run = self._run, None
        if run is None:
            return
        self.last_run_rounds = run["rounds"]
        self._notify({"kind": "run_end", "run": run["id"],
                      "engine": run["engine"], "mode": run["mode"],
                      "batch": run["batch"], "rounds": run["rounds"],
                      "converged": converged, **attrs})

    # -------------------------------------------------------------- #
    # watchlist (per-vertex trajectories)
    # -------------------------------------------------------------- #
    def watch(self, ids) -> None:
        """Select vertex ids whose estimate trajectory is captured at every
        round where a host estimate vector is available."""
        with self._lock:
            self._watch = np.unique(np.asarray(ids, np.int64).reshape(-1))
            for v in self._watch:
                self._timelines.setdefault(int(v), [])

    @property
    def watchlist(self) -> np.ndarray:
        return self._watch

    def _sample_watch(self, run: dict, rnd: int, est: np.ndarray) -> None:
        w = self._watch
        if not w.size:
            return
        sel = w[w < est.shape[0]]
        vals = est[sel]
        for v, e in zip(sel.tolist(), vals.tolist()):
            tl = self._timelines[int(v)]
            # an entry per (run, round) where the estimate was observable,
            # flagged when it moved (a message-timeline)
            changed = bool(tl) and tl[-1]["est"] != int(e)
            tl.append({"run": run["id"], "batch": run["batch"],
                       "round": rnd, "est": int(e), "changed": changed})
            if len(tl) > 4 * self.capacity:
                del tl[: 2 * self.capacity]

    def timelines(self) -> dict[int, list]:
        """Per-watched-vertex estimate/message timeline (replayable)."""
        with self._lock:
            return {v: list(tl) for v, tl in self._timelines.items()}

    def trajectory(self, vid: int) -> list:
        return self.timelines().get(int(vid), [])

    # -------------------------------------------------------------- #
    # observers (obs/health.py subscribes here)
    # -------------------------------------------------------------- #
    def add_observer(self, fn) -> None:
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def _notify(self, event: dict) -> None:
        for fn in list(self._observers):
            fn(event)

    # -------------------------------------------------------------- #
    # export
    # -------------------------------------------------------------- #
    def records(self, last: int | None = None) -> list[FlightRecord]:
        """A snapshot of the retained records, oldest first."""
        with self._lock:
            recs = list(self._ring)
        return recs if last is None else recs[-int(last):]

    @property
    def runs(self) -> int:
        return self._runs

    def to_json(self, last: int | None = None) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "runs": self._runs,
                "rounds_recorded": self.rounds_recorded,
                "dropped": max(self.rounds_recorded - len(self._ring), 0),
                "records": [r.to_json() for r in self.records(last)],
                "events": self.events(last),
                "watch": self.timelines(),
            }

    def dump(self, path: str, last: int | None = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(last), f)
        return path

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._runs = 0
            self._run = None
            self._context = {}
            self._timelines = {v: [] for v in self._timelines}
            self._events.clear()
            self.last_run_rounds = 0
            self.rounds_recorded = 0


# ------------------------------------------------------------------ #
# Process-wide default recorder — what the engines record against.
# ------------------------------------------------------------------ #

_DEFAULT = FlightRecorder()
_enabled = False


def recorder():
    """The hot-path accessor: the real recorder when enabled, the shared
    NULL_RECORDER otherwise. Engines call this once per run and branch on
    ``.active`` — the disabled path is one attribute read."""
    return _DEFAULT if _enabled else NULL_RECORDER


def get_recorder() -> FlightRecorder:
    """The default recorder itself (regardless of the enabled flag) —
    export/inspection paths (the HTTP endpoint, ``--flight`` dumps, the
    invariant monitor's ``install``)."""
    return _DEFAULT


def enabled() -> bool:
    return _enabled


def enable(capacity: int | None = None) -> None:
    global _DEFAULT, _enabled
    if capacity is not None and capacity != _DEFAULT.capacity:
        _DEFAULT = FlightRecorder(capacity)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _DEFAULT.reset()


def watch(ids) -> None:
    _DEFAULT.watch(ids)


def records(last: int | None = None) -> list[FlightRecord]:
    return _DEFAULT.records(last)


def to_json(last: int | None = None) -> dict:
    return _DEFAULT.to_json(last)


def dump(path: str, last: int | None = None) -> str:
    return _DEFAULT.dump(path, last)
