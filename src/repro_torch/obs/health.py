"""Online invariant monitor over the convergence flight stream (copy of
``repro.obs.health``).

The locality iteration has invariants the paper's correctness argument
rests on, and this module checks them AS ROUNDS COMPLETE rather than after
the fact:

* **monotone non-increasing estimates** — a vertex estimate never rises
  within a convergence run (the h-index update only peels);
* **frontier shrinkage implies termination progress** — a round with
  messages but zero estimate changes, a changed-count exceeding the
  frontier, or a frontier that stops reaching new minima for a long
  stretch all indicate a wedged or mis-accounted run;
* **message-bill mode-invariance** — the same (graph, batch) converged
  under two execution modes must bill the identical message total
  (the repo's bit-equality contract, checked live via ``observe_bill``).

Anomalies are emitted as structured events into the tracer
(``trace.record("health.anomaly", ...)``), counted per-kind in the metrics
registry (``obs_health_anomalies_total{kind}``), and collapsed into a
single health gauge (``obs_health_status``: 1 ok / 0 anomalous); the
verdict is what ``/healthz`` serves (``obs/http.py``: 200, or 503 after an
anomaly).

The monitor subscribes to a ``FlightRecorder`` via its observer hook, so
it costs nothing unless flight recording is enabled; ``install()`` wires
the process-default monitor to the process-default recorder (idempotent).
This module imports ``flight`` — flight must never import health.
"""

from __future__ import annotations

import threading

from repro_torch.obs import flight, metrics, trace

# a frontier that hasn't reached a new minimum for this many consecutive
# rounds is flagged as stalled (the locality iteration on any real graph
# converges in far fewer; see the paper's round counts)
STALL_ROUNDS = 256

_MAX_RUNS_TRACKED = 64
_MAX_BILLS_TRACKED = 256


class InvariantMonitor:
    """Validates convergence invariants on a stream of flight events."""

    def __init__(self, registry: metrics.MetricsRegistry | None = None,
                 stall_rounds: int = STALL_ROUNDS):
        self._registry = registry
        self.stall_rounds = int(stall_rounds)
        self._lock = threading.RLock()
        self._runs: dict[int, dict] = {}
        self._bills: dict = {}
        self.anomalies = 0
        self.kinds: dict[str, int] = {}
        self.last: dict | None = None
        self.runs_seen = 0
        self._set_gauge()

    # -------------------------------------------------------------- #
    # event intake (FlightRecorder observer protocol)
    # -------------------------------------------------------------- #
    def __call__(self, event: dict) -> None:
        kind = event.get("kind")
        if kind == "round":
            self.check_record(event["record"])
        elif kind == "run_start":
            with self._lock:
                self.runs_seen += 1
                self._runs[event["run"]] = {
                    "min_frontier": None, "since_min": 0,
                    "last_est_sum": None, "rises": 0, "stalled": False,
                }
                if len(self._runs) > _MAX_RUNS_TRACKED:
                    self._runs.pop(next(iter(self._runs)))
        elif kind == "run_end":
            self._on_run_end(event)

    def check_record(self, rec) -> None:
        """Check one FlightRecord; public so tests can inject records."""
        with self._lock:
            st = self._runs.setdefault(rec.run, {
                "min_frontier": None, "since_min": 0,
                "last_est_sum": None, "rises": 0, "stalled": False,
            })
            if rec.est_rises > 0:
                st["rises"] += rec.est_rises
                self._anomaly("non_monotone_estimate", run=rec.run,
                              round=rec.round, rises=rec.est_rises,
                              mode=rec.mode)
            if rec.est_sum is not None:
                prev = st["last_est_sum"]
                if prev is not None and rec.est_sum > prev:
                    self._anomaly("non_monotone_estimate", run=rec.run,
                                  round=rec.round, est_sum=rec.est_sum,
                                  prev_est_sum=prev, mode=rec.mode)
                st["last_est_sum"] = rec.est_sum
            if rec.round >= 1:
                if rec.changed == 0 and rec.messages > 0:
                    self._anomaly("messages_without_change", run=rec.run,
                                  round=rec.round, messages=rec.messages,
                                  mode=rec.mode)
                if rec.changed > rec.frontier:
                    self._anomaly("changed_exceeds_frontier", run=rec.run,
                                  round=rec.round, changed=rec.changed,
                                  frontier=rec.frontier, mode=rec.mode)
                mn = st["min_frontier"]
                if mn is None or rec.frontier < mn:
                    st["min_frontier"] = rec.frontier
                    st["since_min"] = 0
                else:
                    st["since_min"] += 1
                    if (st["since_min"] >= self.stall_rounds
                            and not st["stalled"]):
                        st["stalled"] = True
                        self._anomaly("frontier_stall", run=rec.run,
                                      round=rec.round,
                                      frontier=rec.frontier, mode=rec.mode)

    def _on_run_end(self, event: dict) -> None:
        with self._lock:
            st = self._runs.pop(event["run"], None)
            if event.get("converged") is False:
                self._anomaly("unconverged_run", run=event["run"],
                              rounds=event.get("rounds"),
                              mode=event.get("mode", ""))
            rises = int(event.get("est_rises", 0) or 0)
            if rises > 0 and (st is None or st["rises"] == 0):
                self._anomaly("non_monotone_estimate", run=event["run"],
                              rises=rises, mode=event.get("mode", ""))

    def observe_bill(self, key, mode: str, total: int) -> None:
        """Check message-bill mode-invariance: the same ``key`` (e.g. a
        (trace, batch) pair) converged under different modes must bill the
        identical total."""
        with self._lock:
            seen = self._bills.get(key)
            if seen is None:
                self._bills[key] = (str(mode), int(total))
                if len(self._bills) > _MAX_BILLS_TRACKED:
                    self._bills.pop(next(iter(self._bills)))
            elif seen[1] != int(total):
                self._anomaly("mode_bill_mismatch", key=str(key),
                              mode=str(mode), total=int(total),
                              other_mode=seen[0], other_total=seen[1])

    # -------------------------------------------------------------- #
    # anomaly emission + verdict
    # -------------------------------------------------------------- #
    def _anomaly(self, kind: str, **attrs) -> None:
        self.anomalies += 1
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self.last = {"kind": kind, **attrs}
        trace.record("health.anomaly", 0.0, kind=kind, **attrs)
        self._counter(kind)
        self._set_gauge()

    def _counter(self, kind: str) -> None:
        reg = self._registry if self._registry is not None \
            else metrics.get_registry()
        reg.counter("obs_health_anomalies_total", kind=kind).inc()

    def _set_gauge(self) -> None:
        val = 1.0 if self.anomalies == 0 else 0.0
        if self._registry is not None:
            self._registry.gauge("obs_health_status").set(val)
        else:
            metrics.gauge("obs_health_status").set(val)

    @property
    def ok(self) -> bool:
        return self.anomalies == 0

    def verdict(self) -> dict:
        with self._lock:
            return {
                "status": "ok" if self.anomalies == 0 else "anomalous",
                "anomalies": self.anomalies,
                "kinds": dict(self.kinds),
                "last": self.last,
                "runs_seen": self.runs_seen,
            }

    def reset(self) -> None:
        with self._lock:
            self._runs.clear()
            self._bills.clear()
            self.anomalies = 0
            self.kinds = {}
            self.last = None
            self.runs_seen = 0
            self._set_gauge()


# ------------------------------------------------------------------ #
# Process-wide default monitor.
# ------------------------------------------------------------------ #

_DEFAULT = InvariantMonitor()
_installed = False


def get_monitor() -> InvariantMonitor:
    return _DEFAULT


def install(recorder: flight.FlightRecorder | None = None) -> InvariantMonitor:
    """Attach the default monitor to the (default) flight recorder so it
    sees every run/round event. Idempotent."""
    global _installed
    rec = recorder if recorder is not None else flight.get_recorder()
    rec.add_observer(_DEFAULT)
    _installed = True
    return _DEFAULT


def verdict() -> dict:
    return _DEFAULT.verdict()


def ok() -> bool:
    return _DEFAULT.ok


def reset() -> None:
    _DEFAULT.reset()
