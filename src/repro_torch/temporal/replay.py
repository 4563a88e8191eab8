"""Replay loop: windowed stream -> core-evolution trajectory (the port of
``repro.temporal.replay``).

Drives a ``WindowedKCoreEngine`` over a full ``EventLog`` and records one
``ReplayRecord`` per window advance: the per-step ``BatchResult`` stats
(message bill, rounds, frontier sizes, execution mode, CSR patch health)
plus core-evolution signals (max/mean core, tracked-vertex core series).
``oracle_every=k`` cross-checks every k-th boundary — cores against the
sequential BZ oracle on an independently materialized window graph, and
the engine's maintained edge set against ``EventLog.edges_between`` — so a
long replay cannot silently drift.

This is the paper-faithful temporal workload: instead of synthetic uniform
churn (benchmarks/streaming_maintenance.py), batches are whatever the
timestamped stream actually did in each stride.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import KCoreConfig
from repro_torch.core.messages import heartbeat_overhead
from repro_torch.obs import flight as _flight
from repro_torch.obs import health as _health
from repro_torch.streaming.engine import StreamingConfig
from repro_torch.temporal.events import EventLog
from repro_torch.temporal.window import WindowedKCoreEngine, WindowStep


@dataclasses.dataclass(frozen=True)
class ReplayRecord:
    """Per-step scalars of one window advance (flat — CSV/JSON-ready)."""

    step: int
    lo: int
    hi: int
    t_lo: float
    t_hi: float
    m: int                    # window graph edges after the step
    inserted: int
    deleted: int
    messages: int
    rounds: int
    frontier_peak: int        # max active vertices in any round
    region: int
    mode: str
    patch_ms: float
    step_ms: float            # wall time of the whole advance
    # remaining per-phase walls of the underlying batch (engine-measured,
    # same boundaries as the trace spans; patch+seed+converge+reconstruct
    # ~= the batch's share of step_ms)
    seed_ms: float = 0.0
    converge_ms: float = 0.0
    reconstruct_ms: float = 0.0
    # modeled termination-detection bill for this step's re-convergence
    # (core.messages.heartbeat_overhead at round granularity)
    heartbeats: int = 0
    # kernel-library builds (nvcc runs) this step's batch caused
    # (``BatchResult.recompiles``); 0 once every kernel is built. The
    # reference counts fresh XLA compilations here.
    recompiles: int = 0
    csr_compactions: int = 0
    csr_dead_frac: float = 0.0
    csr_occupancy: float = 0.0
    core_max: int = 0
    core_mean: float = 0.0
    oracle_ok: bool | None = None   # None = not checked this step
    # flight-recorder join (zeros/None when recording is disabled):
    flight_rounds: int = 0          # rounds the recorder captured this step
    health_ok: bool | None = None   # invariant-monitor verdict so far


@dataclasses.dataclass
class ReplayTrajectory:
    """A replayed stream's core-evolution time series."""

    records: list[ReplayRecord]
    tracked: np.ndarray       # (T,) vertex ids with a full core time series
    core_series: np.ndarray   # (steps, T) int32 — tracked cores per step

    def series(self, field: str) -> np.ndarray:
        """One record field as a (steps,) array."""
        return np.asarray([getattr(r, field) for r in self.records])

    @property
    def total_messages(self) -> int:
        return int(self.series("messages").sum())

    def summary(self) -> dict:
        if not self.records:
            return {"steps": 0}
        msgs = self.series("messages")
        return {
            "steps": len(self.records),
            "total_messages": int(msgs.sum()),
            "mean_messages": round(float(msgs.mean()), 1),
            "mean_rounds": round(float(self.series("rounds").mean()), 2),
            "mean_m": round(float(self.series("m").mean()), 1),
            "max_core_seen": int(self.series("core_max").max()),
            "mean_patch_ms": round(float(self.series("patch_ms").mean()), 3),
            "mean_seed_ms": round(float(self.series("seed_ms").mean()), 3),
            "mean_converge_ms": round(
                float(self.series("converge_ms").mean()), 3),
            "mean_reconstruct_ms": round(
                float(self.series("reconstruct_ms").mean()), 3),
            "mean_step_ms": round(float(self.series("step_ms").mean()), 3),
            "total_heartbeats": int(self.series("heartbeats").sum()),
            "recompiles": int(self.series("recompiles").sum()),
            "oracle_checks": int(sum(r.oracle_ok is not None
                                     for r in self.records)),
            "compactions": int(self.records[-1].csr_compactions),
        }


def record_step(ws: WindowStep, wall_s: float,
                oracle_ok: bool | None) -> ReplayRecord:
    """Flatten one WindowStep into a ReplayRecord."""
    res = ws.result
    actives = res.stats.active_per_round
    core = res.core
    hb = heartbeat_overhead(res.stats)
    rec = _flight.recorder()
    flight_rounds = rec.last_run_rounds if rec.active else 0
    health_ok = _health.get_monitor().ok if rec.active else None
    return ReplayRecord(
        step=ws.step, lo=ws.lo, hi=ws.hi,
        t_lo=round(ws.t_lo, 6), t_hi=round(ws.t_hi, 6), m=ws.m,
        inserted=int(res.delta.inserted.shape[0]),
        deleted=int(res.delta.deleted.shape[0]),
        messages=int(res.total_messages), rounds=int(res.rounds),
        frontier_peak=int(actives.max()) if actives.size else 0,
        region=int(res.region_size), mode=res.mode,
        patch_ms=round(res.patch_s * 1e3, 3),
        step_ms=round(wall_s * 1e3, 3),
        seed_ms=round(res.seed_s * 1e3, 3),
        converge_ms=round(res.converge_s * 1e3, 3),
        reconstruct_ms=round(res.reconstruct_s * 1e3, 3),
        heartbeats=int(hb["heartbeat_messages"]),
        recompiles=int(res.recompiles),
        csr_compactions=int(res.csr_compactions),
        csr_dead_frac=round(res.csr_dead_frac, 4),
        csr_occupancy=round(res.csr_occupancy, 4),
        core_max=int(core.max()) if core.size else 0,
        core_mean=round(float(core.mean()), 4) if core.size else 0.0,
        oracle_ok=oracle_ok,
        flight_rounds=flight_rounds,
        health_ok=health_ok,
    )


def check_step(weng: WindowedKCoreEngine, ws: WindowStep) -> bool:
    """BZ-oracle + edge-set cross-check of one boundary (raises on
    divergence; returns True so callers can record the check happened).

    Explicit raises, not asserts: --verify must keep verifying under
    ``python -O``."""
    wg = weng.window_graph()
    ref = weng.log.edges_between(ws.lo, ws.hi)
    if not (weng.window_edges.shape == ref.shape
            and (weng.window_edges == ref).all()):
        raise AssertionError(
            f"step {ws.step}: maintained window edge set diverged from "
            "EventLog.edges_between")
    eng_g = weng.engine.graph
    if not (eng_g.m == wg.m and (eng_g.src == wg.src).all()
            and (eng_g.dst == wg.dst).all()):
        raise AssertionError(
            f"step {ws.step}: engine graph != materialized window graph")
    if not (ws.result.core == bz_core_numbers(wg)).all():
        raise AssertionError(
            f"step {ws.step}: windowed cores diverged from the BZ oracle")
    return True


def replay(log: EventLog, window, stride, by: str = "count",
           config: StreamingConfig = StreamingConfig(),
           kcore_config: KCoreConfig = KCoreConfig(),
           mesh=None, axis_names=("data",), oracle_every: int = 0, track=None,
           max_steps: int | None = None, *, device=None) -> ReplayTrajectory:
    """Replay a whole event stream through a sliding window.

    ``oracle_every=k`` BZ-verifies every k-th boundary plus the final one
    (0 = never). ``track`` selects vertices whose core time series is kept
    per step: an int means "that many evenly spaced ids", an array means
    those ids, None tracks nothing. ``device`` defaults to CUDA and raises
    without a card; ``mesh``/``axis_names`` go to the maintenance engine.
    """
    weng = WindowedKCoreEngine(log, window, stride, by=by, config=config,
                               kcore_config=kcore_config, mesh=mesh, axis_names=axis_names,
                               device=device)
    if track is None:
        tracked = np.zeros(0, np.int64)
    elif np.isscalar(track):
        tracked = np.unique(np.linspace(0, max(log.n - 1, 0),
                                        int(track)).astype(np.int64))
    else:
        tracked = np.asarray(track, np.int64).reshape(-1)

    records: list[ReplayRecord] = []
    series: list[np.ndarray] = []
    while not weng.done and (max_steps is None
                             or weng.steps_taken < max_steps):
        t0 = _time.perf_counter()
        ws = weng.advance()
        wall_s = _time.perf_counter() - t0
        oracle_ok = None
        last = weng.done or (max_steps is not None
                             and weng.steps_taken >= max_steps)
        if oracle_every and (ws.step % oracle_every == 0 or last):
            oracle_ok = check_step(weng, ws)
        records.append(record_step(ws, wall_s, oracle_ok))
        if tracked.size:
            series.append(ws.result.core[tracked].copy())
    core_series = (np.stack(series) if series
                   else np.zeros((len(records), tracked.size), np.int32))
    return ReplayTrajectory(records=records, tracked=tracked,
                            core_series=core_series)
