"""The port's temporal subsystem (``repro_torch.temporal``) against
``repro.temporal``.

Event logs, window batches, every ``WindowStep`` field and every accounting
field of each step's ``BatchResult``, replay records (with and without the
flight recorder and the invariant monitor), the as-of ring, the temporal
gate's four committed ratios and a 10k-vertex replay must equal the
reference's exactly: all of them are integers or come from the same
integer arithmetic. The port runs on the CPU, so through the kernels'
plain versions.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro.obs import flight as jax_flight
from repro.obs import health as jax_health
from repro.obs import metrics as jax_metrics
from repro.streaming import engine as jax_engine
from repro.streaming import server as jax_server
from repro.temporal import events as jax_events
from repro.temporal.replay import record_step as jax_record_step
from repro.temporal.replay import replay as jax_replay
from repro.temporal import window as jax_window
from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import generators as gen
from repro_torch.obs import flight, health, metrics
from repro_torch.streaming import EdgeBatch, StreamingConfig, StreamingKCoreEngine
from repro_torch.temporal import (ADD, REMOVE, CoreCheckpointRing, EventLog, WindowedKCoreEngine,
                                  contact_bursts, events, load_event_log, parse_event_text,
                                  replay, temporal_barabasi_albert, temporal_snap_analogue)
from repro_torch.temporal.replay import check_step, record_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("dense", "compact", "fused", "auto")
STATS = ("messages_per_round", "active_per_round", "changed_per_round")
# walls and kernel builds are not accounting (``stage_s`` is the port's own wall)
EXEMPT = {"patch_s", "seed_s", "converge_s", "reconstruct_s", "recompiles", "compile_s",
          "stage_s"}
RECORD_WALLS = {"patch_ms", "step_ms", "seed_ms", "converge_ms", "reconstruct_ms",
                "recompiles"}


def _log_arrays(log):
    return (log.time, log.u, log.v, log.kind, log.n)


def _assert_log_equal(port, ref):
    for a, b in zip(_log_arrays(port), _log_arrays(ref)):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _assert_batch_equal(port, ref):
    for f in dataclasses.fields(ref):
        if f.name in EXEMPT:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "stats":
            for k in STATS:
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        elif f.name == "delta":
            for k in ("inserted", "deleted", "touched"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
            assert a.compacted == b.compacted
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


def _assert_step_equal(port, ref):
    for f in ("step", "lo", "hi", "t_lo", "t_hi", "m"):
        assert getattr(port, f) == getattr(ref, f), f
    np.testing.assert_array_equal(port.batch.insert, ref.batch.insert)
    np.testing.assert_array_equal(port.batch.delete, ref.batch.delete)
    _assert_batch_equal(port.result, ref.result)


def _assert_records_equal(port, ref, skip=()):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in dataclasses.fields(b):
            if f.name not in RECORD_WALLS and f.name not in skip:
                assert getattr(a, f.name) == getattr(b, f.name), (b.step, f.name)


# ------------------------------ event logs -------------------------------- #

def test_event_log_datacleanse_and_canonical():
    args = dict(time=[0.0, 1.0, 2.0, 3.0], u=[5, 2, 3, 1], v=[1, 2, 0, 5], kind=[1, 1, 1, -1], n=6)
    log = EventLog.make(**args)
    _assert_log_equal(log, jax_events.EventLog.make(**args))
    assert len(log) == 3 and log.u.tolist() == [1, 0, 1] and log.v.tolist() == [5, 3, 5]
    assert log.num_adds == 2
    ev = log[2]
    assert (ev.t, ev.u, ev.v, ev.is_add) == (3.0, 1, 5, False)
    rows = [(0.0, 3, 1, 1), (0.5, 2, 2, 1), (1.0, 0, 4, -1)]
    _assert_log_equal(EventLog.from_events(rows, n=5),
                      jax_events.EventLog.from_events(rows, n=5))


@pytest.mark.parametrize("args", [
    ([1.0, 0.5], [0, 1], [1, 2], [1, 1], None),      # non-monotone time
    ([0.0], [0], [1], [2], None),                      # bad kind
    ([0.0], [0], [9], [1], 4),                         # id outside the universe
    ([0.0], [-1], [1], [1], None),                     # negative id
    ([0.0, 1.0], [0], [1], [1], None),                 # ragged columns
], ids=["time", "kind", "universe", "negative", "ragged"])
def test_event_log_rejects_what_the_reference_rejects(args):
    *cols, n = args
    with pytest.raises(ValueError):
        jax_events.EventLog.make(*cols, n=n)
    with pytest.raises(ValueError):
        EventLog.make(*cols, n=n)


def test_edges_between_last_event_wins():
    cols = dict(time=[0, 1, 2, 3, 4, 5], u=[0, 0, 0, 1, 0, 1], v=[1, 1, 1, 2, 1, 2],
                kind=[ADD, REMOVE, ADD, ADD, REMOVE, REMOVE], n=3)
    log, ref = EventLog.make(**cols), jax_events.EventLog.make(**cols)
    want = {(0, 4): [[0, 1], [1, 2]], (0, 5): [[1, 2]], (0, 6): [], (2, 4): [[0, 1], [1, 2]],
            (1, 2): [], (4, 2): [], (-3, 99): []}
    for (lo, hi), edges in want.items():
        got = log.edges_between(lo, hi)
        np.testing.assert_array_equal(got, ref.edges_between(lo, hi))
        assert got.tolist() == edges and got.dtype == np.int64
    g = log.graph_between(0, 4)
    assert g.n == 3 and g.m == 2


def test_text_and_npz_round_trips_between_the_packages(tmp_path):
    log = temporal_barabasi_albert(40, 2, seed=3, remove_frac=0.3)
    ref = jax_events.temporal_barabasi_albert(40, 2, seed=3, remove_frac=0.3)
    assert log.to_text() == ref.to_text()
    _assert_log_equal(parse_event_text(log.to_text(), n=log.n),
                      jax_events.parse_event_text(ref.to_text(), n=ref.n))
    log.save_npz(str(tmp_path / "port"))                 # .npz appended, as the reference does
    ref.save_npz(str(tmp_path / "ref.npz"))
    _assert_log_equal(load_event_log(str(tmp_path / "ref.npz")), ref)
    _assert_log_equal(jax_events.load_event_log(str(tmp_path / "port.npz")), ref)
    (tmp_path / "log.txt").write_text(log.to_text())
    _assert_log_equal(load_event_log(str(tmp_path / "log.txt"), n=log.n),
                      jax_events.load_event_log(str(tmp_path / "log.txt"), n=log.n))
    plain = "0.5 0 1\n1.5 1 2\n# c\n% c\n2.5,2,0,-\n"
    _assert_log_equal(parse_event_text(plain, n=3), jax_events.parse_event_text(plain, n=3))
    assert parse_event_text(plain, n=3).num_adds == 2
    with pytest.raises(ValueError):
        parse_event_text("0.5 0 1 r\n", n=3)


GENERATORS = {
    "ba": lambda E: E.temporal_barabasi_albert(60, 3, seed=1, remove_frac=0.2),
    "ba-no-removes": lambda E: E.temporal_barabasi_albert(300, 4, seed=5, mean_dt=0.3),
    "contact": lambda E: E.contact_bursts(50, n_bursts=8, seed=1),
    "contact-wide": lambda E: E.contact_bursts(200, n_bursts=30, group_size=20,
                                               edges_per_burst=60, seed=4),
    "FC": lambda E: E.temporal_snap_analogue("FC", scale=0.02, seed=1, remove_frac=0.2),
    "EEN": lambda E: E.temporal_snap_analogue("EEN", scale=0.05, seed=0, remove_frac=0.15,
                                              mean_lifetime=40.0),
    "MGF-rmat": lambda E: E.temporal_snap_analogue("MGF", scale=0.02, seed=2),
}


@pytest.mark.parametrize("name", GENERATORS)
def test_generators_equal_reference(name):
    log = GENERATORS[name](events)
    _assert_log_equal(log, GENERATORS[name](jax_events))
    assert len(log) > 0 and (np.diff(log.time) >= 0).all() and (log.u < log.v).all()
    assert np.isin(log.kind, (ADD, REMOVE)).all() and int(log.v.max()) < log.n


def test_contact_bursts_tear_every_contact_down():
    clog = contact_bursts(50, n_bursts=8, seed=1)
    assert (clog.kind == REMOVE).sum() > 0
    assert len(clog.edges_between(0, len(clog))) == 0


@pytest.mark.parametrize("abbrev,scale,seed", [("SPR", 0.002, 0), ("EEN", 0.05, 3)])
def test_snap_events_helper_equals_temporal_snap_analogue(abbrev, scale, seed):
    g = gen.snap_analogue(abbrev, scale=scale, seed=seed)
    got = events._snap_events(g, seed=seed, remove_frac=0.15)
    _assert_log_equal(got, temporal_snap_analogue(abbrev, scale, seed=seed, remove_frac=0.15))
    _assert_log_equal(got, jax_events.temporal_snap_analogue(abbrev, scale, seed=seed,
                                                             remove_frac=0.15))


# -------------------------------- windows --------------------------------- #

def _traces(E):
    """(log, window, stride, by) per trace: a count window over timestamped
    preferential attachment and over an EEN analogue, a time window over
    contact bursts."""
    clog = E.contact_bursts(60, n_bursts=16, seed=0)
    span = clog.t_max - clog.t_min
    return {
        "ba": (E.temporal_barabasi_albert(400, 3, seed=0, remove_frac=0.1), 300, 60, "count"),
        "contact": (clog, 3 * span / 12, span / 12, "time"),
        "EEN": (E.temporal_snap_analogue("EEN", 0.03, seed=0, remove_frac=0.15), 900, 300,
                "count"),
    }


ADVANCES = (1, 1, 2, 1, 3, 1, 1)     # 10 strides in 7 advances


@pytest.mark.parametrize("by", ["count", "time"])
def test_peek_batch_equals_reference(by):
    name = "ba" if by == "count" else "contact"
    log, window, stride, _ = _traces(events)[name]
    rlog, *_ = _traces(jax_events)[name]
    port = WindowedKCoreEngine(log, window, stride, by=by, device="cpu")
    ref = jax_window.WindowedKCoreEngine(rlog, window, stride, by=by)
    for _ in range(4):
        for k in (1, 2, 5):
            (pb, pe), (rb, re) = port.peek_batch(k), ref.peek_batch(k)
            np.testing.assert_array_equal(pb.insert, rb.insert)
            np.testing.assert_array_equal(pb.delete, rb.delete)
            np.testing.assert_array_equal(pe, re)
        port.advance()
        ref.advance()
        assert port.bounds == ref.bounds and port.t_bounds == ref.t_bounds
    with pytest.raises(ValueError):
        port.peek_batch(0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["ba", "contact", "EEN"])
def test_window_steps_equal_reference(name, mode):
    """Seven advances (ten strides, ``advance(k)`` with k = 2 and 3 among
    them): every WindowStep field, the batch, and every BatchResult field but
    the walls and the builds equal the reference window's."""
    log, window, stride, by = _traces(events)[name]
    rlog, *_ = _traces(jax_events)[name]
    port = WindowedKCoreEngine(log, window, stride, by=by,
                               config=StreamingConfig(frontier=mode), device="cpu")
    ref = jax_window.WindowedKCoreEngine(rlog, window, stride, by=by,
                                         config=jax_engine.StreamingConfig(frontier=mode))
    assert port.config.min_slack == ref.config.min_slack
    slid = False
    for k in ADVANCES:
        got, want = port.advance(k), ref.advance(k)
        _assert_step_equal(got, want)
        np.testing.assert_array_equal(port.window_edges, ref.window_edges)
        np.testing.assert_array_equal(got.core, bz_core_numbers(port.window_graph()))
        slid |= got.batch.delete.shape[0] > 0
        if mode == "auto":
            assert got.result.mode in ("compact", "fused")
    assert slid and port.steps_taken == ref.steps_taken == len(ADVANCES)
    assert port.done == ref.done


def _random_log(rng, n, n_events):
    u = rng.integers(0, n, size=n_events)
    v = rng.integers(0, n, size=n_events)
    kind = rng.choice([1, -1], size=n_events)
    time = np.cumsum(rng.integers(0, 4, size=n_events).astype(np.float64))
    return EventLog.make(time, u, v, kind, n=n)


@pytest.mark.parametrize("seed", range(6))
def test_window_advance_equals_explicit_batch(seed):
    """After j advances, k more strides one at a time, one ``advance(k)``
    and the equivalent explicit EdgeBatch on an engine built from the
    mid-point window graph give the same graph and cores, the BZ cores of
    the window graph (``tests/test_temporal.py``'s check, on the port)."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        log = _random_log(rng, int(rng.integers(3, 11)), int(rng.integers(1, 51)))
        window, stride = int(rng.integers(1, 13)), int(rng.integers(1, 7))
        j, k = int(rng.integers(0, 4)), int(rng.integers(1, 5))
        wa = WindowedKCoreEngine(log, window, stride, device="cpu")
        wb = WindowedKCoreEngine(log, window, stride, device="cpu")
        for _ in range(j):
            wa.advance()
            wb.advance()
        direct = StreamingKCoreEngine(wa.window_graph(), device="cpu")
        batch, _ = wa.peek_batch(k)
        for _ in range(k):
            wa.advance()
        wb.advance(k)
        res = direct.apply_batch(batch)
        ga, gb, gd = wa.engine.graph, wb.engine.graph, direct.graph
        assert ga.m == gb.m == gd.m
        for x in (gb, gd):
            np.testing.assert_array_equal(ga.src, x.src)
            np.testing.assert_array_equal(ga.dst, x.dst)
        np.testing.assert_array_equal(wa.core, wb.core)
        np.testing.assert_array_equal(wa.core, res.core)
        lo, hi = wa.bounds
        np.testing.assert_array_equal(wa.window_edges, log.edges_between(lo, hi))
        np.testing.assert_array_equal(wa.core, bz_core_numbers(wa.window_graph()))


def test_count_window_rejects_fractional_stride():
    log = _random_log(np.random.default_rng(0), 5, 20)
    for window, stride in ((10, 0.5), (0.5, 2), (10, -1)):
        with pytest.raises(ValueError):
            WindowedKCoreEngine(log, window, stride, device="cpu")
    with pytest.raises(ValueError):
        WindowedKCoreEngine(log, 10, 1, by="nope", device="cpu")
    weng = WindowedKCoreEngine(log, 10.0, 2.9, device="cpu")
    assert (weng.window, weng.stride) == (10, 2)


def test_time_window_matches_bz():
    rng = np.random.default_rng(12)
    for _ in range(6):
        log = _random_log(rng, int(rng.integers(3, 11)), int(rng.integers(1, 51)))
        weng = WindowedKCoreEngine(log, window=float(rng.uniform(0.5, 8)),
                                   stride=float(rng.uniform(0.25, 4)), by="time", device="cpu")
        steps = 0
        while not weng.done and steps < 12:
            ws = weng.advance()
            lo, hi = weng.bounds
            assert (ws.lo, ws.hi) == (lo, hi)
            np.testing.assert_array_equal(weng.window_edges, log.edges_between(lo, hi))
            np.testing.assert_array_equal(ws.core, bz_core_numbers(weng.window_graph()))
            steps += 1


def test_steps_iterates_until_the_stream_is_consumed():
    log = temporal_barabasi_albert(80, 2, seed=0, remove_frac=0.2)
    weng = WindowedKCoreEngine(log, 60, 25, device="cpu")
    assert len(list(weng.steps(max_steps=3))) == 3
    rest = list(weng.steps())
    assert weng.done and rest[-1].hi == len(log) and rest[-1].step == weng.steps_taken - 1


# -------------------------------- replay ---------------------------------- #

@pytest.mark.parametrize("mode", ["dense", "fused"])
@pytest.mark.parametrize("name", ["ba", "contact"])
def test_replay_records_equal_reference(name, mode):
    """Every ReplayRecord field but the walls and the builds, the tracked
    core series and the summary's accounting, with ``oracle_every=1`` and
    ``track=8``, the flight recorder off."""
    log, window, stride, by = _traces(events)[name]
    rlog, *_ = _traces(jax_events)[name]
    got = replay(log, window, stride, by=by, config=StreamingConfig(frontier=mode),
                 oracle_every=1, track=8, max_steps=8, device="cpu")
    want = jax_replay(rlog, window, stride, by=by,
                             config=jax_engine.StreamingConfig(frontier=mode),
                             oracle_every=1, track=8, max_steps=8)
    _assert_records_equal(got.records, want.records)
    assert all(r.oracle_ok is True and r.flight_rounds == 0 and r.health_ok is None
               for r in got.records)
    np.testing.assert_array_equal(got.tracked, want.tracked)
    np.testing.assert_array_equal(got.core_series, want.core_series)
    sg, sw = got.summary(), want.summary()
    for k in ("steps", "total_messages", "mean_messages", "mean_rounds", "mean_m",
              "max_core_seen", "total_heartbeats", "oracle_checks", "compactions"):
        assert sg[k] == sw[k], k


def test_replay_oracle_cadence_and_track_ids():
    log = temporal_barabasi_albert(120, 3, seed=0, remove_frac=0.15)
    traj = replay(log, window=150, stride=60, oracle_every=2, track=[3, 7, 9], device="cpu")
    ref = jax_replay(jax_events.temporal_barabasi_albert(120, 3, seed=0, remove_frac=0.15),
                            window=150, stride=60, oracle_every=2, track=[3, 7, 9])
    _assert_records_equal(traj.records, ref.records)
    checked = [r.oracle_ok for r in traj.records]
    assert checked[0] is True and checked[-1] is True and None in checked
    np.testing.assert_array_equal(traj.core_series, ref.core_series)
    assert traj.core_series.shape == (len(traj.records), 3)
    np.testing.assert_array_equal(traj.series("messages"), ref.series("messages"))
    assert replay(log, 150, 60, device="cpu", max_steps=0).summary() == {"steps": 0}


@pytest.fixture
def monitors():
    """Flight recording on, each package's invariant monitor installed;
    everything reset before and after."""
    for f, h in ((flight, health), (jax_flight, jax_health)):
        f.enable()
        f.reset()
        h.reset()
        h.install()
    yield
    for f, h in ((flight, health), (jax_flight, jax_health)):
        f.get_recorder().remove_observer(h.get_monitor())
        f.disable()
        f.reset()
        h.reset()


def _anomaly_counters(registry):
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in registry.to_json().get("obs_health_anomalies_total", [])}


@pytest.mark.parametrize("mode", ["dense", "compact", "fused"])
def test_replay_with_flight_and_health_equals_reference(monitors, mode):
    log, window, stride, by = _traces(events)["EEN"]
    rlog, *_ = _traces(jax_events)["EEN"]
    got = replay(log, window, stride, by=by, config=StreamingConfig(frontier=mode),
                 oracle_every=1, track=8, max_steps=6, device="cpu")
    want = jax_replay(rlog, window, stride, by=by,
                             config=jax_engine.StreamingConfig(frontier=mode),
                             oracle_every=1, track=8, max_steps=6)
    _assert_records_equal(got.records, want.records)
    assert all(r.flight_rounds > 0 and r.health_ok is True for r in got.records)
    assert health.verdict() == jax_health.verdict()
    assert health.verdict()["runs_seen"] == 7      # the initial decomposition + 6 advances
    assert _anomaly_counters(metrics.get_registry()) == \
        _anomaly_counters(jax_metrics.get_registry())

    def labelled(records):
        return [(r.engine, r.batch, r.round, r.frontier, r.messages, r.changed, r.est_rises,
                 r.est_sum) for r in records]

    assert labelled(flight.records()) == labelled(jax_flight.records())
    assert {r.engine for r in flight.records()} == {"static", "temporal"}


def test_replay_health_sees_an_injected_anomaly_as_the_reference_does(monitors):
    """A rise injected into both recorders mid-replay: both monitors turn
    anomalous with the same verdict, and the next record says so."""
    log, window, stride, by = _traces(events)["ba"]
    rlog, *_ = _traces(jax_events)["ba"]
    port = WindowedKCoreEngine(log, window, stride, by=by, device="cpu")
    ref = jax_window.WindowedKCoreEngine(rlog, window, stride, by=by)
    for f in (flight, jax_flight):
        rec = f.recorder()
        rec.start_run("streaming", "dense")
        rec.record_round(5, 10, 2, est=np.array([2, 3]), prev_est=np.array([2, 1]))
        rec.record_round(5, 10, 0)
        rec.end_run(converged=False)
    got = [record_step(port.advance(), 0.0, None) for _ in range(2)]
    want = [jax_record_step(ref.advance(), 0.0, None) for _ in range(2)]
    _assert_records_equal(got, want)
    assert got[-1].health_ok is False
    assert health.verdict() == jax_health.verdict()
    assert health.verdict()["kinds"] == {"non_monotone_estimate": 1,
                                         "messages_without_change": 1, "unconverged_run": 1}


def test_check_step_raises_on_divergence():
    log, window, stride, by = _traces(events)["ba"]
    weng = WindowedKCoreEngine(log, window, stride, by=by, device="cpu")
    ws = weng.advance(2)
    assert check_step(weng, ws) is True
    bad = dataclasses.replace(ws, result=dataclasses.replace(ws.result, core=ws.core + 1))
    with pytest.raises(AssertionError, match="BZ oracle"):
        check_step(weng, bad)
    with pytest.raises(AssertionError, match="edges_between"):
        check_step(weng, dataclasses.replace(ws, hi=ws.lo))
    absent = next((0, v) for v in range(1, log.n) if not weng.engine.csr.has_edge(0, v))
    weng.engine.apply_batch(EdgeBatch.make(insert=[absent]))
    with pytest.raises(AssertionError, match="materialized window graph"):
        check_step(weng, ws)


# ------------------------------ as-of ring -------------------------------- #

def _rings(capacity):
    return CoreCheckpointRing(capacity), jax_server.CoreCheckpointRing(capacity)


def _same(call):
    """``call`` on the port's ring and the reference's: the same answer or
    the same exception type."""
    out = []
    for ring in (0, 1):
        try:
            out.append(("ok", call(ring)))
        except (KeyError, ValueError) as e:
            out.append((type(e).__name__, None))
    (ka, a), (kb, b) = out
    assert ka == kb
    if ka == "ok" and a is not None:
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    return ka


def test_checkpoint_ring_asof_and_eviction():
    rings = _rings(3)
    assert _same(lambda i: rings[i].asof(0.0)) == "KeyError"
    for t in (1.0, 2.0, 3.0, 4.0):             # 1.0 evicted by capacity
        for ring in rings:
            ring.push(t, np.full(4, int(t)))
    assert rings[0].times.tolist() == rings[1].times.tolist() == [2.0, 3.0, 4.0]
    for t in (3.7, 4.0, 99.0):
        assert _same(lambda i: rings[i].asof(t)) == "ok"
    bt, core = rings[0].asof(3.7)
    assert bt == 3.0 and (core == 3).all()
    assert _same(lambda i: rings[i].asof(1.5)) == "KeyError"
    assert _same(lambda i: rings[i].push(2.0, np.zeros(4))) == "ValueError"
    with pytest.raises(ValueError):
        core[0] = 99                            # retained snapshots are read-only


def test_checkpoint_ring_edge_cases():
    with pytest.raises(ValueError):
        CoreCheckpointRing(capacity=0)
    rings = _rings(1)
    for t in (1.0, 2.0):
        for ring in rings:
            ring.push(t, np.full(3, int(t)))
    assert len(rings[0]) == 1 and rings[0].times.tolist() == [2.0]
    assert _same(lambda i: rings[i].asof(2.0)) == "ok"
    assert _same(lambda i: rings[i].asof(1.0)) == "KeyError"
    rings = _rings(4)                           # equal times: the latest wins
    for ring in rings:
        ring.push(5.0, np.full(2, 1))
        ring.push(5.0, np.full(2, 2))
    assert _same(lambda i: rings[i].asof(5.0)) == "ok"
    assert (rings[0].asof(5.0)[1] == 2).all()
    rings = _rings(3)                           # many wraparounds
    for t in range(10):
        for ring in rings:
            ring.push(float(t), np.full(2, t))
    assert rings[0].times.tolist() == [7.0, 8.0, 9.0]
    for t in (8.5, 6.999, 7.0):
        _same(lambda i: rings[i].asof(t))


def test_checkpoint_ring_state_and_snapshot():
    rings = _rings(3)
    for t in range(5):
        for ring in rings:
            ring.push(float(t), np.arange(4) + t)
    state = rings[0].state_dict()
    for k, v in rings[1].state_dict().items():
        np.testing.assert_array_equal(state[k], v)
        assert state[k].dtype == v.dtype
    view = rings[0].snapshot()
    for ring in rings:
        ring.push(9.0, np.zeros(4))
    assert len(view) == 3 and view.asof(3.5)[0] == 3.0     # the view stays as it was
    small = CoreCheckpointRing(2)
    small.load_state(state)                     # keeps the newest it can hold
    assert small.times.tolist() == [3.0, 4.0]
    np.testing.assert_array_equal(small.asof(4.0)[1], np.arange(4) + 4)
    empty = CoreCheckpointRing(2).state_dict()
    assert empty["cores"].shape == (0, 0) and empty["times"].shape == (0,)


# -------------------------------- the gate -------------------------------- #

BASELINE = json.loads((ROOT / "benchmarks" / "temporal_baseline.json").read_text())
GATE = BASELINE["settings"]


def _gate_trace(name):
    """``benchmarks/temporal_replay.py::traces`` at the baseline's settings,
    on the port's generators."""
    n, steps, strides = GATE["target_n"], GATE["steps"], GATE["window_strides"]
    if name in ("EEN", "FC"):
        log = temporal_snap_analogue(name, scale=n / gen.SNAP_BY_ABBREV[name].n, seed=0,
                                     remove_frac=GATE["snap_remove_frac"])
    elif name == "ba":
        log = temporal_barabasi_albert(n, 3, seed=0, remove_frac=GATE["ba_remove_frac"])
    else:
        log = contact_bursts(max(n // 10, 20), n_bursts=4 * steps, seed=0)
        stride = max((log.t_max - log.t_min) / (steps + 2), 1e-9)
        return log, strides * stride, stride, "time"
    stride = max(len(log) // (steps + 2), 1)
    return log, strides * stride, stride, "count"


@pytest.mark.parametrize("name", GATE["traces"])
def test_temporal_gate_ratio_reproduces(name):
    """``benchmarks/temporal_replay.py::run_records`` on the port: the mean
    ratio of each window advance's messages to a from-scratch decomposition
    of its window graph equals the committed baseline's, every boundary
    BZ-checked."""
    log, window, stride, by = _gate_trace(name)
    traj = replay(log, window, stride, by=by, oracle_every=1,
                  config=StreamingConfig(frontier=GATE["frontier"]), max_steps=GATE["steps"],
                  device="cpu")
    ratios = []
    for rec in traj.records:
        assert rec.oracle_ok is True
        scratch = kcore_decompose(log.graph_between(rec.lo, rec.hi), device="cpu")
        ratios.append(round(rec.messages / max(scratch.stats.total_messages, 1), 4))
    assert len(ratios) == GATE["steps"]
    assert round(float(np.mean(ratios)), 4) == BASELINE["mean_ratio"][name]


# --------------------------- the slice as a whole -------------------------- #

@pytest.fixture(scope="module")
def een_10k():
    """``tests/test_temporal.py:341``'s geometry: a 10k-vertex temporal EEN
    analogue, stride a fifth of the stream, window two strides, 4 steps; the
    reference's dense replay."""
    scale = 10_000 / gen.SNAP_BY_ABBREV["EEN"].n
    log = temporal_snap_analogue("EEN", scale=scale, seed=0, remove_frac=0.15)
    stride = len(log) // 5
    # the same log for the reference (its generator, equal to the port's as
    # ``test_generators_equal_reference`` holds, takes 40 s at this size)
    rlog = jax_events.EventLog(time=log.time, u=log.u, v=log.v, kind=log.kind, n=log.n)
    ref = jax_replay(rlog, 2 * stride, stride,
                     config=jax_engine.StreamingConfig(frontier="dense"), oracle_every=1,
                     max_steps=4)
    return log, stride, ref


@pytest.mark.parametrize("mode", MODES)
def test_windowed_replay_10k_een_equals_reference_dense(een_10k, mode):
    log, stride, ref = een_10k
    assert log.n >= 10_000
    got = replay(log, 2 * stride, stride, config=StreamingConfig(frontier=mode),
                 oracle_every=1, max_steps=4, device="cpu")
    _assert_records_equal(got.records, ref.records, skip=("mode",))
    assert all(r.oracle_ok is True for r in got.records)      # BZ at every boundary
    assert got.records[-1].lo > 0                              # the window slid
