"""The port's observability copies (``repro_torch.obs``) against
``repro.obs``: the metrics registry's JSON and Prometheus text, the
invariant monitor's verdicts and counters, the flight recorder's observer
events and run context, and the tracer's ``record``/``annotate``, each fed
the same sequence as the reference's."""

import dataclasses

import numpy as np
import pytest

from repro.core import kcore_decompose as jax_kcore
from repro.graph import generators as jax_gen
from repro.obs import flight as jax_flight
from repro.obs import health as jax_health
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import generators as gen
from repro_torch.obs import flight, health, metrics, trace


def _fill(M, rng_seed):
    """One sequence of counter, gauge and histogram events on a fresh
    registry of module ``M``."""
    reg = M.MetricsRegistry()
    rng = np.random.default_rng(rng_seed)
    for i in range(400):
        op = ("core", "update", "members")[i % 3]
        reg.counter("server_requests_total", op=op).inc()
        reg.histogram("server_request_seconds", op=op).observe(float(rng.lognormal(-7, 1)))
        if i % 50 == 0:
            reg.counter("server_errors_total", op=op, why='bad "id"\n').inc(2)
    reg.gauge("kcore_wall_seconds", graph="FC").set(1.25)
    reg.gauge("kcore_wall_seconds", graph="FC").set(0.5)
    reg.gauge("9bad-name").set(-3)
    small = reg.histogram("tiny", capacity=8)
    for x in range(100):
        small.observe(float(x))
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_registry_equals_reference(seed):
    port, ref = _fill(metrics, seed), _fill(jax_metrics, seed)
    assert port.to_json() == ref.to_json()
    assert port.to_prometheus() == ref.to_prometheus()
    h, hr = (r.histogram("server_request_seconds", op="core") for r in (port, ref))
    assert h.snapshot() == hr.snapshot()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert h.quantile(q) == hr.quantile(q)
    with pytest.raises(ValueError):
        port.counter("server_requests_total", op="core").inc(-1)


def test_metrics_module_functions_share_one_registry():
    metrics.counter("test_obs_total", case="a").inc(3)
    assert metrics.get_registry().counter("test_obs_total", case="a").value == 3.0
    assert "test_obs_total" in metrics.to_prometheus()


def _record(M, **kw):
    base = dict(seq=0, run=0, engine="streaming", mode="dense", batch=None, round=1, frontier=5,
                messages=10, changed=2, est_rises=0, drop_hist=None, est_sum=None, host_s=0.0,
                device_s=0.0, dispatch="", compiles=0, t=0.0)
    base.update(kw)
    return M.FlightRecord(**base)


def _events(M):
    """Run events and records that exercise every anomaly kind of the
    monitor, then a clean run."""
    R = lambda **kw: {"kind": "round", "record": _record(M, **kw)}  # noqa: E731
    evs = [{"kind": "run_start", "run": 0}]
    evs += [R(round=0, est_sum=50), R(round=1, est_sum=40), R(round=2, est_sum=45),
            R(round=3, est_rises=2), R(round=4, changed=0, messages=7),
            R(round=5, changed=9, frontier=4)]
    evs += [R(round=6 + i, frontier=4) for i in range(6)]
    evs += [{"kind": "run_end", "run": 0, "converged": False, "rounds": 12, "mode": "dense"},
            {"kind": "run_start", "run": 1},
            {"kind": "run_end", "run": 1, "converged": True, "est_rises": 3, "mode": "fused"},
            {"kind": "run_start", "run": 2},
            R(run=2, round=1, frontier=3), R(run=2, round=2, frontier=1),
            {"kind": "run_end", "run": 2, "converged": True}]
    return evs


def test_health_verdicts_equal_reference():
    port_reg, ref_reg = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    port = health.InvariantMonitor(registry=port_reg, stall_rounds=4)
    ref = jax_health.InvariantMonitor(registry=ref_reg, stall_rounds=4)
    assert port.verdict() == ref.verdict() and port.ok
    for a, b in zip(_events(flight), _events(jax_flight)):
        port(a)
        ref(b)
        assert port.verdict() == ref.verdict()
    for key, mode, total in [(("t", 0), "dense", 10), (("t", 0), "fused", 10),
                             (("t", 1), "dense", 10), (("t", 1), "compact", 11)]:
        port.observe_bill(key, mode, total)
        ref.observe_bill(key, mode, total)
    v = port.verdict()
    assert v == ref.verdict() and v["status"] == "anomalous"
    assert set(v["kinds"]) == {"non_monotone_estimate", "messages_without_change",
                               "changed_exceeds_frontier", "frontier_stall", "unconverged_run",
                               "mode_bill_mismatch"}
    assert port_reg.to_json() == ref_reg.to_json()
    port.reset()
    ref.reset()
    assert port.verdict() == ref.verdict() and port.ok
    assert port_reg.to_json() == ref_reg.to_json()


@pytest.fixture
def recorders():
    for f in (flight, jax_flight):
        f.enable()
        f.reset()
    yield
    for f in (flight, jax_flight):
        f.disable()
        f.reset()


def _strip(ev):
    """An observer event without its wall fields (the record's clocks)."""
    ev = dict(ev)
    if "record" in ev:
        rec = dataclasses.asdict(ev["record"])
        ev["record"] = {k: v for k, v in rec.items()
                        if k not in ("host_s", "device_s", "t", "dispatch", "compiles")}
    return ev


@pytest.mark.parametrize("fused", [False, True])
def test_flight_observer_events_equal_reference(recorders, fused):
    """The observer hook sees the reference's run, round and run-end events
    for a static decomposition, and the monitor installed on it gives the
    reference's verdict; ``set_context`` labels the next run only."""
    seen, seen_ref = [], []
    flight.get_recorder().add_observer(seen.append)
    jax_flight.get_recorder().add_observer(seen_ref.append)
    try:
        for f in (flight, jax_flight):
            f.recorder().set_context(engine="temporal", step=4)
        kcore_decompose(gen.barabasi_albert(300, 4, seed=2), fused=fused, device="cpu")
        jax_kcore(jax_gen.barabasi_albert(300, 4, seed=2), fused=fused)
        kcore_decompose(gen.chain(40), device="cpu")
        jax_kcore(jax_gen.chain(40))
    finally:
        flight.get_recorder().remove_observer(seen.append)
        jax_flight.get_recorder().remove_observer(seen_ref.append)
    assert [_strip(e) for e in seen] == [_strip(e) for e in seen_ref]
    assert seen[0]["kind"] == "run_start" and seen[0]["engine"] == "temporal"
    assert seen[0]["batch"] == 4
    ends = [e for e in seen if e["kind"] == "run_end"]
    assert len(ends) == 2 and ends[1]["engine"] == "static" and ends[1]["converged"] is True
    rec = flight.get_recorder()
    assert rec.last_run_rounds == jax_flight.get_recorder().last_run_rounds > 0
    assert rec.runs == 2 and flight.enabled() and flight.recorder() is rec


def test_health_install_follows_the_recorder(recorders):
    health.reset()
    jax_health.reset()
    try:
        assert health.install() is health.get_monitor()
        jax_health.install()
        health.install()                                   # idempotent
        for f in (flight, jax_flight):
            rec = f.recorder()
            rec.start_run("streaming", "dense")
            rec.record_round(4, 8, 2, est=np.array([3, 2]), prev_est=np.array([3, 1]))
            rec.start_run("streaming", "dense")            # closes the open run
            rec.end_run(converged=True)
        assert health.verdict() == jax_health.verdict()
        assert not health.ok() and health.verdict()["runs_seen"] == 2
    finally:
        flight.get_recorder().remove_observer(health.get_monitor())
        jax_flight.get_recorder().remove_observer(jax_health.get_monitor())
        health.reset()
        jax_health.reset()
    assert health.ok()


def test_disabled_recorder_is_inert():
    assert not flight.enabled()
    rec = flight.recorder()
    assert rec is flight.NULL_RECORDER and not rec.active
    rec.set_context(engine="temporal")
    assert rec.start_run("static") == -1


def test_tracer_record_current_and_annotate():
    for T in (trace, jax_trace):
        T.reset()
        T.enable()
    try:
        for T in (trace, jax_trace):
            assert T.enabled() and T.current() is None
            with T.span("outer", a=1) as sp:
                assert T.current() is sp
                T.annotate(b=2)
                T.record("health.anomaly", 0.0, kind="x")
                T.record("build", 0.25)
            T.annotate(c=3)                                # no open span: no-op
        got, want = trace.events(), jax_trace.events()
        assert [(e["name"], e.get("args")) for e in got] == \
            [(e["name"], e.get("args")) for e in want]
        assert got[-1]["args"] == {"a": 1, "b": 2}
        assert abs(got[1]["dur"] - 0.25e6) < 1.0
    finally:
        for T in (trace, jax_trace):
            T.disable()
            T.reset()
    trace.record("ignored", 1.0)
    assert trace.events() == [] and trace.get_tracer().enabled is False
