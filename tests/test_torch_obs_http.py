"""The port's live observability endpoint (``repro_torch.obs.http``):
``/metrics``, ``/healthz``, ``/debug/flight`` and the ``/query/*`` routes of
the snapshot-isolated front end, scraped with urllib on 127.0.0.1, an
ephemeral port, as ``tests/test_obs_http.py`` scrapes the reference's. The
query routes' status codes and JSON bodies equal the reference endpoint's
over the reference's front end on the same graph."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import streaming as jax_streaming
from repro.graph import generators as jax_gen
from repro.obs.http import start_server as jax_start_server
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import generators as gen
from repro_torch.obs import flight, health, metrics
from repro_torch.obs.http import ObsHTTPServer, start_server
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.streaming import (ConcurrentKCoreServer, KCoreServer, random_churn_batch)
from repro_torch.temporal import WindowedKCoreEngine, temporal_barabasi_albert


@pytest.fixture()
def server():
    srv = start_server(port=0)
    yield srv
    srv.stop()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:           # 4xx/5xx still carry a body
        return err.code, err.headers.get("Content-Type"), err.read()


def test_ephemeral_port_index_and_daemon_threads(server):
    assert server.port > 0 and server.host == "127.0.0.1"
    assert server.url == f"http://127.0.0.1:{server.port}"
    code, _, body = _get(server.url + "/")
    assert code == 200 and b"/metrics" in body and b"/query/<op>" in body
    assert server._httpd.daemon_threads and server._thread.daemon
    assert server.start() is server                 # starting twice is a no-op


def test_metrics_endpoint_serves_prometheus_text(server):
    metrics.counter("obs_http_test_total", probe="a").inc(3)
    code, ctype, body = _get(server.url + "/metrics")
    assert code == 200 and ctype.startswith("text/plain") and "version=0.0.4" in ctype
    text = body.decode()
    assert "# TYPE obs_http_test_total counter" in text
    assert 'obs_http_test_total{probe="a"} 3.0' in text


def test_added_registry_is_rendered_once(server):
    reg = MetricsRegistry()
    reg.counter("side_registry_total", op="core").inc()
    server.add_registry(reg)
    server.add_registry(reg)
    text = _get(server.url + "/metrics")[2].decode()
    assert text.count('side_registry_total{op="core"} 1.0') == 1


def test_concurrent_scrapes_while_registries_are_added(server):
    stop = threading.Event()
    codes = [[] for _ in range(3)]

    def scrape(out):
        while True:
            out.append(_get(server.url + "/metrics")[0])
            if stop.is_set():
                return

    threads = [threading.Thread(target=scrape, args=(codes[i],), daemon=True)
               for i in range(3)]
    for th in threads:
        th.start()
    for i in range(20):
        reg = MetricsRegistry()
        reg.counter(f"late_registry_{i}_total").inc()
        server.add_registry(reg)
    stop.set()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert all(codes) and {c for out in codes for c in out} == {200}
    assert "late_registry_19_total 1.0" in _get(server.url + "/metrics")[2].decode()


def test_healthz_ok_then_503_on_anomaly(server):
    health.reset()
    try:
        code, ctype, body = _get(server.url + "/healthz")
        assert code == 200 and ctype == "application/json"
        v = json.loads(body)
        assert v["status"] == "ok" and v["anomalies"] == 0
        rec = flight.FlightRecorder()
        health.install(rec)
        rec.start_run("static", "host")
        rec.record_round(4, 10, 1, est=np.asarray([5, 9]), prev_est=np.asarray([5, 5]))
        code, _, body = _get(server.url + "/healthz")
        assert code == 503
        v = json.loads(body)
        assert v["status"] == "anomalous" and v["kinds"]["non_monotone_estimate"] >= 1
    finally:
        health.reset()


def test_debug_flight_serves_recent_records(server):
    flight.enable()
    flight.reset()
    try:
        kcore_decompose(gen.barabasi_albert(150, 3, seed=6), device="cpu")
        code, ctype, body = _get(server.url + "/debug/flight")
        assert code == 200 and ctype == "application/json"
        payload = json.loads(body)
        assert payload["enabled"] is True and payload["runs"] == 1
        assert payload["rounds_recorded"] == len(payload["records"]) > 2
        assert [r["round"] for r in payload["records"]] == list(range(len(payload["records"])))
        assert payload["events"] == [] and payload["watch"] == {}
        limited = json.loads(_get(server.url + "/debug/flight?n=2")[2])
        assert limited["records"] == payload["records"][-2:]
        assert _get(server.url + "/debug/flight?n=x")[0] == 500
    finally:
        flight.disable()
        flight.reset()
    payload = json.loads(_get(server.url + "/debug/flight")[2])
    assert payload["enabled"] is False and payload["records"] == []


def test_unknown_route_is_404(server):
    assert _get(server.url + "/nope")[0] == 404


def test_stop_closes_the_socket():
    srv = ObsHTTPServer(port=0).start()
    url = srv.url
    assert _get(url + "/")[0] == 200
    srv.stop()
    assert srv._thread is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/", timeout=1)


# ---------------------------------------------------------------------- #
# /query/* against the reference endpoint
# ---------------------------------------------------------------------- #

QUERIES = ["core?v=0,1,2", "core?v=", "in_kcore?v=3,4&k=2", "members?k=3", "max_k", "stats",
           "core_asof?t=5", "core?v=99999", "core?v=a", "in_kcore?v=1", "nope", "update",
           "members?k=1.5", "core_asof?t=x"]


def _body(code_ctype_body):
    code, _, body = code_ctype_body
    try:
        out = json.loads(body)
    except ValueError:
        return code, body
    for k in ("wall_s", "snapshot_age_s", "query_wall_s", "update_wall_s", "latency"):
        out.pop(k, None)
    return code, out


def _mount(start, front, registry):
    httpd = start(port=0)
    httpd.add_registry(registry)
    httpd.attach_query_backend(front)
    return httpd


@pytest.mark.parametrize("mode", ["static", "windowed"])
def test_query_routes_equal_the_reference_endpoint(mode):
    if mode == "static":
        port_srv = KCoreServer(gen.barabasi_albert(200, 3, seed=9), device="cpu")
        ref_srv = jax_streaming.KCoreServer(jax_gen.barabasi_albert(200, 3, seed=9))
    else:
        from repro.temporal import WindowedKCoreEngine as JaxWindow
        from repro.temporal import temporal_barabasi_albert as jax_tba

        port_srv = KCoreServer(windowed=WindowedKCoreEngine(
            temporal_barabasi_albert(200, 3, seed=1), 300, 100, device="cpu"))
        ref_srv = jax_streaming.KCoreServer(windowed=JaxWindow(jax_tba(200, 3, seed=1), 300, 100))
    port = ConcurrentKCoreServer(port_srv, read_workers=2)
    ref = jax_streaming.ConcurrentKCoreServer(ref_srv, read_workers=2)
    if mode == "windowed":
        for _ in range(2):
            port.advance_window()
            ref.advance_window()
    hp, hr = _mount(start_server, port, port_srv.metrics), \
        _mount(jax_start_server, ref, ref_srv.metrics)
    try:
        for q in QUERIES:
            got, want = _body(_get(f"{hp.url}/query/{q}")), _body(_get(f"{hr.url}/query/{q}"))
            assert got == want, q
        assert _get(f"{hp.url}/query/core?v=99999")[0] == 400
        assert _get(f"{hp.url}/query/stats")[0] == 200
        assert b"kcore_snapshot_flips_total" in _get(hp.url + "/metrics")[2]
        port.drain(save=False)
        ref.drain(save=False)
        got, want = _body(_get(f"{hp.url}/query/max_k")), _body(_get(f"{hr.url}/query/max_k"))
        assert got == want and got[0] == 503 and "draining" in got[1]["error"]
    finally:
        hp.stop()
        hr.stop()


def test_query_routes_404_without_backend_and_500_on_a_failing_backend(server):
    code, _, body = _get(server.url + "/query/max_k")
    assert code == 404 and b"no query backend" in body

    class Broken:
        def handle_query(self, op, vertices=None, k=None, t=None):
            raise RuntimeError("backend fault")

        def stats(self):
            return {"ok": True}

    server.attach_query_backend(Broken())
    code, _, body = _get(server.url + "/query/max_k")
    assert code == 500 and b"backend fault" in body
    assert _get(server.url + "/query/stats")[0] == 200      # the thread survived
    assert server.query_backend.__class__ is Broken


def test_metrics_scrapes_and_queries_during_flips():
    front = ConcurrentKCoreServer(KCoreServer(gen.barabasi_albert(200, 3, seed=9), device="cpu"))
    httpd = start_server(port=0)
    try:
        httpd.add_registry(front.server.metrics)
        httpd.attach_query_backend(front)
        stop = threading.Event()
        outs = [[] for _ in range(3)]

        def scraper(out):
            while True:
                code, _, body = _get(httpd.url + "/metrics")
                out.append((code, b"kcore_snapshot_flips_total" in body))
                code, _, body = _get(httpd.url + "/query/core?v=0,1,2")
                out.append((code, len(json.loads(body).get("payload", ())) == 3))
                if stop.is_set():
                    return

        threads = [threading.Thread(target=scraper, args=(outs[i],), daemon=True)
                   for i in range(3)]
        for th in threads:
            th.start()
        rng = np.random.default_rng(2)
        for _ in range(5):
            front.update(random_churn_batch(front.server.engine.graph, 10, 10, rng))
        stop.set()
        for th in threads:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in threads)
        assert all(outs) and {x for out in outs for x in out} == {(200, True)}
        assert json.loads(_get(httpd.url + "/query/stats")[2])["snapshot_flips"] == 6
    finally:
        httpd.stop()
