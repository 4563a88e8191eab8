"""Dependency-free threaded HTTP endpoint for live observability (the port of
``repro.obs.http``, standard library only).

``ObsHTTPServer`` is a stdlib ``ThreadingHTTPServer`` on a daemon thread
serving read-only routes:

* ``/metrics`` — Prometheus text exposition (the process-default metrics
  registry plus any registries added via ``add_registry``, e.g. a
  ``KCoreServer``'s per-server registry);
* ``/healthz`` — the invariant monitor's verdict as JSON; HTTP 200 while
  healthy, 503 once an anomaly has been observed;
* ``/debug/flight`` — the flight recorder's recent rounds (and watchlist
  timelines) as JSON; ``?n=50`` limits to the last n records;
* ``/query/<op>`` — live core-number reads, once a snapshot-isolated
  query backend has been attached via ``attach_query_backend`` (the
  ``ConcurrentKCoreServer`` in streaming/concurrent.py — duck-typed so
  the obs layer never imports streaming). Ops mirror the serving layer:
  ``/query/core?v=1,2,3``, ``/query/in_kcore?v=..&k=..``,
  ``/query/members?k=..``, ``/query/max_k``,
  ``/query/core_asof?t=..[&v=..]``, plus ``/query/stats``. Malformed
  requests come back HTTP 400 with a structured ``{"error": ...}`` body
  (the backend's contract: bad requests never touch serving state);
  a draining backend answers 503.

Mounted by ``kcore_serve --listen PORT``; ``port=0`` binds an ephemeral
port (tests). The CLI starts it before it builds the graph and the initial
decomposition, so external pollers can reach ``/healthz`` during startup.
The serving threads are daemons, and ``stop()`` closes the socket.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.obs import flight, health, metrics

_INDEX = b"repro_torch obs: /metrics /healthz /debug/flight /query/<op>\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-torch-obs/1"

    # the owning ObsHTTPServer is attached to the socket server
    @property
    def obs(self) -> "ObsHTTPServer":
        return self.server.obs  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # noqa: ARG002 - silence stderr
        pass

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                body = self.obs.render_metrics().encode()
                self._reply(200, body,
                            "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/healthz":
                v = health.verdict()
                self._reply(200 if v["status"] == "ok" else 503,
                            json.dumps(v).encode(), "application/json")
            elif url.path == "/debug/flight":
                qs = parse_qs(url.query)
                last = None
                if "n" in qs:
                    last = max(int(qs["n"][0]), 0)
                payload = flight.get_recorder().to_json(last)
                payload["enabled"] = flight.enabled()
                self._reply(200, json.dumps(payload).encode(),
                            "application/json")
            elif url.path.startswith("/query/"):
                self._query(url)
            elif url.path == "/":
                self._reply(200, _INDEX, "text/plain; charset=utf-8")
            else:
                self._reply(404, b"not found\n", "text/plain; charset=utf-8")
        except Exception as exc:  # never kill the serving thread
            self._reply(500, f"error: {exc}\n".encode(),
                        "text/plain; charset=utf-8")

    def _query(self, url) -> None:
        backend = self.obs.query_backend
        if backend is None:
            self._reply(404, b"no query backend attached\n",
                        "text/plain; charset=utf-8")
            return
        op = url.path[len("/query/"):]
        if op == "stats":
            self._reply(200, json.dumps(backend.stats()).encode(),
                        "application/json")
            return
        qs = parse_qs(url.query)
        try:
            vertices = ([int(x) for x in qs["v"][0].split(",") if x]
                        if "v" in qs else None)
            k = int(qs["k"][0]) if "k" in qs else None
            t = float(qs["t"][0]) if "t" in qs else None
        except ValueError as exc:
            self._reply(400, json.dumps({"op": op, "ok": False,
                                         "error": f"bad query arg: {exc}"}
                                        ).encode(), "application/json")
            return
        out = backend.handle_query(op, vertices=vertices, k=k, t=t)
        if out.get("ok"):
            code = 200
        elif "draining" in out.get("error", ""):
            code = 503
        else:
            code = 400
        self._reply(code, json.dumps(out).encode(), "application/json")

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class ObsHTTPServer:
    """Threaded HTTP server exposing metrics / health / flight state."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registries=()):
        self._host = host
        # guards the registry list and backend reference: scrapes run on
        # per-connection threads while the main thread mounts late (the
        # serve CLI starts the endpoint before it builds the server)
        self._lock = threading.Lock()
        self._registries: list[metrics.MetricsRegistry] = list(registries)
        self._query_backend = None
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.obs = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self._host

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def add_registry(self, registry: metrics.MetricsRegistry) -> None:
        """Also expose a non-default registry (e.g. KCoreServer.metrics)."""
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    def attach_query_backend(self, backend) -> None:
        """Mount a live-read backend for the ``/query/*`` routes.

        Duck-typed: anything with ``handle_query(op, vertices, k, t) ->
        dict`` and ``stats() -> dict`` — in practice the
        ``ConcurrentKCoreServer`` from streaming/concurrent.py."""
        with self._lock:
            self._query_backend = backend

    @property
    def query_backend(self):
        with self._lock:
            return self._query_backend

    def render_metrics(self) -> str:
        with self._lock:
            registries = list(self._registries)
        parts = [metrics.to_prometheus()]
        parts.extend(r.to_prometheus() for r in registries)
        return "".join(p if p.endswith("\n") or not p else p + "\n"
                       for p in parts)

    def start(self) -> "ObsHTTPServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="repro-torch-obs-http",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()


def start_server(port: int = 0, host: str = "127.0.0.1",
                 registries=()) -> ObsHTTPServer:
    """Create and start an ObsHTTPServer (convenience for CLIs)."""
    return ObsHTTPServer(port=port, host=host, registries=registries).start()
