"""Observability of the port (stdlib + numpy copies of ``repro.obs``): the
span tracer (``trace``), the convergence flight recorder with its watchlist
and serving events (``flight``), the metrics registry (``metrics``), the
online invariant monitor over the flight stream (``health``), the threaded
HTTP endpoint serving ``/metrics``, ``/healthz``, ``/debug/flight`` and the
query server's ``/query/*`` routes (``http``, ``kcore_serve --listen``), and
``profile``, the device time of one call under ``torch.profiler``."""

from repro_torch.obs import flight, health, http, metrics, trace
from repro_torch.obs.flight import FlightRecord, FlightRecorder, get_recorder
from repro_torch.obs.health import InvariantMonitor, get_monitor
from repro_torch.obs.http import ObsHTTPServer, start_server
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from repro_torch.obs.trace import Span, Tracer, get_tracer

__all__ = [
    "trace",
    "metrics",
    "flight",
    "health",
    "http",
    "Tracer",
    "Span",
    "get_tracer",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "get_registry",
    "FlightRecorder",
    "FlightRecord",
    "get_recorder",
    "InvariantMonitor",
    "get_monitor",
    "ObsHTTPServer",
    "start_server",
]
