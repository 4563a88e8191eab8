"""Observability of the port (stdlib + numpy copies of ``repro.obs``): the
span tracer (``trace``), the convergence flight recorder (``flight``), the
metrics registry (``metrics``), the online invariant monitor over the
flight stream (``health``), and ``profile``, the device time of one call
under ``torch.profiler``. The reference's HTTP endpoint (``obs/http.py``)
is ROADMAP.md Queue A item 7."""

from repro_torch.obs import flight, health, metrics, trace
from repro_torch.obs.flight import FlightRecord, FlightRecorder, get_recorder
from repro_torch.obs.health import InvariantMonitor, get_monitor
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from repro_torch.obs.trace import Span, Tracer, get_tracer

__all__ = [
    "trace",
    "metrics",
    "flight",
    "health",
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
]
