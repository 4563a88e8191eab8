"""Observability of the port: the span tracer and the convergence flight
recorder (stdlib + numpy copies of ``repro.obs.trace`` and
``repro.obs.flight``), and ``profile``, the device time of one call under
``torch.profiler``."""

from repro_torch.obs import flight, trace

__all__ = ["flight", "trace"]
