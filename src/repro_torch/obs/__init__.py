"""Observability of the port: the span tracer and the convergence flight
recorder (stdlib + numpy copies of ``repro.obs.trace`` and
``repro.obs.flight``)."""

from repro_torch.obs import flight, trace

__all__ = ["flight", "trace"]
