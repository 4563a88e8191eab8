"""Process-wide kernel-build telemetry (the port of ``repro.core.jit_telemetry``).

The reference counts XLA compilations through jax's monitoring stream. The
port compiles nothing at run time but its hand-written kernels: each is
built once by nvcc (``kernels/_build.py``) into a library that every later
launch reuses. So ``compile_count()`` is the number of nvcc builds this
process ran and ``compile_seconds()`` their wall, read from ``_build``'s
counters; the delta of either across a run is what the run paid to build
(0 once every library exists). ``KCoreResult.recompiles``/``compile_s``
and ``BatchResult.recompiles``/``compile_s`` are these deltas.

While span tracing is on (``repro_torch.obs.trace``), ``record_build``,
which ``_build.build_all`` calls after the nvcc runs it started, records
them as one ``kernel.build`` span ending at the current clock, so it lands
inside whatever engine span was open while the build ran: the counterpart
of the reference's ``xla.compile`` span. Telemetry never takes a build
down: a failure to record is swallowed.
"""

from __future__ import annotations

from repro_torch.kernels import _build


def record_build(kernels, seconds: float) -> None:
    """Record one ``kernel.build`` span of ``seconds`` for the libraries
    ``kernels`` built together, where tracing is on; never raises."""
    try:
        from repro_torch.obs import trace

        if trace.enabled():
            trace.record("kernel.build", seconds, kernels=",".join(kernels))
    except Exception:
        pass  # tracing must never take down a build


def compile_count() -> int:
    """Monotone count of nvcc builds in this process; diff two snapshots to
    count the builds a region of code caused."""
    return _build.build_count()


def compile_seconds() -> float:
    """Monotone wall seconds of those builds; diff two snapshots to
    attribute build time to a region of code."""
    return _build.build_seconds()
