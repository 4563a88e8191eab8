"""PyTorch / CUDA port of the distributed k-core decomposition (``repro``).

A package beside the JAX reference that imports neither ``jax`` nor
``repro``. Importing it builds nothing and touches no device: each CUDA
kernel is compiled from ``kernels/*/csrc`` the first time a CUDA tensor
reaches its wrapper (``kernels/_build.py``).

    from repro_torch import kcore_decompose
    from repro_torch.graph import generators

    res = kcore_decompose(generators.snap_analogue("FC", 0.05), fused=True)

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import importlib

_EXPORTS = {
    "KCoreConfig": "repro_torch.core.kcore",
    "KCoreResult": "repro_torch.core.kcore",
    "kcore_decompose": "repro_torch.core.kcore",
    "resolve_device": "repro_torch.platform",
    "device_summary": "repro_torch.platform",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
