"""Small mesh builders (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device. The reference's ``make_production_mesh`` (16x16 and 2x16x16 TPU
pods) has only the dry-run tool as a caller and is not ported with it.
"""

from __future__ import annotations

import torch

from repro_torch.distribution.compat import Mesh, make_mesh


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device: str | torch.device | None = None) -> Mesh:
    """Small ``("data", "model")`` mesh for CI-scale integration tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device=device)


def flat_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def n_devices(mesh: Mesh) -> int:
    """The mesh's shard count, the product of its axes."""
    return mesh.size
