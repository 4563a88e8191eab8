"""Small mesh builders (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device. ``make_production_mesh`` gives the reference's 16x16 and 2x16x16
pod meshes as that many shards held by this process (``compat.Mesh``), for
the dry-run's k-core cell (``launch/dryrun.py``), on ``meta`` or a device.
"""

from __future__ import annotations

import torch

from repro_torch.distribution.compat import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> Mesh:
    """16x16 = 256 shards (one pod); 2x16x16 = 512 (two pods). ``device``
    ``"meta"`` lays them on no device, for counting."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is not None and torch.device(device).type == "meta":
        return Mesh(shape, axes, torch.device("meta"))
    return make_mesh(shape, axes, device=device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device: str | torch.device | None = None) -> Mesh:
    """Small ``("data", "model")`` mesh for CI-scale integration tests."""
    return make_mesh((n_data, n_model), ("data", "model"), device=device)


def flat_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def n_devices(mesh: Mesh) -> int:
    """The mesh's shard count, the product of its axes."""
    return mesh.size
