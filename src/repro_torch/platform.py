"""Device selection and the card's identity.

Every entry point of the port runs on the card unless its caller asks for
the CPU: ``resolve_device(None)`` is CUDA, and it raises when no CUDA device
is present instead of carrying on silently on the CPU. The CPU is taken
only when it is asked for by name, as the tests do. Which kernels run
follows from the device (``core.dispatch.resolve_plan``): the hand-written
CUDA kernels on ``cuda``, their plain PyTorch versions on ``cpu``.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` when asked or by default; ``cpu`` only when asked.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is
    present, and ``ValueError`` for any other device type.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def nvidia_smi_line() -> str | None:
    """``name, power.limit`` of each card as ``nvidia-smi`` reports them, or
    None where ``nvidia-smi`` is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_summary(device: str | torch.device | None = None) -> dict:
    """Name, count and power limit of the card a run used.

    ``power_limit`` is the text ``nvidia-smi`` gives for the first card, or
    None where it cannot be read. On the CPU, ``name`` is ``"cpu"``.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"platform": "cpu", "name": "cpu", "count": 0, "power_limit": None}
    smi = nvidia_smi_line()
    power = smi.splitlines()[0].split(",")[-1].strip() if smi else None
    return {
        "platform": "gpu",
        "name": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count(),
        "power_limit": power,
    }
