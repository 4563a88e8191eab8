"""Device time of one call under ``torch.profiler``.

``profile_call(fn, device)`` runs ``fn()`` once under the profiler on the
card and returns its result with the host wall (ms, ended by a
synchronize), the device busy time (ms, the sum of kernel times: one stream,
so kernels do not overlap), the idle share ``1 - busy / wall``, the kernel
launches, and the ``top`` kernels by device time as ``(name, launches,
ms)``. ``format_profile`` prints a dict of such records.
"""

from __future__ import annotations

import time

import torch


def profile_call(fn, device: torch.device, top: int = 8):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise RuntimeError("profile_call measures the card; it was given the CPU")
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return result, {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall,
                    "launches": sum(e.count for e in kernels),
                    "top": [(e.key, e.count, e.self_device_time_total / 1e3) for e in ranked]}


def format_profile(prof: dict) -> str:
    lines = []
    for phase, p in prof.items():
        lines.append(f"{phase}: wall {p['wall_ms']:.3f} ms, device busy {p['device_ms']:.3f} ms, "
                     f"idle {p['idle_share']:.1%}, {p['launches']} kernel launches")
        lines += [f"  {ms:10.3f} ms {n:6d}x  {name[:100]}" for name, n, ms in p["top"]]
    return "\n".join(lines)
