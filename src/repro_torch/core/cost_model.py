"""Simulated-network runtime model (copy of ``repro.core.cost_model``,
trimmed to ``simulate_runtime`` and its network regimes).

The paper stresses (§IV.F) that wall-clock of a Go-channel simulation is no
proxy for a real deployment — message complexity is. So run time is modeled
from the measured per-round message counts under explicit network regimes.
These are models of a network, not measurements of any device; the static
CLI reports them under ``simulated_runtime_s`` with the reference's keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.messages import MessageStats


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    name: str
    latency_s: float  # per-round critical-path latency
    bandwidth_Bps: float  # aggregate bisection bandwidth
    bytes_per_message: int = 16  # {sender id, core value} + framing


INTERNET = NetworkModel("internet-p2p", latency_s=50e-3, bandwidth_Bps=1e9)
DATACENTER = NetworkModel("datacenter", latency_s=10e-6, bandwidth_Bps=100e9)
# the reference's third regime (256 chips x ~50 GB/s links), kept so the
# CLI's report can be diffed against the reference's key by key
TPU_POD = NetworkModel("tpu-pod-ici", latency_s=1e-6, bandwidth_Bps=256 * 50e9)


def simulate_runtime(stats: MessageStats, model: NetworkModel) -> dict:
    per_round_bytes = stats.messages_per_round.astype(np.float64) * model.bytes_per_message
    per_round_s = model.latency_s + per_round_bytes / model.bandwidth_Bps
    return {
        "model": model.name,
        "rounds": stats.rounds,
        "total_s": float(per_round_s.sum()),
        "latency_bound_fraction": float(
            stats.rounds * model.latency_s / max(per_round_s.sum(), 1e-30)
        ),
        "per_round_s": per_round_s,
    }
