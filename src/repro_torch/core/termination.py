"""Termination detection — the paper's §II.C/§III.C, adapted to BSP.

The port's copy of ``repro.core.termination`` (no JAX in it). The Go
simulation uses a centralized heartbeat server (10 s heartbeats, 30 s check
window, 5 min silence → terminate). In a bulk-synchronous execution the same *information* — "is any node still active?" — is a single
1-bit all-reduce per round, with zero false-termination risk and no timers.

This module keeps both models so the paper's overhead trade-off remains
reproducible, and adds a Dijkstra–Scholten-style tree estimate for
comparison (the paper lists it as an alternative)."""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.messages import MessageStats


@dataclasses.dataclass(frozen=True)
class HeartbeatModel:
    """Paper's centralized server (§III.C)."""
    heartbeat_interval_s: float = 10.0
    check_interval_s: float = 30.0
    silence_timeout_s: float = 300.0

    def overhead(self, stats: MessageStats, round_time_s: float) -> dict:
        """Heartbeat traffic + termination delay for a run whose rounds each
        take ``round_time_s`` (the paper's simulation-clock analogue)."""
        total_time = stats.rounds * round_time_s
        # event heartbeats: one per activation
        event_hb = int(stats.active_per_round.sum())
        # periodic heartbeats: active nodes re-send every interval
        periods = max(int(total_time / self.heartbeat_interval_s), 0)
        per_round_active = float(stats.active_per_round.mean()) if \
            stats.rounds else 0.0
        periodic_hb = int(periods * per_round_active)
        return {
            "event_heartbeats": event_hb,
            "periodic_heartbeats": periodic_hb,
            "total_heartbeats": event_hb + periodic_hb,
            "termination_delay_s": self.silence_timeout_s,
        }


def bsp_termination_cost(stats: MessageStats, n_devices: int) -> dict:
    """Our replacement: one scalar all-reduce per round."""
    hops = max(int(math.ceil(math.log2(max(n_devices, 2)))), 1)
    return {
        "allreduces": stats.rounds,
        "latency_hops_total": stats.rounds * hops,
        "termination_delay_rounds": 1,
    }


def dijkstra_scholten_estimate(stats: MessageStats) -> dict:
    """Tree-based detection: every basic message eventually triggers one
    signal message back up the tree → overhead ≈ total basic messages."""
    return {"signal_messages": stats.total_messages}
