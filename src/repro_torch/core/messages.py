"""Exact message / active-node accounting — the paper's §II.B metrics.

The paper counts a message every time a vertex sends its (new) estimate to a
neighbor. Rules (§III):
  * round 0: every vertex broadcasts its degree to all neighbors
    → Σ deg(u) = 2m messages; all n vertices Active;
  * round r ≥ 1: a vertex whose estimate *decreased* broadcasts to all
    neighbors → deg(u) messages; a vertex is Active in round r iff it
    received ≥1 message in round r-1 (it must recompute).

Work bound (§II.B):  W = O( Σ_u deg(u) · (deg(u) − core(u)) )  — each unit
decrease of u's estimate costs deg(u) messages, and the estimate travels from
deg(u) down to core(u).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import Graph


@dataclasses.dataclass
class MessageStats:
    """Per-round accounting collected by the engine."""
    messages_per_round: np.ndarray   # (R,) int64; [0] = 2m initial broadcast
    active_per_round: np.ndarray     # (R,) int64; receivers that recompute
    changed_per_round: np.ndarray    # (R,) int64; senders (estimate decreased)

    @property
    def total_messages(self) -> int:
        return int(self.messages_per_round.sum())

    @property
    def rounds(self) -> int:
        return int(len(self.messages_per_round))


def work_bound(g: Graph, core: np.ndarray) -> int:
    """Paper's W = Σ deg·(deg − core) + 2m (including the initial broadcast)."""
    d = g.deg.astype(np.int64)
    return int((d * (d - core.astype(np.int64))).sum() + d.sum())


def heartbeat_overhead(stats: MessageStats, *, heartbeat_every_rounds: int = 1
                       ) -> dict:
    """Model of the paper's centralized termination detection (§III.C).

    In the Go simulation every *activation* triggers an immediate heartbeat,
    plus periodic 10 s heartbeats while active. At round granularity we charge
    one heartbeat per active vertex per ``heartbeat_every_rounds`` rounds —
    the paper's event-driven lower bound — and compare with the BSP
    termination cost (one scalar all-reduce per round).
    """
    hb = int(stats.active_per_round[::heartbeat_every_rounds].sum())
    return {
        "heartbeat_messages": hb,
        "bsp_allreduce_rounds": stats.rounds,
        "heartbeat_fraction_of_traffic": hb / max(stats.total_messages, 1),
    }
