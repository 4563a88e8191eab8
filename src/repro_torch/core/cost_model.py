"""Cost models (copy of ``repro.core.cost_model``): the simulated-network
runtime of a decomposition, and the streaming engine's warm-start seed
choice.

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


# ---------------------------------------------------------------------- #
# Warm-start seed selection (streaming engine)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class SeedCostModel:
    """Relative wall costs, in units of one fused superstep round.

    The tight insertion upper bound (engine ``_ub_converge``) runs one +1
    pass per unit of the largest true core raise; each pass is a nested
    propagation + peel over the same arc arrays as a superstep, so it costs
    a small constant number of rounds (``pass_cost_rounds``). From the tight
    seed the fused loop then re-converges in a handful of rounds
    (``tight_seed_rounds``); from a plain degree seed it needs the
    from-scratch round regime instead (``degree_seed_rounds``). Degree
    seeding wins exactly when the estimated pass count makes the tight bound
    the slower path:

        est_passes * pass_cost_rounds + tight_seed_rounds > degree_seed_rounds

    i.e. with the defaults, when the cores are estimated to rise by more
    than (16 - 4) / 2 = 6 levels. The constants are the reference's: the
    choice changes the seed and so the bills, which must stay its own.
    """

    pass_cost_rounds: float = 2.0
    tight_seed_rounds: float = 4.0
    degree_seed_rounds: float = 16.0


@dataclasses.dataclass(frozen=True)
class SeedChoice:
    """Outcome of ``choose_seed`` — kept for telemetry (BatchResult)."""

    strategy: str  # "tight" | "degree"
    est_passes: int  # estimated +1 passes the tight bound would run
    tight_cost: float  # modeled cost of the tight-bound path, in rounds
    degree_cost: float  # modeled cost of the degree-seed path, in rounds


def estimate_ub_passes(inserted: np.ndarray, deg: np.ndarray, old_core: np.ndarray) -> int:
    """Estimate of the +1 passes ``_ub_converge`` would run for this batch.

    The true pass count equals the largest core raise the batch causes.
    Cheap per-vertex proxy: a vertex can rise by at most its headroom
    ``new_deg - old_core`` (a core never exceeds the degree), and churn
    raises are driven by incident insertions, so we take
    ``min(inserted_degree, headroom)`` per vertex and the max over
    vertices, capped by the sequential single-edge bound (a batch of b
    insertions raises no core by more than b). A heuristic, not a bound —
    both seeds are sound, so an estimate error costs wall time only.
    """
    b = int(inserted.shape[0]) if inserted.size else 0
    if b == 0:
        return 0
    n = int(deg.shape[0])
    ins_deg = np.bincount(inserted[:, 0], minlength=n) + np.bincount(inserted[:, 1], minlength=n)
    headroom = np.maximum(deg.astype(np.int64) - old_core.astype(np.int64), 0)
    per_vertex = np.minimum(ins_deg.astype(np.int64), headroom)
    return int(min(per_vertex.max(initial=0), b))


def choose_seed(
    inserted: np.ndarray,
    deg: np.ndarray,
    old_core: np.ndarray,
    model: SeedCostModel = SeedCostModel(),
) -> SeedChoice:
    """Pick the warm-start seeding strategy for one churn batch.

    ``inserted`` is the batch's effective (b, 2) inserted-edge array,
    ``deg`` the POST-batch degrees, ``old_core`` the pre-batch exact cores
    (0 for new vertices). Returns the modeled costs alongside the choice so
    the engine can surface them as telemetry.
    """
    est_passes = estimate_ub_passes(inserted, deg, old_core)
    tight_cost = est_passes * model.pass_cost_rounds + model.tight_seed_rounds
    degree_cost = model.degree_seed_rounds
    strategy = "degree" if est_passes and degree_cost < tight_cost else "tight"
    return SeedChoice(
        strategy=strategy,
        est_passes=est_passes,
        tight_cost=tight_cost,
        degree_cost=degree_cost,
    )
