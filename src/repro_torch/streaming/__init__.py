"""Streaming k-core maintenance (the port of ``repro.streaming``): batched
edge churn and warm-started incremental re-convergence.

  * ``delta``  — apply insert/delete edge batches to the COO/CSR Graph under
    the paper's dataCleanse rules, reporting exactly what changed;
  * ``engine`` — warm-start the locality iteration from the previous
    fixpoint and re-converge only the affected frontier.

  * ``server`` — so far the as-of store (``CoreCheckpointRing``) that the
    temporal layer re-exports; the query servers themselves (``KCoreServer``,
    ``concurrent``) come with ROADMAP.md Queue A item 7.
"""

from repro_torch.streaming.delta import (ChurnDelta, DeltaResult, EdgeBatch, PatchableCSR,
                                         apply_batch, canonical_edges, random_churn_batch)
from repro_torch.streaming.engine import (BatchResult, StreamingConfig, StreamingKCoreEngine,
                                          warm_start_seed)
from repro_torch.streaming.server import AsofView, CoreCheckpointRing

__all__ = [
    "EdgeBatch",
    "ChurnDelta",
    "DeltaResult",
    "PatchableCSR",
    "apply_batch",
    "canonical_edges",
    "random_churn_batch",
    "StreamingConfig",
    "StreamingKCoreEngine",
    "BatchResult",
    "warm_start_seed",
    "CoreCheckpointRing",
    "AsofView",
]
