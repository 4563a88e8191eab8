"""Streaming k-core maintenance (the port of ``repro.streaming``): batched
edge churn and warm-started incremental re-convergence.

  * ``delta``  — apply insert/delete edge batches to the COO/CSR Graph under
    the paper's dataCleanse rules, reporting exactly what changed;
  * ``engine`` — warm-start the locality iteration from the previous
    fixpoint and re-converge only the affected frontier.

The query servers (``server``, ``concurrent``) come with ROADMAP.md Queue A
item 7.
"""

from repro_torch.streaming.delta import (ChurnDelta, DeltaResult, EdgeBatch, PatchableCSR,
                                         apply_batch, canonical_edges, random_churn_batch)
from repro_torch.streaming.engine import (BatchResult, StreamingConfig, StreamingKCoreEngine,
                                          warm_start_seed)

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
]
