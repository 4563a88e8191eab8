"""Streaming k-core maintenance (the port of ``repro.streaming``): batched
edge churn and warm-started incremental re-convergence.

  * ``delta``  — apply insert/delete edge batches to the COO/CSR Graph under
    the paper's dataCleanse rules, reporting exactly what changed;
  * ``engine`` — warm-start the locality iteration from the previous
    fixpoint and re-converge only the affected frontier.

  * ``server`` — ``KCoreServer``, the query server over the engine (or a
    sliding window): batched core-number queries, updates, as-of queries
    from ``CoreCheckpointRing``, per-server metrics and warm restarts;
  * ``concurrent`` — ``ConcurrentKCoreServer``, its snapshot-isolated front
    end: reads on a worker pool answered from the last published fixpoint
    while the single writer re-converges, and ``drain`` to a checkpoint.
"""

from repro_torch.streaming.delta import (ChurnDelta, DeltaResult, EdgeBatch, PatchableCSR,
                                         apply_batch, canonical_edges, random_churn_batch)
from repro_torch.streaming.engine import (BatchResult, StreamingConfig, StreamingKCoreEngine,
                                          warm_start_seed)
from repro_torch.streaming.concurrent import ConcurrentKCoreServer, CoreSnapshot, SnapshotBox
from repro_torch.streaming.server import (AsofView, CoreCheckpointRing, KCoreServer, Request,
                                          Response)

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
    "KCoreServer",
    "Request",
    "Response",
    "ConcurrentKCoreServer",
    "CoreSnapshot",
    "SnapshotBox",
]
