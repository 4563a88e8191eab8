"""Vertex-range partitioning of a src-sorted graph (numpy, host-side).

The port's copy of ``repro.graph.partition``, which has no JAX in it. Layout
contract (the sharded engines use the arrays: ``core/kcore.py``'s
``kcore_decompose_sharded`` through ``shard_graph``, the streaming engine's
``sharded`` modes through ``shard_arc_arrays``; the block-Gauss-Seidel sweep
uses the geometry):

  * Vertices are partitioned into ``n_shards`` contiguous ranges of equal
    (padded) size V = n_pad / n_shards; shard d owns vertices
    [d*V, (d+1)*V).
  * Arcs are sorted by src, so each shard's *outgoing* arcs form one
    contiguous run. Runs are padded to the max run length A with sentinel
    arcs (local src V - 1, mask False) so every shard holds an
    identical-shape (A,) arc block.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.padding import next_pow2 as _next_pow2
from repro_torch.graph.padding import round_up as _round_up
from repro_torch.graph.structs import Graph


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    n_shards: int
    n_real: int
    verts_per_shard: int       # V
    arcs_per_shard: int        # A
    src: np.ndarray            # (n_shards, A) int32 — LOCAL vertex index [0, V)
    dst: np.ndarray            # (n_shards, A) int32 — GLOBAL vertex index
    arc_mask: np.ndarray       # (n_shards, A) bool
    deg: np.ndarray            # (n_shards, V) int32
    vert_mask: np.ndarray      # (n_shards, V) bool — True = real vertex

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.verts_per_shard


def shard_layout(n: int, src: np.ndarray, n_shards: int,
                 arc_multiple: int = 8, pow2: bool = False,
                 min_arcs_per_shard: int = 0) -> tuple[int, int, np.ndarray]:
    """The shared block geometry of the layout contract above.

    Returns ``(V, A, bounds)``: per-shard (padded) vertex count V, per-shard
    (padded) arc-block length A, and the ``(n_shards + 1,)`` arc-run bounds
    into the src-sorted arc arrays (shard d owns arcs
    ``[bounds[d], bounds[d+1])``).
    """
    V = max(_round_up(n, n_shards) // n_shards, 1)
    if pow2:
        V = _next_pow2(V)
    n_pad = V * n_shards
    bounds = np.searchsorted(src, np.arange(0, n_pad + 1, V))
    run_len = np.diff(bounds)
    A = max(_round_up(int(run_len.max()) if len(run_len) else 1, arc_multiple),
            arc_multiple)
    if pow2:
        A = _next_pow2(A)
    A = max(A, int(min_arcs_per_shard))
    return V, A, bounds


def shard_arc_arrays(n: int, src: np.ndarray, dst: np.ndarray,
                     arc_mask: np.ndarray, deg: np.ndarray, n_shards: int,
                     arc_multiple: int = 8, pow2: bool = False,
                     min_arcs_per_shard: int = 0) -> ShardedGraph:
    """Shard raw src-sorted arc arrays (the layout contract above).

    ``src`` must be non-decreasing but MAY contain dead slots (``arc_mask``
    False), as the streaming engine's slack-padded CSR does. ``pow2`` pads
    the per-shard vertex and arc blocks to powers of two;
    ``min_arcs_per_shard`` floors the padded arc block A.
    """
    V, A, bounds = shard_layout(n, src, n_shards, arc_multiple=arc_multiple,
                                pow2=pow2,
                                min_arcs_per_shard=min_arcs_per_shard)
    n_pad = V * n_shards
    src_s = np.zeros((n_shards, A), np.int32)
    dst_s = np.zeros((n_shards, A), np.int32)
    mask_s = np.zeros((n_shards, A), bool)
    deg_s = np.zeros((n_shards, V), np.int32)
    vmask = np.zeros((n_shards, V), bool)
    for d in range(n_shards):
        lo, hi = bounds[d], bounds[d + 1]
        k = hi - lo
        # local src index within the shard's vertex range
        src_s[d, :k] = src[lo:hi] - d * V
        dst_s[d, :k] = dst[lo:hi]
        mask_s[d, :k] = arc_mask[lo:hi]
        # padding arcs: local sentinel V - 1 (so the block's local src stays
        # sorted), an in-range dst, mask False
        src_s[d, k:] = V - 1
        dst_s[d, k:] = min(d * V + V - 1, n_pad - 1)
        vr_lo, vr_hi = d * V, min((d + 1) * V, n)
        if vr_hi > vr_lo:
            deg_s[d, : vr_hi - vr_lo] = deg[vr_lo:vr_hi]
            vmask[d, : vr_hi - vr_lo] = True
    return ShardedGraph(
        n_shards=n_shards, n_real=n, verts_per_shard=V, arcs_per_shard=A,
        src=src_s, dst=dst_s, arc_mask=mask_s, deg=deg_s, vert_mask=vmask,
    )


def shard_graph(g: Graph, n_shards: int, arc_multiple: int = 8) -> ShardedGraph:
    return shard_arc_arrays(g.n, g.src, g.dst,
                            np.ones(g.num_arcs, bool), g.deg, n_shards,
                            arc_multiple=arc_multiple)


def balance_from_counts(real: np.ndarray, padded_A: int) -> dict:
    """Arc-count balance metrics from per-shard live-arc counts.

    ``imbalance`` = max/mean — the straggler factor: a round's wall is the
    slowest shard's.
    """
    real = np.asarray(real, np.int64)
    if real.size == 0:
        real = np.zeros(1, np.int64)
    return {
        "arcs_per_shard_max": int(real.max()),
        "arcs_per_shard_min": int(real.min()),
        "arcs_per_shard_mean": float(real.mean()),
        "imbalance": float(real.max() / max(real.mean(), 1e-9)),
        "padded_A": int(padded_A),
    }


def balance_report(sg: ShardedGraph) -> dict:
    """Arc-count balance across shards (straggler diagnosis)."""
    return balance_from_counts(sg.arc_mask.sum(axis=1), sg.arcs_per_shard)
