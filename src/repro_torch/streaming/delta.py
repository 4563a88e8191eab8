"""Mutable graph delta layer: batched edge insert/delete on the COO/CSR Graph.

The port's copy of ``repro.streaming.delta`` (numpy only). Every array it
builds — the rebuilt Graph, the effective delta, the patched slot arrays
and the churn batches ``random_churn_batch`` draws — equals the
reference's for the same input and the same rng.

Two ways to apply a churn batch, with identical dataCleanse semantics:

  * ``apply_batch`` — rebuild: produces a *new* immutable Graph by one
    O(m log m) lexsort over the surviving edge set. Simple, and the
    reference the patch path is property-tested against.
  * ``PatchableCSR`` — in-place: slack-padded CSR storage where each row
    carries spare slots, so a batch patches arc slots in O(batch * deg)
    instead of touching all m edges. Rows that overflow their slack, vertex
    growth, or a dead-slot fraction past ``compact_dead_frac`` trigger an
    O(m) compaction (amortized away over a stream). The padded slot arrays
    double as the engine's masked-superstep inputs — dead slots are just
    masked arcs, so no densification happens between batches.

The dataCleanse rules applied to the batch itself (same as Graph.from_edges):

  * self-loops in the batch are dropped;
  * edges are undirected — (u, v) and (v, u) are the same edge, canonical
    form is (min, max);
  * inserting an edge that already exists is a no-op, as is deleting one
    that doesn't; duplicates within the batch collapse.

Deletes are applied before inserts, so a batch that deletes and inserts the
same edge nets out to "edge present".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import Graph


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """One churn batch: arrays of (u, v) pairs to delete and insert."""

    insert: np.ndarray        # (Bi, 2) int64 — may be empty
    delete: np.ndarray        # (Bd, 2) int64 — may be empty

    @classmethod
    def make(cls, insert=None, delete=None) -> "EdgeBatch":
        def arr(x):
            if x is None:
                return np.zeros((0, 2), np.int64)
            return np.asarray(x, np.int64).reshape(-1, 2)
        return cls(insert=arr(insert), delete=arr(delete))

    @property
    def size(self) -> int:
        return int(self.insert.shape[0] + self.delete.shape[0])


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """Outcome of applying an EdgeBatch."""

    graph: Graph              # the post-batch graph
    inserted: np.ndarray      # (bi, 2) canonical edges actually added
    deleted: np.ndarray       # (bd, 2) canonical edges actually removed
    touched: np.ndarray       # sorted unique vertex ids incident to a change


def canonical_edges(g: Graph) -> np.ndarray:
    """The (m, 2) canonical (min < max) edge list of a Graph."""
    half = g.src < g.dst
    return np.stack([g.src[half].astype(np.int64),
                     g.dst[half].astype(np.int64)], axis=1)


def _canonicalize(pairs: np.ndarray) -> np.ndarray:
    """dataCleanse a raw (B, 2) pair list: drop self-loops, canonical order,
    dedupe."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    if pairs.size == 0:
        return pairs.reshape(0, 2)
    canon = np.stack([pairs.min(axis=1), pairs.max(axis=1)], axis=1)
    return np.unique(canon, axis=0)


def edge_keys(edges: np.ndarray, n: int) -> np.ndarray:
    """Encode canonical edges as scalar keys u * n + v for set algebra.

    The one canonical key scheme for edge-set membership/diff across the
    streaming and temporal layers (temporal/window.py uses it for window
    deltas; temporal/events.py applies the same encoding columnwise)."""
    return edges[:, 0] * np.int64(n) + edges[:, 1]


_keys = edge_keys          # internal alias, predates the public name


def apply_batch(g: Graph, batch: EdgeBatch) -> DeltaResult:
    """Apply a churn batch; returns the new Graph and the effective delta.

    Vertex ids beyond g.n in the batch grow the vertex set (the new graph
    has n = max(g.n, 1 + max id referenced)); deletes referencing unknown
    vertices are no-ops.
    """
    ins = _canonicalize(batch.insert)
    dele = _canonicalize(batch.delete)
    if (ins.size and ins.min() < 0) or (dele.size and dele.min() < 0):
        raise ValueError("negative vertex id in churn batch")
    n = max(g.n, int(ins.max()) + 1 if ins.size else 0)
    # key base must cover delete ids too (deleting an unknown vertex is a
    # no-op, but its key must not alias a real edge's key)
    base = max(n, int(dele.max()) + 1 if dele.size else 0)

    edges = canonical_edges(g)
    keys = _keys(edges, base)

    # deletes first
    if dele.size:
        dk = _keys(dele, base)
        hit = np.isin(keys, dk)
        deleted = edges[hit]
        edges, keys = edges[~hit], keys[~hit]
    else:
        deleted = np.zeros((0, 2), np.int64)

    # then inserts (drop ones already present)
    if ins.size:
        fresh = ~np.isin(_keys(ins, base), keys)
        inserted = ins[fresh]
        edges = np.concatenate([edges, inserted])
    else:
        inserted = np.zeros((0, 2), np.int64)

    new_g = Graph.from_edges(edges, n=n)
    touched = np.unique(np.concatenate([inserted.reshape(-1),
                                        deleted.reshape(-1)]))
    return DeltaResult(graph=new_g, inserted=inserted, deleted=deleted,
                       touched=touched.astype(np.int64))


# ---------------------------------------------------------------------- #
# In-place CSR patching
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ChurnDelta:
    """What a patched batch actually changed (no materialized Graph)."""

    inserted: np.ndarray      # (bi, 2) canonical edges actually added
    deleted: np.ndarray       # (bd, 2) canonical edges actually removed
    touched: np.ndarray       # sorted unique vertex ids incident to a change
    compacted: bool           # did this batch trigger an O(m) compaction?


class PatchableCSR:
    """Slack-padded CSR adjacency supporting in-place edge churn.

    Storage: every vertex u owns a contiguous slot range
    ``[row_off[u], row_off[u+1])`` in flat ``src``/``dst`` arrays;
    ``live`` marks which slots currently hold an arc. ``src`` is constant
    per row (the owner), so the slot arrays are src-sorted by construction
    — exactly the sorted-COO-with-mask layout the masked superstep and the
    sharded partitioner consume, without any per-batch sort.

    Capacity per row is ``deg + max(ceil(slack * deg), min_slack)`` at
    (re)build time. An insert lands in a free slot of each endpoint's row;
    a delete just clears ``live``. Compaction (rebuild with fresh slack)
    triggers on row overflow, vertex growth, or when the dead-slot fraction
    of the total capacity exceeds ``compact_dead_frac``.
    """

    def __init__(self, g: Graph, slack: float = 0.3, min_slack: int = 4,
                 compact_dead_frac: float = 0.25):
        self.slack = float(slack)
        # >= 1 so a compaction always frees at least one slot per row (the
        # overflow-retry in apply_batch relies on it)
        self.min_slack = max(int(min_slack), 1)
        self.compact_dead_frac = float(compact_dead_frac)
        self.compactions = 0
        self._alloc(g.n, g.src, g.dst, g.deg)

    # ------------------------------------------------------------------ #
    def _alloc(self, n: int, src: np.ndarray, dst: np.ndarray,
               deg: np.ndarray, reserve: np.ndarray | None = None) -> None:
        """(Re)build storage from src-sorted live arcs with fresh slack.

        ``reserve`` (n,) adds per-row slots on top of the slack — the
        batch-aware compaction passes the incoming insert counts so one
        rebuild is guaranteed to fit the whole batch."""
        deg = np.asarray(deg, np.int64)
        pad = np.maximum(np.ceil(self.slack * deg).astype(np.int64),
                         self.min_slack)
        cap = deg + pad
        if reserve is not None:
            cap = cap + np.asarray(reserve, np.int64)
        self.n = int(n)
        self.row_off = np.zeros(n + 1, np.int64)
        np.cumsum(cap, out=self.row_off[1:])
        C = int(self.row_off[-1])
        self.src = np.repeat(np.arange(n, dtype=np.int32),
                             cap).astype(np.int32, copy=False)
        self.dst = self.src.copy()      # dead slots point at their owner
        self.live = np.zeros(C, bool)
        # scatter the existing arcs to the head of each row
        if src.size:
            arc_slot = (self.row_off[src]
                        + (np.arange(src.size) - np.cumsum(deg)[src]
                           + deg[src])).astype(np.int64)
            self.dst[arc_slot] = dst
            self.live[arc_slot] = True
        self.deg = deg.astype(np.int32).copy()
        self.m = int(deg.sum()) // 2
        # holes = slots that were live and got deleted (NOT virgin slack):
        # the fragmentation measure driving compact_dead_frac
        self.hole = np.zeros(C, bool)
        self.dead = 0

    @property
    def capacity(self) -> int:
        return int(self.row_off[-1])

    # ------------------------------------------------------------------ #
    def _row(self, u: int) -> slice:
        return slice(int(self.row_off[u]), int(self.row_off[u + 1]))

    def _find_slot(self, u: int, v: int) -> int:
        """Slot index of live arc u->v, or -1."""
        r = self._row(u)
        hit = np.flatnonzero(self.live[r] & (self.dst[r] == v))
        return int(r.start + hit[0]) if hit.size else -1

    def _free_slot(self, u: int) -> int:
        """A dead slot in u's row, or -1 if the row is full."""
        r = self._row(u)
        free = np.flatnonzero(~self.live[r])
        return int(r.start + free[0]) if free.size else -1

    def has_edge(self, u: int, v: int) -> bool:
        return self._find_slot(u, v) >= 0

    # ------------------------------------------------------------------ #
    def _compact(self, n: int | None = None,
                 reserve: np.ndarray | None = None) -> None:
        """Rebuild with fresh slack (and optionally a grown vertex set
        and/or per-row reserved slots for an incoming batch)."""
        n = self.n if n is None else int(n)
        keep = self.live
        src = self.src[keep].astype(np.int64)
        dst = self.dst[keep].astype(np.int64)
        # rows stay contiguous under filtering, so src stays sorted
        deg = np.bincount(src, minlength=n)
        self._alloc(n, src.astype(np.int32), dst.astype(np.int32), deg,
                    reserve=reserve)
        self.compactions += 1

    # ------------------------------------------------------------------ #
    def apply_batch(self, batch: EdgeBatch) -> ChurnDelta:
        """Patch a churn batch in place; returns the effective delta.

        Semantics are identical to the rebuild path ``apply_batch(g, b)``:
        deletes first, then inserts; no-ops dropped; vertex ids beyond n in
        the inserts grow the vertex set.
        """
        ins = _canonicalize(batch.insert)
        dele = _canonicalize(batch.delete)
        if (ins.size and ins.min() < 0) or (dele.size and dele.min() < 0):
            raise ValueError("negative vertex id in churn batch")
        compacted = False
        new_n = max(self.n, int(ins.max()) + 1 if ins.size else 0)
        if new_n > self.n:
            self._compact(new_n)
            compacted = True

        deleted = []
        for u, v in dele.tolist():
            if v >= self.n:             # unknown vertex: no-op
                continue
            s_uv = self._find_slot(u, v)
            if s_uv < 0:
                continue
            s_vu = self._find_slot(v, u)
            self.live[s_uv] = False
            self.live[s_vu] = False
            self.hole[s_uv] = True
            self.hole[s_vu] = True
            self.deg[u] -= 1
            self.deg[v] -= 1
            self.m -= 1
            self.dead += 2
            deleted.append((u, v))

        # batch-aware growth policy: if ANY row lacks free slots for its
        # incoming inserts, compact ONCE with the batch's per-row need
        # reserved, instead of compacting per overflowing insert (a windowed
        # replay at full scale was thrashing ~90 O(m) compactions per batch
        # through the hub rows). need over-counts already-present edges —
        # over-reserving is just slack, never wrong.
        if ins.size:
            need = np.bincount(ins.reshape(-1), minlength=self.n)
            row_cap = np.diff(self.row_off)
            free = row_cap - np.bincount(self.src[self.live],
                                         minlength=self.n)
            if (need > free).any():
                self._compact(reserve=need)
                compacted = True

        inserted = []
        for u, v in ins.tolist():
            if self.has_edge(u, v):     # already present: no-op
                continue
            s_uv = self._free_slot(u)
            s_vu = self._free_slot(v)
            if s_uv < 0 or s_vu < 0:    # row overflow: compact, then retry
                self._compact()
                compacted = True
                s_uv = self._free_slot(u)
                s_vu = self._free_slot(v)
            self.dst[s_uv] = v
            self.dst[s_vu] = u
            self.live[s_uv] = True
            self.live[s_vu] = True
            for s in (s_uv, s_vu):
                if self.hole[s]:        # refilled a real hole, not slack
                    self.hole[s] = False
                    self.dead -= 1
            self.deg[u] += 1
            self.deg[v] += 1
            self.m += 1
            inserted.append((u, v))

        if self.dead > self.compact_dead_frac * max(self.capacity, 1):
            self._compact()
            compacted = True

        def arr(pairs):
            return (np.asarray(pairs, np.int64).reshape(-1, 2) if pairs
                    else np.zeros((0, 2), np.int64))

        ins_a, del_a = arr(inserted), arr(deleted)
        touched = np.unique(np.concatenate([ins_a.reshape(-1),
                                            del_a.reshape(-1)]))
        return ChurnDelta(inserted=ins_a, deleted=del_a,
                          touched=touched.astype(np.int64),
                          compacted=compacted)

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Checkpointable array pytree of the full slot state.

        Everything mutable is captured (slot arrays, degrees, hole/dead
        fragmentation bookkeeping, compaction count) so a restored CSR is
        bit-identical — same capacities, same slot order, same compaction
        trigger point — not merely the same graph.
        """
        return {
            "row_off": self.row_off,
            "src": self.src,
            "dst": self.dst,
            "live": self.live,
            "hole": self.hole,
            "deg": self.deg,
            "dead": np.asarray(self.dead, np.int64),
            "compactions": np.asarray(self.compactions, np.int64),
        }

    @classmethod
    def from_state(cls, state: dict, *, slack: float = 0.3,
                   min_slack: int = 4,
                   compact_dead_frac: float = 0.25) -> "PatchableCSR":
        """Rebuild from ``state_dict`` output without touching a Graph.

        The churn knobs are config, not state — pass the engine's (they
        only affect FUTURE compactions).
        """
        csr = cls.__new__(cls)
        csr.slack = float(slack)
        csr.min_slack = max(int(min_slack), 1)
        csr.compact_dead_frac = float(compact_dead_frac)
        # own, writable copies: the CSR mutates these in place, and restored
        # checkpoint leaves can arrive as read-only (mmap/device) buffers
        csr.row_off = np.array(state["row_off"], np.int64)
        csr.n = int(csr.row_off.shape[0]) - 1
        csr.src = np.array(state["src"], np.int32)
        csr.dst = np.array(state["dst"], np.int32)
        csr.live = np.array(state["live"], bool)
        csr.hole = np.array(state["hole"], bool)
        csr.deg = np.array(state["deg"], np.int32)
        csr.m = int(csr.deg.sum()) // 2
        csr.dead = int(state["dead"])
        csr.compactions = int(state["compactions"])
        return csr

    def to_graph(self) -> Graph:
        """Materialize the exact immutable Graph (sorted COO).

        Verification/interop only; the engine's hot path consumes the slot
        arrays directly. The live arcs are sorted as one int64 key
        ``src * n + dst`` (unique per arc): the reference's ``lexsort``
        order in a fraction of its time at tens of millions of arcs.
        """
        key = np.sort(self.src[self.live].astype(np.int64) * max(self.n, 1)
                      + self.dst[self.live])
        src = (key // max(self.n, 1)).astype(np.int32)
        dst = (key % max(self.n, 1)).astype(np.int32)
        offsets = np.zeros(self.n + 1, np.int64)
        np.cumsum(self.deg, out=offsets[1:])
        return Graph(n=self.n, m=self.m, src=src, dst=dst,
                     offsets=offsets, deg=self.deg.copy())


def random_churn_batch(g: Graph, n_insert: int, n_delete: int,
                       rng: np.random.Generator) -> EdgeBatch:
    """Sample a churn batch: ``n_delete`` existing edges chosen uniformly
    without replacement, and ``n_insert`` uniform non-loop pairs (mostly new
    edges; collisions with existing ones are legal no-op inserts)."""
    edges = canonical_edges(g)
    n_delete = min(n_delete, edges.shape[0])
    if n_delete:
        sel = rng.choice(edges.shape[0], size=n_delete, replace=False)
        delete = edges[sel]
    else:
        delete = np.zeros((0, 2), np.int64)
    if n_insert and g.n >= 2:
        insert = rng.integers(0, g.n, size=(n_insert, 2), dtype=np.int64)
        insert = insert[insert[:, 0] != insert[:, 1]]
    else:
        insert = np.zeros((0, 2), np.int64)
    return EdgeBatch.make(insert=insert, delete=delete)
