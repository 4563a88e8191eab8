"""Core graph data structures (numpy, host-side).

The port's copy of ``repro.graph.structs``, trimmed to what the static
decomposition needs:

  * ``Graph`` — undirected graph as sorted COO + CSR: arcs (both directions
    of every undirected edge) sorted by source, with CSR offsets. The
    segment-sum kernel reduces over exactly these CSR rows.
  * ``EllGraph`` — degree-bucketed ELL: vertices bucketed by degree,
    neighbor lists padded to the bucket width, giving rectangular
    (rows x width) tiles for the ``kcore_hindex`` kernel.

Construction follows the paper's dataCleanse rules (no self-loops, no
multi-edges, directed input symmetrized to undirected) and yields arrays
identical to the reference's for the same input. ``from_reference`` turns a
reference ``Graph``/``EllGraph`` into these types, so both packages can
compute on one input.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.graph.padding import round_up as _round_up


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph in sorted-COO + CSR form (numpy, host-side)."""

    n: int                 # number of vertices
    m: int                 # number of undirected edges
    src: np.ndarray        # (2m,) int32 — arc sources, sorted ascending
    dst: np.ndarray        # (2m,) int32 — arc destinations
    offsets: np.ndarray    # (n+1,) int64 — CSR row offsets into src/dst
    deg: np.ndarray        # (n,) int32  — vertex degrees

    @classmethod
    def from_edges(cls, edges: np.ndarray | Sequence[tuple[int, int]],
                   n: int | None = None) -> "Graph":
        """Build from an (E, 2) array of (possibly directed / duplicated)
        edges, applying the paper's dataCleanse rules.

        Pairs are deduplicated and sorted as one int64 key ``a * N + b``
        (``N`` = largest id + 1): the same order and the same arrays as the
        reference's row-wise ``np.unique`` and ``np.lexsort``, in a fraction
        of the time at tens of millions of edges.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if edges.size == 0:
            nn = int(n or 0)
            return cls(
                n=nn, m=0,
                src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                offsets=np.zeros(nn + 1, np.int64), deg=np.zeros(nn, np.int32),
            )
        # Rule 1: a vertex cannot connect to itself.
        a, b = edges[:, 0], edges[:, 1]
        keep = a != b
        a, b = a[keep], b[keep]
        # Rule 3 (symmetrize) and rule 2 (at most one edge per pair):
        # canonical (min, max) pairs, deduplicated.
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        key_base = int(hi.max()) + 1 if hi.size else 1
        canon = np.unique(lo * key_base + hi)
        lo, hi = canon // key_base, canon % key_base
        nn = int(n if n is not None else (hi.max() + 1 if hi.size else 0))
        m = canon.shape[0]
        # Both arc directions, sorted by src (ties by dst for determinism):
        # the keys are distinct, so sorting them gives the arcs' order.
        keys = np.concatenate([canon, hi * key_base + lo])
        keys.sort()
        src, dst = (keys // key_base).astype(np.int32), (keys % key_base).astype(np.int32)
        deg = np.bincount(src, minlength=nn).astype(np.int32)
        offsets = np.zeros(nn + 1, np.int64)
        np.cumsum(deg, out=offsets[1:])
        return cls(n=nn, m=m, src=src, dst=dst, offsets=offsets, deg=deg)

    @property
    def num_arcs(self) -> int:
        return int(self.src.shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.deg.max()) if self.n else 0

    @property
    def avg_deg(self) -> float:
        return float(self.deg.mean()) if self.n else 0.0

    def neighbors(self, u: int) -> np.ndarray:
        return self.dst[self.offsets[u]:self.offsets[u + 1]]


# ---------------------------------------------------------------------- #
# Degree-bucketed ELL layout (the kcore_hindex kernel's input)
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class EllBucket:
    width: int            # padded neighbor-list width
    ids: np.ndarray       # (rows,) int32 vertex ids (padded rows use n — the
                          # sentinel row; their results are discarded)
    nbrs: np.ndarray      # (rows, width) int32 neighbor ids, padding = n
    rows_real: int


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Degree-bucketed ELL: per bucket a dense (rows, width) neighbor table.

    Estimate lookups use an extended estimate vector ``est_ext`` of length
    n + 1 whose last entry is 0 (the sentinel), so padded neighbor slots never
    satisfy ``est >= k`` for k >= 1.
    """

    n: int
    buckets: tuple[EllBucket, ...]

    @property
    def padded_slots(self) -> int:
        return sum(b.nbrs.size for b in self.buckets)


def build_ell(g: Graph, widths: Sequence[int] = (8, 32, 128, 512, 2048),
              row_multiple: int = 8) -> EllGraph:
    """Bucket vertices by degree; pad neighbor lists to the bucket width.

    Vertices with degree above the largest width land in a final bucket sized
    to the max degree rounded up to a multiple of 128. Degree-0 vertices are
    skipped: their estimate is 0 from the degree seed and never moves.
    """
    widths = sorted(set(int(w) for w in widths))
    if g.n == 0:
        return EllGraph(n=0, buckets=())
    maxd = g.max_deg
    if maxd > widths[-1]:
        widths.append(_round_up(maxd, 128))
    buckets: list[EllBucket] = []
    degs = g.deg
    # Per-arc column index = position of the arc within its source's CSR row.
    arc_col = np.arange(g.num_arcs, dtype=np.int64) - g.offsets[g.src]
    lo = 1
    for w in widths:
        sel = np.where((degs >= lo) & (degs <= w))[0]
        lo = w + 1
        if sel.size == 0:
            continue
        rows = max(_round_up(sel.size, row_multiple), row_multiple)
        ids = np.full(rows, g.n, np.int32)
        ids[: sel.size] = sel.astype(np.int32)
        row_of = np.full(g.n, -1, np.int64)
        row_of[sel] = np.arange(sel.size)
        arc_sel = row_of[g.src] >= 0
        nbrs = np.full((rows, w), g.n, np.int32)
        nbrs[row_of[g.src[arc_sel]], arc_col[arc_sel]] = g.dst[arc_sel]
        buckets.append(EllBucket(width=w, ids=ids, nbrs=nbrs,
                                 rows_real=int(sel.size)))
    return EllGraph(n=g.n, buckets=tuple(buckets))


# ---------------------------------------------------------------------- #
# Carry-across from the reference package
# ---------------------------------------------------------------------- #

def from_reference(obj) -> Graph | EllGraph:
    """Turn a reference ``repro.graph.Graph`` or ``EllGraph`` into the port's.

    Read duck-typed through its numpy attributes, so the port never imports
    the reference. The graph (with the estimate vector) is this system's
    whole state, so this is what lets both packages compute on one input.
    """
    if hasattr(obj, "buckets"):
        return EllGraph(
            n=int(obj.n),
            buckets=tuple(
                EllBucket(width=int(b.width),
                          ids=np.asarray(b.ids, np.int32),
                          nbrs=np.asarray(b.nbrs, np.int32),
                          rows_real=int(b.rows_real))
                for b in obj.buckets),
        )
    if hasattr(obj, "offsets"):
        return Graph(n=int(obj.n), m=int(obj.m),
                     src=np.asarray(obj.src, np.int32),
                     dst=np.asarray(obj.dst, np.int32),
                     offsets=np.asarray(obj.offsets, np.int64),
                     deg=np.asarray(obj.deg, np.int32))
    raise TypeError(f"not a reference Graph or EllGraph: {type(obj).__name__}")
