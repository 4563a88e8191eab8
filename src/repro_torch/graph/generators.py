"""Deterministic graph generators (copy of ``repro.graph.generators``).

The paper evaluates on 14 SNAP graphs (Table I). The repo runs on *SNAP
analogues*: synthetic graphs whose generator and parameters match each
original's vertex count, edge count and degree law, scaled by ``scale``.
The Table-I statistics of the originals are kept in ``SNAP_TABLE``. Every
generator gives the same graph as the reference's for the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import Graph


# ---------------------------------------------------------------------- #
# Small deterministic graphs
# ---------------------------------------------------------------------- #

def chain(n: int) -> Graph:
    """Path graph — the paper's worst case (depth = Θ(n) rounds)."""
    e = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return Graph.from_edges(e, n=n)


def cycle(n: int) -> Graph:
    e = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return Graph.from_edges(e, n=n)


def complete(n: int) -> Graph:
    iu = np.triu_indices(n, k=1)
    return Graph.from_edges(np.stack(iu, axis=1), n=n)


def star(n: int) -> Graph:
    e = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    return Graph.from_edges(e, n=n)


def fig1_example() -> tuple[Graph, np.ndarray]:
    """The paper's Fig. 1 example (nodes A..H = 0..7).

    K4 on {A,B,E,F} (3-core); G,H attached with degree 2 (2-core);
    C,D pendant chain (1-core). Returns (graph, expected core numbers).
    """
    A, B, C, D, E, F, G, H = range(8)
    edges = [
        (A, B), (A, E), (A, F), (B, E), (B, F), (E, F),   # K4
        (G, A), (G, H), (H, B),                            # 2-core fringe
        (C, A), (C, D),                                    # 1-core tail
    ]
    expect = np.array([3, 3, 1, 1, 3, 3, 2, 2], np.int32)
    return Graph.from_edges(edges, n=8), expect


# ---------------------------------------------------------------------- #
# Random families
# ---------------------------------------------------------------------- #

def erdos_renyi(n: int, m: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    # Oversample then dedupe to hit ~m edges.
    k = int(m * 1.3) + 16
    e = rng.integers(0, n, size=(k, 2), dtype=np.int64)
    g = Graph.from_edges(e, n=n)
    return g


def barabasi_albert(n: int, m_attach: int, seed: int = 0) -> Graph:
    """Preferential attachment (power-law degrees), vectorized repeated-node
    trick: new vertex attaches to ``m_attach`` targets sampled from the
    degree-weighted repeated-endpoint list.

    The reference draws with ``rng.choice`` from a list that grows each
    step (quadratic in n); here the list is one preallocated array and a
    draw is ``rng.integers(0, len, m_attach)`` into it, which is what
    ``choice`` draws, so the graph is the reference's, bit for bit.
    """
    rng = np.random.default_rng(seed)
    m_attach = max(1, min(m_attach, n - 1))
    repeated = np.empty(m_attach + 2 * m_attach * max(n - m_attach, 0), np.int64)
    repeated[:m_attach] = np.arange(m_attach)  # seed clique-ish endpoints
    size = m_attach
    src, dst = [], []
    for v in range(m_attach, n):
        targets = np.unique(repeated[rng.integers(0, size, size=m_attach, dtype=np.int64)])
        k = targets.size
        src.append(np.full(k, v, np.int64))
        dst.append(targets)
        repeated[size:size + k] = targets
        repeated[size + k:size + 2 * k] = v
        size += 2 * k
    if not src:
        return Graph.from_edges(np.zeros((0, 2), np.int64), n=n)
    return Graph.from_edges(np.stack([np.concatenate(src), np.concatenate(dst)], axis=1), n=n)


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """R-MAT / Graph500-style power-law generator, fully vectorized.

    Each bit draws one uniform per edge into a reused buffer; the quadrant
    tests are written in place (right = (r >= a) ^ (r >= a + b) ^ (r >= a +
    b + c), the same booleans as the reference's), and the ids accumulate
    in 32 bits where they fit."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    ids = np.uint32 if scale <= 32 else np.uint64
    src = np.zeros(m, ids)
    dst = np.zeros(m, ids)
    r = np.empty(m)
    go_down, go_right, past = (np.empty(m, bool) for _ in range(3))
    for bit in range(scale):
        rng.random(m, out=r)
        # quadrant probabilities: a (0,0), b (0,1), c (1,0), d (1,1)
        np.greater_equal(r, a + b, out=go_down)
        np.greater_equal(r, a, out=go_right)
        np.logical_xor(go_right, go_down, out=go_right)
        np.greater_equal(r, a + b + c, out=past)
        np.logical_xor(go_right, past, out=go_right)
        src |= np.left_shift(go_down.view(np.uint8), bit, dtype=ids)
        dst |= np.left_shift(go_right.view(np.uint8), bit, dtype=ids)
    return Graph.from_edges(np.stack([src, dst], axis=1), n=n)


def community(n: int, n_blocks: int, deg_in: float, deg_out: float,
              seed: int = 0) -> Graph:
    """Stochastic block model (social-network analogue)."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, n_blocks, n)
    m_in = int(n * deg_in / 2)
    m_out = int(n * deg_out / 2)
    # intra-block edges: pick a vertex, then a partner in the same block
    order = np.argsort(block, kind="stable")
    counts = np.bincount(block, minlength=n_blocks)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    u = rng.integers(0, n, size=m_in)
    bu = block[u]
    offs = rng.integers(0, np.maximum(counts[bu], 1))
    v = order[starts[bu] + offs % np.maximum(counts[bu], 1)]
    intra = np.stack([u, v], axis=1)
    inter = rng.integers(0, n, size=(m_out, 2))
    return Graph.from_edges(np.concatenate([intra, inter]), n=n)


# ---------------------------------------------------------------------- #
# SNAP Table-I analogues
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SnapEntry:
    name: str
    abbrev: str
    category: str
    directed: bool
    n: int
    m: int
    avg_deg: int
    max_deg: int
    max_core: int        # Table I MaxCore of the original
    family: str          # generator family for the analogue


SNAP_TABLE: tuple[SnapEntry, ...] = (
    SnapEntry("soc-pokec-relationships", "SPR", "Social", True, 1_632_803, 30_622_564, 29, 14739, 118, "rmat"),
    SnapEntry("musae-PTBR-features", "PTBR", "Social", False, 1_912, 31_299, 24, 1635, 21, "ba"),
    SnapEntry("facebook-combined", "FC", "Social", False, 4_039, 88_234, 46, 986, 118, "ba"),
    SnapEntry("musae-git-features", "MGF", "Social", False, 37_700, 289_003, 36, 28191, 29, "rmat"),
    SnapEntry("soc-LiveJournal1", "LJ1", "Social", True, 4_847_571, 68_993_773, 19, 20314, 376, "rmat"),
    SnapEntry("email-Enron", "EEN", "Communication", False, 36_692, 183_831, 10, 1383, 49, "ba"),
    SnapEntry("email-EuAll", "EEU", "Communication", True, 265_214, 420_045, 2, 7631, 44, "star-law"),
    SnapEntry("p2p-Gnutella31", "G31", "P2P", True, 62_586, 147_892, 7, 68, 9, "er"),
    SnapEntry("com-lj", "CLJ", "Communities", False, 3_997_962, 34_681_189, 25, 14208, 360, "rmat"),
    SnapEntry("com-amazon", "CA", "Communities", False, 334_863, 925_872, 5, 546, 8, "community"),
    SnapEntry("web-Stanford", "WS", "Web", True, 281_903, 2_312_497, 14, 38625, 75, "rmat"),
    SnapEntry("web-Google", "WG", "Web", True, 875_713, 5_105_039, 10, 6331, 44, "rmat"),
    SnapEntry("amazon0505", "A0505", "Co-purchase", True, 410_236, 3_356_824, 12, 2760, 15, "community"),
    SnapEntry("soc-Slashdot0811", "S0811", "Signed", True, 77_357, 516_575, 13, 2540, 59, "ba"),
)

SNAP_BY_ABBREV = {e.abbrev: e for e in SNAP_TABLE}


def snap_analogue(abbrev: str, scale: float = 1.0, seed: int = 0) -> Graph:
    """Synthetic analogue of a Table-I graph at ``scale`` of its size.

    Matches n and average degree; the family reproduces the degree law
    (power-law for social/web, near-uniform for P2P, hub-dominated for EEU).
    """
    e = SNAP_BY_ABBREV[abbrev]
    n = max(int(e.n * scale), 64)
    m = max(int(e.m * scale), n)
    if e.family == "er":
        return erdos_renyi(n, m, seed=seed)
    if e.family == "ba":
        return barabasi_albert(n, max(1, round(m / n)), seed=seed)
    if e.family == "community":
        return community(n, max(2, n // 64), deg_in=1.6 * m / n, deg_out=0.4 * m / n, seed=seed)
    if e.family == "star-law":
        # Hub-dominated: low average degree, few huge hubs (email-EuAll).
        rng = np.random.default_rng(seed)
        hubs = rng.integers(0, max(n // 1000, 1), size=m)
        leaves = rng.integers(0, n, size=m)
        return Graph.from_edges(np.stack([hubs, leaves], axis=1), n=n)
    # rmat: choose scale bits to cover n, then subsample vertices to n
    bits = int(np.ceil(np.log2(max(n, 2))))
    g = rmat(bits, max(1, round(m / (1 << bits))), seed=seed)
    return g
