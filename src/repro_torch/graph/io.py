"""Graph IO — the paper's ``dataCleanse`` procedure.

The port's copy of ``repro.graph.io`` (numpy only), over the port's
``Graph.from_edges``.

Supports the two on-disk formats the paper mentions:
  * SNAP-style edge lists (``u<TAB>v`` per line, ``#`` comments), directed or
    undirected — converted to undirected per the paper's rules;
  * the JSON adjacency format the paper converts graphs into
    (``{"0": [1, 2], "1": [0], ...}``).
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.graph.structs import Graph


def parse_edge_list(text: str, n: int | None = None) -> Graph:
    edges = _parse_edge_lines(text.splitlines())
    return Graph.from_edges(edges, n=n)


def _parse_edge_lines(lines) -> np.ndarray:
    """(k, 2) int64 edges from raw edge-list lines (comments dropped).

    Fast path: when every data line has the same column count the whole
    batch is one vectorized ``np.array`` over the flat token stream — no
    per-line int() loop, no ``np.loadtxt``. Ragged inputs (mixed column
    counts) fall back to per-line parsing, keeping the first two columns
    like the paper's dataCleanse.
    """
    toks = [s.replace(",", " ").split()
            for s in (ln.strip() for ln in lines) if s and s[0] not in "#%"]
    if not toks:
        return np.zeros((0, 2), np.int64)
    cols = len(toks[0])
    if cols >= 2 and all(len(t) == cols for t in toks):
        # rectangular: ONE vectorized str->int64 conversion for the batch
        return np.array(toks, np.int64)[:, :2]
    return np.array([t[:2] for t in toks], np.int64)


def iter_edge_chunks(path: str, chunk_bytes: int = 1 << 24):
    """Yield (k, 2) int64 edge arrays from a file, ~chunk_bytes at a time.

    The streaming primitive under ``load_edge_list``: only one chunk of
    text is ever resident, so parsing a million-edge SNAP list costs the
    edge arrays — not the file's text plus per-line Python tuples on top.
    """
    with open(path) as f:
        while True:
            lines = f.readlines(chunk_bytes)
            if not lines:
                return
            edges = _parse_edge_lines(lines)
            if edges.size:
                yield edges


def load_edge_list(path: str, n: int | None = None,
                   chunk_bytes: int = 1 << 24) -> Graph:
    """Load a SNAP-style edge list with bounded parse memory.

    Streams the file through ``iter_edge_chunks`` instead of slurping it:
    peak RSS is the int64 edge array (plus one text chunk), where the old
    path held the entire file text AND a Python tuple per edge before the
    first numpy array existed.
    """
    chunks = list(iter_edge_chunks(path, chunk_bytes))
    edges = (np.concatenate(chunks) if chunks
             else np.zeros((0, 2), np.int64))
    return Graph.from_edges(edges, n=n)


def parse_json_adjacency(text: str) -> Graph:
    adj = json.loads(text)
    edges = []
    max_id = -1
    for u, nbrs in adj.items():
        ui = int(u)
        max_id = max(max_id, ui)
        for v in nbrs:
            vi = int(v)
            max_id = max(max_id, vi)
            edges.append((ui, vi))
    # n must cover vertices appearing only as neighbor values (an adjacency
    # like {"0": [5]} is legal and means n = 6), not just the keys.
    n = max_id + 1
    return Graph.from_edges(np.asarray(edges, np.int64).reshape(-1, 2), n=n)


def to_json_adjacency(g: Graph) -> str:
    adj = {str(u): [int(v) for v in g.neighbors(u)] for u in range(g.n)}
    return json.dumps(adj)


def save_json_adjacency(g: Graph, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_json_adjacency(g))
