"""k-truss decomposition — the paper's §V future-work extension.

The k-truss of G is the maximal subgraph whose every edge lies in at least
k−2 triangles within the subgraph; the truss number of an edge is the
largest such k. Like k-core, it admits a vertex/edge-local fixpoint
iteration: an edge's support only depends on its triangles, so the same
BSP engine pattern applies (edge states instead of vertex states).

The port's copy of ``repro.core.ktruss``, numpy on the host in both
packages. Here: a sequential peeling oracle (numpy) and a synchronous
"h-index-style" BSP iteration with the paper-style message accounting —
each support decrease notifies the edge's triangle partners.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.messages import MessageStats
from repro_torch.graph.structs import Graph


def _undirected_edges(g: Graph) -> np.ndarray:
    e = np.stack([g.src, g.dst], axis=1)
    return e[e[:, 0] < e[:, 1]]


def _adj_sets(g: Graph):
    return [set(g.neighbors(u).tolist()) for u in range(g.n)]


def ktruss_peeling(g: Graph) -> dict[tuple[int, int], int]:
    """Sequential truss numbers via support peeling (the BZ analogue)."""
    edges = [tuple(e) for e in _undirected_edges(g)]
    adj = _adj_sets(g)
    support = {e: len(adj[e[0]] & adj[e[1]]) for e in edges}
    truss: dict[tuple[int, int], int] = {}
    alive = set(edges)
    k = 2
    while alive:
        peel = [e for e in alive if support[e] <= k - 2]
        if not peel:
            k += 1
            continue
        while peel:
            e = peel.pop()
            if e not in alive:
                continue
            alive.discard(e)
            truss[e] = k
            u, v = e
            for w in adj[u] & adj[v]:
                for f in ((min(u, w), max(u, w)), (min(v, w), max(v, w))):
                    if f in alive:
                        support[f] -= 1
                        if support[f] <= k - 2:
                            peel.append(f)
            adj[u].discard(v)
            adj[v].discard(u)
    return truss


def ktruss_bsp(g: Graph, max_rounds: int | None = None):
    """Synchronous edge-local iteration: every round each edge recomputes
    its support against CURRENT alive edges at its own threshold; edges
    whose support k-converges stop. Message accounting: an edge that drops
    out notifies its (pre-drop) triangle partners.

    Returns (truss dict, MessageStats)."""
    edges = [tuple(e) for e in _undirected_edges(g)]
    adj = _adj_sets(g)
    support = {e: len(adj[e[0]] & adj[e[1]]) for e in edges}
    # truss estimate init: support + 2 (analogue of est=degree)
    est = {e: support[e] + 2 for e in edges}
    msgs = [2 * 3 * sum(support.values()) // 3 or len(edges)]
    active = [len(edges)]
    changed_per_round = [len(edges)]
    rounds = 0
    cap = max_rounds or (len(edges) + 1)
    while rounds < cap:
        rounds += 1
        new_est = {}
        for (u, v) in edges:
            # h-index over triangle partners: largest k such that at least
            # k-2 triangles have both partner edges with est >= k
            tri = []
            for w in adj[u] & adj[v]:
                e1 = (min(u, w), max(u, w))
                e2 = (min(v, w), max(v, w))
                tri.append(min(est[e1], est[e2]))
            k = est[(u, v)]
            while k > 2 and sum(t >= k for t in tri) < k - 2:
                k -= 1
            new_est[(u, v)] = min(k, est[(u, v)])
        changed = [e for e in edges if new_est[e] < est[e]]
        est = new_est
        if not changed:
            break
        msgs.append(sum(len(adj[e[0]] & adj[e[1]]) * 2 for e in changed))
        changed_per_round.append(len(changed))
        active.append(len({f for e in changed
                           for w in adj[e[0]] & adj[e[1]]
                           for f in ((min(e[0], w), max(e[0], w)),
                                     (min(e[1], w), max(e[1], w)))}))
    stats = MessageStats(np.asarray(msgs, np.int64),
                         np.asarray(active[: len(msgs)], np.int64),
                         np.asarray(changed_per_round[: len(msgs)],
                                    np.int64))
    return est, stats
