"""Batagelj–Zaversnik sequential k-core decomposition — the paper's baseline.

O(n + m) bucket-sort peeling, exactly as reviewed in the paper's §I: the
sequential algorithm the distributed one is compared against, and our oracle
for every correctness test. Pure numpy, no JAX.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structs import Graph


def bz_core_numbers(g: Graph) -> np.ndarray:
    """Exact core numbers via BZ bucket peeling.

    The reference's algorithm step for step; its state lives in Python
    lists rather than numpy arrays, since the peeling loop reads and writes
    one element at a time (several times faster at tens of millions of arcs).
    """
    n = g.n
    if n == 0:
        return np.zeros(0, np.int32)
    deg_np = g.deg.astype(np.int64)
    md = int(deg_np.max())

    # bucket sort vertices by degree (stable, as the reference's fill loop)
    bin_start = np.zeros(md + 2, np.int64)
    np.cumsum(np.bincount(deg_np, minlength=md + 1), out=bin_start[1:])
    vert_np = np.argsort(deg_np, kind="stable")          # vertices by degree
    pos_np = np.empty(n, np.int64)                       # position in vert
    pos_np[vert_np] = np.arange(n)
    deg, vert, pos = deg_np.tolist(), vert_np.tolist(), pos_np.tolist()
    bin_ptr = bin_start[:-1].tolist()    # start index of each degree bucket

    core = list(deg)
    dst, offsets = g.dst.tolist(), g.offsets.tolist()
    for i in range(n):
        v = vert[i]
        dv = deg[v]
        core[v] = dv
        for u in dst[offsets[v]:offsets[v + 1]]:
            du = deg[u]
            if du > dv:
                pu = pos[u]
                pw = bin_ptr[du]
                w = vert[pw]
                if u != w:               # swap u to the front of its bucket
                    pos[u], pos[w] = pw, pu
                    vert[pu], vert[pw] = w, u
                bin_ptr[du] += 1
                deg[u] = du - 1
    return np.asarray(core, np.int32)
