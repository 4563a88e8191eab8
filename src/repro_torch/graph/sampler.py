"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg`` shape
(a numpy copy of ``repro.graph.sampler``: the same draws for the same seed).

Host-side (numpy) sampling producing fixed-shape padded blocks, so every
batch of one shape has the same tensor shapes. Layout per hop h (fanout f_h):

  nodes[h]   : (N_h,) int32 global ids of frontier nodes (padded with -1)
  edges[h]   : (N_h * f_h, 2) int32 (local_dst_index, local_src_index) pairs
               into nodes[h] / nodes[h+1], padded with (0, 0) + mask

N_0 = batch seeds; N_{h+1} = N_h * f_h. The GNN consumes hops deepest-first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structs import Graph


@dataclasses.dataclass
class SampledBlock:
    """One hop: messages flow nodes[h+1] (src) -> nodes[h] (dst)."""
    dst_index: np.ndarray   # (E_h,) int32 index into layer-h node array
    src_index: np.ndarray   # (E_h,) int32 index into layer-(h+1) node array
    mask: np.ndarray        # (E_h,) bool


@dataclasses.dataclass
class SampledSubgraph:
    seeds: np.ndarray                 # (B,) int32
    layer_nodes: list[np.ndarray]     # len = hops+1; layer_nodes[0] == seeds
    blocks: list[SampledBlock]        # len = hops
    node_mask: list[np.ndarray]       # per-layer validity


def sample_subgraph(g: Graph, seeds: np.ndarray, fanouts: tuple[int, ...],
                    seed: int = 0) -> SampledSubgraph:
    rng = np.random.default_rng(seed)
    layer_nodes = [seeds.astype(np.int32)]
    node_mask = [seeds >= 0]
    blocks: list[SampledBlock] = []
    for f in fanouts:
        cur = layer_nodes[-1]
        cur_mask = node_mask[-1]
        N = cur.shape[0]
        nxt = np.full(N * f, -1, np.int32)
        dst_index = np.repeat(np.arange(N, dtype=np.int32), f)
        src_index = np.arange(N * f, dtype=np.int32)
        mask = np.zeros(N * f, bool)
        # Vectorized uniform-with-replacement sampling from each CSR row.
        deg = np.where(cur_mask, g.deg[np.where(cur_mask, cur, 0)], 0)
        offs = g.offsets[np.where(cur_mask, cur, 0)]
        r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(N, f))
        picks = g.dst[np.minimum(offs[:, None] + r,
                                 len(g.dst) - 1 if len(g.dst) else 0)] \
            if g.num_arcs else np.zeros((N, f), np.int32)
        valid = np.repeat(((deg > 0) & cur_mask)[:, None], f, axis=1)
        nxt = np.where(valid, picks, -1).reshape(-1).astype(np.int32)
        mask = valid.reshape(-1)
        blocks.append(SampledBlock(dst_index=dst_index, src_index=src_index,
                                   mask=mask))
        layer_nodes.append(nxt)
        node_mask.append(nxt >= 0)
    return SampledSubgraph(seeds=layer_nodes[0], layer_nodes=layer_nodes,
                           blocks=blocks, node_mask=node_mask)


def minibatch_stream(g: Graph, batch: int, fanouts: tuple[int, ...],
                     seed: int = 0, epochs: int = 1):
    """Yield SampledSubgraph batches over shuffled vertex ids."""
    rng = np.random.default_rng(seed)
    for ep in range(epochs):
        order = rng.permutation(g.n)
        for i in range(0, g.n - batch + 1, batch):
            yield sample_subgraph(g, order[i:i + batch], fanouts,
                                  seed=seed + ep * 1_000_003 + i)
