"""Shared GNN substrate of the port (the counterpart of ``repro.models.gnn.common``).

Message passing is a gather of node rows by arc and a segment sum of the
arcs' messages by destination. The segment sum is the float form of the
segment-sum kernel (``kernels/segment_sum``): ``scatter_sum(values, layout)``
takes a ``SegmentLayout`` of the destinations, built once per graph or batch
(``segment_layout``) and passed through the models, where the reference's
``scatter_sum(values, index, n)`` takes the ids themselves.

All four assigned shapes lower to one batch layout, a dict of numpy arrays
built by ``batch_from_graph``, ``batch_molecules`` or ``batch_from_sampled``
(equal to the reference's for the same seed) and moved to a device by
``batch_to``:

  feats (N, d_feat) | species (N,) | positions (N, 3)
  src, dst (E,) int32 | edge_mask (E,) bool | node_mask (N,) bool
  graph_id (N,) int32 | labels (N,) int32 or (G,) float32

Layers are a list of ``{"w": (in, out), "b": (out,)}`` dicts in the
reference's layout: weights drawn N(0, 1/in) from a ``torch.Generator``,
zero biases, SiLU between layers and none after the last.

Activations of GraphCast's generic mode and of MACE are bf16
(``COMPUTE_DTYPE``), as in the reference, unless the parameters are float64:
then the model runs in float64 throughout, geometry included (the yardstick
evaluation a result is held against). float32 matmuls keep PyTorch's default
on the card, TF32 off.

There is no sharded scatter yet: ``set_flat_sharding`` takes no mesh
(ROADMAP.md Queue A item 12, ``distribution/sharding.py``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.graph.structs import Graph
from repro_torch.kernels.segment_sum import ops as _seg
from repro_torch.kernels.segment_sum.ops import SegmentLayout, segment_layout

COMPUTE_DTYPE = torch.bfloat16   # GNN activation dtype (params stay float32)

_PLAIN = {"on": False}


def compute_dtype(params_leaf: torch.Tensor) -> torch.dtype:
    """bf16, or float64 when the parameters are float64."""
    return torch.float64 if params_leaf.dtype == torch.float64 else COMPUTE_DTYPE


@contextmanager
def plain_scatter():
    """Inside, ``scatter_sum`` takes the kernel's plain version on every
    device: the route a kernel's result is held against, and the route of a
    float64 evaluation on the card. No model path enters it by itself."""
    before = _PLAIN["on"]
    _PLAIN["on"] = True
    try:
        yield
    finally:
        _PLAIN["on"] = before


def scatter_sum(values: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Segment-sum messages ``values`` (E, ...) into ``layout.n`` rows (n, ...)."""
    if _PLAIN["on"]:
        return _seg.segment_sum_float_ref(values, layout.ids, layout.n)
    flat = values.reshape(values.shape[0], -1) if values.dim() > 2 else values
    return _seg.segment_sum_float(flat, layout).reshape(layout.n, *values.shape[1:])


def scatter_mean(values: torch.Tensor, layout: SegmentLayout, eps: float = 1e-9):
    s = scatter_sum(values, layout)
    cnt = scatter_sum(values.new_ones(values.shape[:1]), layout)
    return s / (cnt[:, None] + eps) if values.dim() > 1 else s / (cnt + eps)


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return h.index_select(0, idx)


def gather_rows_multi(h: torch.Tensor, idxs: tuple) -> tuple:
    return tuple(h.index_select(0, i) for i in idxs)


def set_flat_sharding(mesh, axes) -> None:
    """Without a mesh, nothing to set. A mesh raises: the sharded scatter
    (local segment sums and a reduce-scatter) is not ported."""
    if mesh is not None:
        raise NotImplementedError("GNN message passing on a mesh is not ported yet: ROADMAP.md "
                                  "Queue A item 12 (distribution/sharding.py)")


def constrain_rows(x: torch.Tensor) -> torch.Tensor:
    """No-op: there is no mesh (``set_flat_sharding``)."""
    return x


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32, device=None) -> list[dict]:
    """One ``{"w", "b"}`` dict per pair of consecutive ``sizes``; the draws
    come from ``gen``, on its device, in layer order."""
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, dtype=dtype, device=device) * (1.0 / math.sqrt(a))
        layers.append({"w": w, "b": torch.zeros((b,), dtype=dtype, device=device)})
    return layers


def mlp_spec(sizes) -> list[dict]:
    """The shapes ``mlp_init(gen, sizes)`` draws."""
    return [{"w": (a, b), "b": (b,)} for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(layers: list[dict], x: torch.Tensor, act=F.silu, final_act: bool = False):
    """``x @ w + b`` per layer, ``act`` between layers (and after the last
    with ``final_act``). Outside autograd the activation runs in place, which
    saves one activation-sized buffer a layer."""
    for i, layer in enumerate(layers):
        x = F.linear(x, layer["w"].to(x.dtype).t(), layer["b"].to(x.dtype))
        if i < len(layers) - 1 or final_act:
            x = act(x, inplace=True) if act is F.silu and not torch.is_grad_enabled() else act(x)
    return x


def layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis, in float32 (float64 for float64), no affine."""
    xf = x.float() if x.dtype != torch.float64 else x
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------- #
# Radial bases
# ---------------------------------------------------------------------- #

def gaussian_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """SchNet-style Gaussian radial basis."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype, device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[..., None] - centers) ** 2)


def bessel_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """MACE/NequIP Bessel basis with smooth cutoff envelope."""
    d = dist.clamp_min(1e-6)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=dist.dtype, device=dist.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d
    x = (dist / cutoff).clamp(0, 1)[..., None]
    envelope = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5   # polynomial cutoff p=3
    return basis * envelope


def positions_for(h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Positions as the model reads them: float64 in a float64 evaluation,
    as given (float32) otherwise."""
    return positions.to(torch.float64) if h.dtype == torch.float64 else positions


def dst_layout(batch: dict) -> SegmentLayout:
    """The layout of a batch's arc destinations over its nodes."""
    return segment_layout(batch["dst"], batch["node_mask"].shape[0])


def graph_layout(batch: dict, n_graphs: int) -> SegmentLayout:
    """The layout of a batch's node-to-graph ids (energy pooling)."""
    return segment_layout(batch["graph_id"], n_graphs)


def params_to(params, device=None, dtype=None):
    """A copy of a parameter tree on ``device`` (and in ``dtype``, where
    given); ``None`` entries (no ``proj_in``) stay ``None``."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return None if params is None else params.to(device=device, dtype=dtype)


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``, dtypes kept
    (``n_seeds`` stays an int)."""
    return {k: int(v) if k == "n_seeds" else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------- #
# Batch builders (host-side, numpy; equal to the reference's for a seed)
# ---------------------------------------------------------------------- #

def batch_from_graph(g: Graph, d_feat: int, n_classes: int, seed: int = 0,
                     with_positions: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    batch = {
        "src": g.src.astype(np.int32),
        "dst": g.dst.astype(np.int32),
        "edge_mask": np.ones(g.num_arcs, bool),
        "node_mask": np.ones(g.n, bool),
        "graph_id": np.zeros(g.n, np.int32),
        "feats": rng.normal(size=(g.n, d_feat)).astype(np.float32),
        "labels": rng.integers(0, n_classes, g.n).astype(np.int32),
    }
    if with_positions:
        batch["positions"] = rng.normal(size=(g.n, 3)).astype(np.float32) * 3
        batch["species"] = rng.integers(0, 4, g.n).astype(np.int32)
    return batch


def batch_molecules(n_mols: int, n_nodes: int, n_edges: int, n_species: int,
                    seed: int = 0) -> dict:
    """Disjoint union of n_mols random molecules (fixed nodes/edges each)."""
    rng = np.random.default_rng(seed)
    N = n_mols * n_nodes
    offsets = np.repeat(np.arange(n_mols) * n_nodes, n_edges)
    e = rng.integers(0, n_nodes, size=(n_mols * n_edges, 2))
    # symmetric arcs: both directions
    src = np.concatenate([e[:, 0] + offsets, e[:, 1] + offsets]).astype(np.int32)
    dst = np.concatenate([e[:, 1] + offsets, e[:, 0] + offsets]).astype(np.int32)
    keep = src != dst
    return {
        "src": np.where(keep, src, 0),
        "dst": np.where(keep, dst, 0),
        "edge_mask": keep,
        "node_mask": np.ones(N, bool),
        "graph_id": np.repeat(np.arange(n_mols), n_nodes).astype(np.int32),
        "positions": rng.normal(size=(N, 3)).astype(np.float32) * 2,
        "species": rng.integers(0, n_species, N).astype(np.int32),
        "labels": rng.normal(size=(n_mols,)).astype(np.float32),  # energies
    }


def batch_from_sampled(g: Graph, sub, d_feat: int, n_classes: int,
                       feats: np.ndarray | None = None,
                       labels: np.ndarray | None = None,
                       seed: int = 0) -> dict:
    """Flatten a sampler.SampledSubgraph into one padded edge-list batch.

    Nodes = concatenation of all sampler layers (seeds first). Predictions
    read the seed prefix."""
    rng = np.random.default_rng(seed)
    layer_sizes = [ln.shape[0] for ln in sub.layer_nodes]
    starts = np.concatenate([[0], np.cumsum(layer_sizes)[:-1]])
    all_nodes = np.concatenate(sub.layer_nodes)
    node_mask = all_nodes >= 0
    safe = np.where(node_mask, all_nodes, 0)
    srcs, dsts, masks = [], [], []
    for h, blk in enumerate(sub.blocks):
        dsts.append(blk.dst_index + starts[h])
        srcs.append(blk.src_index + starts[h + 1])
        masks.append(blk.mask)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    emask = np.concatenate(masks)
    if feats is None:
        feats = rng.normal(size=(len(all_nodes), d_feat)).astype(np.float32)
    else:
        feats = feats[safe] * node_mask[:, None]
    if labels is None:
        labels = rng.integers(0, n_classes, len(all_nodes)).astype(np.int32)
    else:
        labels = labels[safe]
    return {
        # message direction: sampled neighbor (layer h+1) -> requester (h)
        "src": src, "dst": dst,
        "edge_mask": emask,
        "node_mask": node_mask,
        "graph_id": np.zeros(len(all_nodes), np.int32),
        "feats": feats.astype(np.float32),
        "labels": labels,
        "positions": rng.normal(size=(len(all_nodes), 3)).astype(np.float32),
        "species": rng.integers(0, 4, len(all_nodes)).astype(np.int32),
        "n_seeds": np.int32(layer_sizes[0]),
    }
