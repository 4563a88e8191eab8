"""The GNN family's forward half of ``repro.models.gnn.steps``: the model
registry, parameters with the ``classify`` head, node logits, and the
batch specs of the assigned shapes.

The reference's train step, its losses and ``build_train`` arrive with the
training slice (ROADMAP.md Queue A item 12); so do the mesh placements.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.models.gnn import egnn, graphcast, mace, schnet
from repro_torch.models.gnn.common import dst_layout
from repro_torch.platform import resolve_device

_MODELS = {"mace": mace, "schnet": schnet, "egnn": egnn, "graphcast": graphcast}


def model_module(cfg: GNNConfig):
    return _MODELS[cfg.kind]


def edge_layout(cfg: GNNConfig, batch: dict):
    """What the model's ``node_embeddings`` takes as ``layout``: the
    destination layout, or MACE's one per edge chunk."""
    return mace.edge_layouts(batch) if cfg.kind == "mace" else dst_layout(batch)


def param_spec(cfg: GNNConfig, d_in: int | None = None, n_classes: int = 0) -> dict:
    spec = model_module(cfg).param_spec(cfg, d_in)
    if n_classes:
        spec["classify"] = (cfg.d_hidden, n_classes)
    return spec


def init_params(cfg: GNNConfig, seed: int = 0, d_in: int | None = None, n_classes: int = 0,
                device=None) -> dict:
    """The model's weights (``<model>.init_params``) and, with ``n_classes``,
    a ``classify`` head N(0, 1/d_hidden) drawn after them."""
    dev = resolve_device(device)
    params = model_module(cfg).init_params(cfg, seed, d_in=d_in, device=dev)
    if n_classes:
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        params["classify"] = torch.randn((cfg.d_hidden, n_classes), generator=gen,
                                         device=dev) / math.sqrt(cfg.d_hidden)
    return params


def node_logits(params: dict, cfg: GNNConfig, batch: dict, layout=None) -> torch.Tensor:
    h = model_module(cfg).node_embeddings(params, cfg, batch, layout=layout)
    return h @ params["classify"].to(h.dtype)


# ---------------------------------------------------------------------- #
# Specs
# ---------------------------------------------------------------------- #

def _pad512(x: int) -> int:
    """Round up: node arrays to a 512 multiple (lcm of both production
    meshes), big edge arrays to 512*64 so MACE's power-of-two edge chunking
    keeps 512-divisible chunks; masks make padding semantically inert."""
    m = 512 * 64 if x > 4_000_000 else 512
    return ((x + m - 1) // m) * m


def batch_specs(cfg: GNNConfig, shape: ShapeSpec) -> dict:
    """``{key: (shape, dtype)}`` of the batch of each assigned shape, in the
    reference's key order."""
    f32, i32 = torch.float32, torch.int32
    k = shape.kind
    if k == "molecule":
        B = shape.params["batch"]
        N = _pad512(B * shape.params["n_nodes"])
        E = _pad512(2 * B * shape.params["n_edges"])
        d_feat, labels = None, ((B,), f32)
    elif k == "minibatch":
        seeds = shape.params["batch_nodes"]
        f = shape.params["fanout"]
        sizes = [seeds]
        for fo in f:
            sizes.append(sizes[-1] * fo)
        N = _pad512(sum(sizes))
        E = _pad512(sum(sizes[i + 1] for i in range(len(f))))
        d_feat = shape.params["d_feat"]
        labels = ((N,), i32)
    else:
        N = _pad512(shape.params["n_nodes"])
        E = _pad512(2 * shape.params["n_edges"])
        d_feat = shape.params["d_feat"]
        labels = ((N,), i32)
    specs = {
        "src": ((E,), i32),
        "dst": ((E,), i32),
        "edge_mask": ((E,), torch.bool),
        "node_mask": ((N,), torch.bool),
        "graph_id": ((N,), i32),
        "positions": ((N, 3), f32),
        "species": ((N,), i32),
        "labels": labels,
    }
    if d_feat:
        specs["feats"] = ((N, d_feat), f32)
    return specs


def n_classes_for(shape: ShapeSpec) -> int:
    return int(shape.params.get("n_classes", 0))


def pad_batch(batch: dict) -> dict:
    """A numpy batch padded as ``batch_specs`` pads its shape: arcs and
    nodes up to ``_pad512``, pad arcs 0 -> 0 with ``edge_mask`` false, pad
    nodes zero with ``node_mask`` false."""
    E, N = batch["src"].shape[0], batch["node_mask"].shape[0]
    pe, pn = _pad512(E) - E, _pad512(N) - N
    edge_keys, node_keys = ("src", "dst", "edge_mask"), ("node_mask", "graph_id", "positions",
                                                          "species", "feats")
    out = dict(batch)
    for k in edge_keys:
        out[k] = np.concatenate([batch[k], np.zeros(pe, batch[k].dtype)])
    for k in node_keys:
        if k in batch:
            v = batch[k]
            out[k] = np.concatenate([v, np.zeros((pn, *v.shape[1:]), v.dtype)])
    if batch["labels"].shape[0] == N:
        out["labels"] = np.concatenate([batch["labels"], np.zeros(pn, batch["labels"].dtype)])
    return out
