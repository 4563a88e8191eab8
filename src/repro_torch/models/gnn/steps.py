"""Train steps and batch specs of the GNN family (the port of
``repro.models.gnn.steps``): the model registry, parameters with the
``classify`` head, node logits, the two losses, ``make_train_step``,
``build_train`` and the batch specs of the assigned shapes.

  full_graph_sm / ogb_products — node cross-entropy over the whole graph;
  minibatch_lg — node cross-entropy over the seed prefix of the sampled block;
  molecule — per-graph energy MSE.

Gradients come from autograd, through the float segment sum's backward (a
gather) and the models' checkpointed blocks.

On a flat mesh (a ``distribution.compat`` mesh of one process or of several
gloo processes), ``build_train(cfg, shape, mesh)`` sets the flat
row-sharding context and returns the reference's placements as
``distribution.sharding`` specs: batch arrays of more than 1,024 rows
sharded over every mesh axis, the rest, the parameters and the AdamW state
replicated. ``stage_batch`` puts a numpy batch on the mesh by those
placements (each process its own row blocks) and ``mesh_layouts`` builds its
``MeshArcs`` (and the molecules' pooling layout) from the whole ids; the
step takes both. On several processes the step seeds its loss (held whole)
with 1/world, as ``distribution/compat.py``'s rule for gradients has it,
and sums the parameters' gradients over the processes in rank order before
AdamW, so every process makes the same update.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig, ShapeSpec
from repro_torch.distribution import compat
from repro_torch.distribution.sharding import NamedSharding, P
from repro_torch.models.autodiff import value_and_grad
from repro_torch.models.gnn import egnn, graphcast, mace, schnet
from repro_torch.models.gnn.common import (BLOCK_ROWS_MIN, MeshArcs, MeshLayout, dst_layout,
                                           graph_layout, held_as_blocks, mesh_arcs, mesh_layout,
                                           scatter_sum, set_flat_sharding)
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.platform import resolve_device
from repro_torch.tree import leaves, map_tree, unflatten

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


def _wide(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 in a float64 evaluation."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _node_layout(layout) -> MeshLayout | None:
    """The destinations' ``MeshLayout`` of a step's ``layout`` on a flat
    mesh (MACE's is a one-chunk list), or None without one."""
    first = layout[0] if isinstance(layout, list) and layout else layout
    return first.dst if isinstance(first, MeshArcs) else None


def _row_sum(x: torch.Tensor, lay: MeshLayout | None) -> torch.Tensor:
    """The sum over all rows of ``x``, whose rows follow ``lay``'s: summed
    over the processes where they are held as row blocks."""
    total = torch.sum(x)
    return compat.psum(total, lay.mesh) if lay is not None and lay.rows_local else total


def _ce_loss(params: dict, cfg: GNNConfig, batch: dict, predict_mask: torch.Tensor,
             layout=None) -> torch.Tensor:
    """Mean node cross-entropy over ``predict_mask``, logits in float32."""
    logits = _wide(node_logits(params, cfg, batch, layout))
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, batch["labels"].long()[:, None])[:, 0]
    m = predict_mask.to(logits.dtype)
    lay = _node_layout(layout)
    return _row_sum((lse - gold) * m, lay) / torch.clamp(_row_sum(m, lay), min=1)


def _energy_loss(params: dict, cfg: GNNConfig, batch: dict, n_graphs: int,
                 layout=None, pool=None) -> torch.Tensor:
    """Mean squared error of the per-graph energies; GraphCast has no energy
    head, so its node embeddings' means are pooled as the reference pools
    them. ``pool`` is ``graph_layout(batch, n_graphs)``, built here when not
    given, or on a flat mesh the graph ids' ``MeshLayout``."""
    mod = model_module(cfg)
    pool = pool if pool is not None else graph_layout(batch, n_graphs)
    if cfg.kind == "graphcast":
        h = mod.node_embeddings(params, cfg, batch, layout=layout)
        e = scatter_sum(h.mean(-1) * batch["node_mask"].to(h.dtype), pool)
    else:
        e = mod.energy(params, cfg, batch, n_graphs, layout=layout, pool=pool)
    sq = (_wide(e) - batch["labels"]) ** 2
    if isinstance(pool, MeshLayout) and pool.rows_local:
        return _row_sum(sq, pool) / n_graphs
    return torch.mean(sq)


def _sum_over_processes(grads, mesh):
    """The parameters' gradients (each process's share) summed over the
    processes in rank order: one ``psum`` of them all, flattened."""
    flat = leaves(grads)
    total = compat.psum(torch.cat([g.reshape(-1) for g in flat]), mesh)
    out, at = [], 0
    for g in flat:
        out.append(total[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return unflatten(grads, out)


def make_train_step(cfg: GNNConfig, shape: ShapeSpec, opt_cfg: AdamWConfig | None = None,
                    mesh=None):
    """``train_step(params, opt_state, batch, layout=None, pool=None) ->
    (params, opt_state, metrics)``: the shape's loss and its gradient, then
    ``adamw_update`` (default ``AdamWConfig(lr=1e-3, weight_decay=0.0)``).
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``. ``layout`` is
    ``edge_layout(cfg, batch)`` and ``pool`` the molecules' graph layout,
    built in the step when not given; on ``mesh`` (a flat mesh) both come
    from ``mesh_layouts`` and the batch from ``stage_batch``."""
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, weight_decay=0.0)
    kind = shape.kind
    world = mesh.world if mesh is not None else 1

    def loss_fn(params, batch, layout, pool):
        if kind == "molecule":
            return _energy_loss(params, cfg, batch, shape.params["batch"], layout, pool)
        mask = batch["node_mask"]
        if kind == "minibatch":
            lay = _node_layout(layout)
            first = lay.first_row if lay is not None else 0
            rows = torch.arange(first, first + mask.shape[0], device=mask.device)
            mask = (rows < shape.params["batch_nodes"]) & mask
        return _ce_loss(params, cfg, batch, mask, layout)

    def train_step(params, opt_state, batch, layout=None, pool=None):
        loss, grads = value_and_grad(loss_fn, params, batch, layout, pool, seed=1.0 / world)
        if world > 1:
            grads = _sum_over_processes(grads, mesh)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


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


def stage_batch(batch: dict, mesh) -> dict:
    """A numpy batch on ``mesh``'s device by ``build_train``'s placements:
    an array of more than 1,024 rows sharded over every shard (each process
    holds its row blocks; on one process the whole array), the others
    whole. A sharded array's rows must divide by the shards, as the
    reference's placement needs; ``n_seeds`` stays an int."""
    D = mesh.size
    out = {}
    for k, v in batch.items():
        if k == "n_seeds":
            out[k] = int(v)
            continue
        v = np.asarray(v)
        if v.ndim and v.shape[0] > BLOCK_ROWS_MIN:
            if v.shape[0] % D:
                raise ValueError(f"{k!r}: {v.shape[0]} rows do not divide over {D} shards")
            if held_as_blocks(v.shape[0], mesh):
                rows = v.shape[0] // mesh.world
                v = v[mesh.rank * rows:(mesh.rank + 1) * rows]
        out[k] = torch.as_tensor(np.ascontiguousarray(v)).to(mesh.device)
    return out


def mesh_layouts(cfg: GNNConfig, shape: ShapeSpec, batch: dict, mesh) -> dict:
    """``{"layout", "pool"}`` of a numpy batch on ``mesh`` for the step and
    the models: its arcs' ``MeshArcs`` (MACE's as a one-chunk list) and, for
    molecules, its graph ids' ``MeshLayout`` (else None). Built from the
    whole ids, once per batch."""
    n = batch["node_mask"].shape[0]
    arcs = mesh_arcs(batch["src"], batch["dst"], n, mesh)
    pool = (mesh_layout(batch["graph_id"], shape.params["batch"], mesh)
            if shape.kind == "molecule" else None)
    return {"layout": [arcs] if cfg.kind == "mace" else arcs, "pool": pool}


def build_train(cfg: GNNConfig, shape: ShapeSpec, mesh):
    """``(train_step, specs, in_sh, out_sh)``: the shape's step, its batch
    specs (``specs["batch"]``) and its parameter shapes (``specs["_params"]``,
    ``blocks`` a list of per-layer dicts). Sets the flat row-sharding context
    (``common.set_flat_sharding``) over every axis of ``mesh``. Without a mesh
    the last two are None; on one, the reference's placements as
    ``NamedSharding``s: ``in_sh = (params, {"m", "v", "count"}, batch)`` and
    ``out_sh = (params, opt state, metrics)``, batch arrays of more than
    1,024 rows on ``P(mesh.axis_names)``, everything else ``P()``."""
    set_flat_sharding(mesh, mesh.axis_names if mesh is not None else None)
    bspecs = batch_specs(cfg, shape)
    d_in = bspecs["feats"][0][1] if "feats" in bspecs else None
    pspec = param_spec(cfg, d_in, n_classes_for(shape))
    pspec["blocks"] = [pspec["blocks"]] * cfg.n_layers
    step = make_train_step(cfg, shape, mesh=mesh)
    specs = {"batch": bspecs, "_params": pspec}
    if mesh is None:
        return step, specs, None, None
    flat, rep = P(tuple(mesh.axis_names)), NamedSharding(mesh, P())
    batch_sh = {k: NamedSharding(mesh, flat) if shp and shp[0] > BLOCK_ROWS_MIN else rep
                for k, (shp, _) in bspecs.items()}
    params_sh = map_tree(lambda _: rep, pspec)
    opt_sh = {"m": params_sh, "v": params_sh, "count": rep}
    return step, specs, (params_sh, opt_sh, batch_sh), (params_sh, opt_sh, rep)


# every assigned GNN shape lowers a train step
build_step = build_train
