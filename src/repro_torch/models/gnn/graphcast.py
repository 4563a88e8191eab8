"""GraphCast [arXiv:2212.12794], the encoder-processor-decoder mesh GNN: the
port of ``repro.models.gnn.graphcast``.

Two operating modes:

  * ``weather`` — the paper's own typed multigraph: grid nodes (lat x lon,
    n_vars channels) -> encoder (grid2mesh block) -> 16 processor blocks on
    the icosahedral multimesh -> decoder (mesh2grid block) -> per-grid-node
    prediction of the n_vars channels. float32 (float64 for float64
    parameters). A step is 18 segment sums: g2m, one a processor block, m2g.

  * ``generic`` — the assigned graph shapes (full_graph_sm / minibatch_lg /
    ogb_products / molecule) are single untyped graphs: the same
    InteractionBlock processor runs directly on the given edge list
    (encoder/decoder become node MLPs). bf16 activations (``COMPUTE_DTYPE``).

Every block is a GraphNet InteractionBlock (edge MLP -> segment sum -> node
MLP, residual, LayerNorm), the paper's exact block type. The processor is a
plain loop over per-layer dicts, where the reference scans stacked
parameters.

While grad is enabled, each processor block runs under
``torch.utils.checkpoint``: autograd keeps the block's inputs and runs it
again in the backward. The reference checkpoints each generic block; the
port checkpoints the weather processor's blocks too, where the reference
does not: at full ``CONFIG`` one block keeps about 6 GB of float32 edge
activations (327,660 arcs x 512), so 16 of them would not fit one 80 GB
card. A weather training step is then 34 segment sums, 18 in the forward
and 16 again in the recomputed blocks. Recomputing changes no value: the
float segment sum adds in a fixed order. Under ``torch.no_grad`` or
inference mode nothing is checkpointed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn.common import (arc_ids, compute_dtype, constrain_rows, dst_layout,
                                           gather_rows, gather_rows_multi, layernorm, mlp_apply,
                                           mlp_init, mlp_spec, scatter_sum, segment_layout)
from repro_torch.platform import resolve_device


def _block_spec(d: int) -> dict:
    return {"edge_mlp": mlp_spec((3 * d, d, d)), "node_mlp": mlp_spec((2 * d, d, d))}


def _block_init(gen: torch.Generator, d: int, device) -> dict:
    return {"edge_mlp": mlp_init(gen, (3 * d, d, d), device=device),
            "node_mlp": mlp_init(gen, (2 * d, d, d), device=device)}


def _interaction(bp, h_src, h_dst, e, src, dst, layout, emask):
    """One GraphNet block. Returns (new_h_dst, new_e). ``src``/``dst`` are
    ids, or on a flat mesh their ``MeshLayout``s (``common.arc_ids``).
    ``emask`` None means every arc is real (the weather graph), where the
    reference multiplies by ones."""
    if h_src is h_dst:
        # generic mode: one broadcast serves both ends
        hs, hd = gather_rows_multi(h_src, (src, dst))
    else:
        hs, hd = gather_rows(h_src, src), gather_rows(h_dst, dst)
    eh = torch.cat([e, hs, hd], dim=-1)
    del hs, hd
    e_new = e + mlp_apply(bp["edge_mlp"], eh)
    del eh
    if emask is not None:
        e_new = e_new * emask[:, None]
    e_new = constrain_rows(e_new)
    agg = constrain_rows(scatter_sum(e_new, layout))
    h_new = h_dst + mlp_apply(bp["node_mlp"], torch.cat([h_dst, agg], dim=-1))
    e_out = layernorm(e_new)
    return constrain_rows(layernorm(h_new)), \
        constrain_rows(e_out if emask is None else e_out * emask[:, None])


def _processor_block(fn, *args):
    """``fn(*args)``, checkpointed while grad is enabled (the module's
    docstring says why). A block draws no random numbers, so no RNG state
    is kept for the recompute."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------- #
# Generic mode (assigned shapes)
# ---------------------------------------------------------------------- #

def param_spec(cfg: GNNConfig, d_in: int | None = None) -> dict:
    """Shapes of one layer's dict in ``blocks`` and of the other entries."""
    d = cfg.d_hidden
    return {"encode": mlp_spec((d_in or d, d, d)), "edge_embed": (1, d),
            "blocks": _block_spec(d), "decode": mlp_spec((d, d, d))}


def init_params(cfg: GNNConfig, seed: int = 0, d_in: int | None = None, device=None) -> dict:
    """float32 weights drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the card unless ``"cpu"``); a zero edge embedding."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_hidden
    return {
        "encode": mlp_init(gen, (d_in or d, d, d), device=dev),
        "edge_embed": torch.zeros((1, d), device=dev),    # learned constant edge init
        "blocks": [_block_init(gen, d, dev) for _ in range(cfg.n_layers)],
        "decode": mlp_init(gen, (d, d, d), device=dev),
    }


def node_embeddings(params: dict, cfg: GNNConfig, batch: dict, layout=None) -> torch.Tensor:
    """(N, d_hidden) in bf16 (float64 for float64 parameters); ``layout`` is
    ``dst_layout(batch)``, built here when not given, or on a flat mesh the
    batch's ``MeshArcs``."""
    cd = compute_dtype(params["edge_embed"])
    layout = layout if layout is not None else dst_layout(batch)
    feats = batch.get("feats")
    if feats is None:
        # one-hot by comparison: F.one_hot runs other ops on each device
        feats = batch["species"].long()[:, None] == torch.arange(cfg.d_hidden,
                                                                  device=batch["species"].device)
    h = mlp_apply(params["encode"], feats.to(cd))
    src, dst = arc_ids(batch, layout)
    e = params["edge_embed"].to(cd).expand(batch["src"].shape[0], cfg.d_hidden)
    emask = batch["edge_mask"].to(h.dtype)
    for bp in params["blocks"]:
        h, e = _processor_block(
            lambda h_, e_, bp_: _interaction(bp_, h_, h_, e_, src, dst, layout, emask), h, e, bp)
    return mlp_apply(params["decode"], h)


# ---------------------------------------------------------------------- #
# Weather mode (the paper's own config)
# ---------------------------------------------------------------------- #

def make_weather_graph(cfg: GNNConfig, seed: int = 0) -> dict:
    """Host-side synthetic multimesh wiring with the configured sizes (equal
    to the reference's for the same seed).

    Mesh connectivity is generated as a deterministic random regular-ish
    graph of the configured edge count (the real icosahedral multimesh is a
    constant that would ship as data; its sizes are what matter for
    performance work)."""
    p = cfg.params
    rng = np.random.default_rng(seed)
    n_grid = p["grid_lat"] * p["grid_lon"]
    n_mesh = p["mesh_nodes"]
    g2m = rng.integers(0, [[n_grid], [n_mesh]],
                       size=(2, p["grid2mesh_edges"]))
    mm = rng.integers(0, n_mesh, size=(2, p["mesh_edges"]))
    m2g = rng.integers(0, [[n_mesh], [n_grid]],
                       size=(2, p["mesh2grid_edges"]))
    return {
        "g2m_src": g2m[0].astype(np.int32), "g2m_dst": g2m[1].astype(np.int32),
        "mm_src": mm[0].astype(np.int32), "mm_dst": mm[1].astype(np.int32),
        "m2g_src": m2g[0].astype(np.int32), "m2g_dst": m2g[1].astype(np.int32),
    }


def weather_layouts(cfg: GNNConfig, graph: dict) -> dict:
    """The three destination layouts of a weather graph (tensors on one
    device), built once and reused by every step."""
    p = cfg.params
    n_grid, n_mesh = p["grid_lat"] * p["grid_lon"], p["mesh_nodes"]
    return {"g2m": segment_layout(graph["g2m_dst"], n_mesh),
            "mm": segment_layout(graph["mm_dst"], n_mesh),
            "m2g": segment_layout(graph["m2g_dst"], n_grid)}


def weather_param_spec(cfg: GNNConfig) -> dict:
    d, p = cfg.d_hidden, cfg.params
    return {"grid_encode": mlp_spec((p["n_vars"], d, d)), "mesh_embed": (1, d),
            "g2m": _block_spec(d), "blocks": _block_spec(d), "m2g": _block_spec(d),
            "grid_decode": mlp_spec((d, d, p["n_vars"]))}


def init_weather_params(cfg: GNNConfig, seed: int = 0, device=None) -> dict:
    """float32 weights drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the card unless ``"cpu"``); a zero mesh embedding."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, p = cfg.d_hidden, cfg.params
    return {
        "grid_encode": mlp_init(gen, (p["n_vars"], d, d), device=dev),
        "mesh_embed": torch.zeros((1, d), device=dev),
        "g2m": _block_init(gen, d, dev),
        "blocks": [_block_init(gen, d, dev) for _ in range(cfg.n_layers)],
        "m2g": _block_init(gen, d, dev),
        "grid_decode": mlp_init(gen, (d, d, p["n_vars"]), device=dev),
    }


def weather_forward(params: dict, cfg: GNNConfig, grid_state: torch.Tensor, graph: dict,
                    layouts: dict | None = None) -> torch.Tensor:
    """grid_state: (n_grid, n_vars) -> next-state prediction (residual).
    ``layouts`` is ``weather_layouts(cfg, graph)``, built here when not given."""
    layouts = layouts if layouts is not None else weather_layouts(cfg, graph)
    d = cfg.d_hidden
    n_mesh = cfg.params["mesh_nodes"]
    dt = params["mesh_embed"].dtype
    hg = mlp_apply(params["grid_encode"], grid_state.to(dt))
    hm = params["mesh_embed"].expand(n_mesh, d)

    def zeros(key):
        return hg.new_zeros((graph[key].shape[0], d))

    # encoder: grid -> mesh
    hm, _ = _interaction(params["g2m"], hg, hm, zeros("g2m_src"), graph["g2m_src"],
                         graph["g2m_dst"], layouts["g2m"], None)
    # processor on the multimesh
    em = zeros("mm_src")
    for bp in params["blocks"]:
        hm, em = _processor_block(
            lambda h_, e_, bp_: _interaction(bp_, h_, h_, e_, graph["mm_src"], graph["mm_dst"],
                                             layouts["mm"], None), hm, em, bp)
    del em
    # decoder: mesh -> grid
    hg2, _ = _interaction(params["m2g"], hm, hg, zeros("m2g_src"), graph["m2g_src"],
                          graph["m2g_dst"], layouts["m2g"], None)
    delta = mlp_apply(params["grid_decode"], hg2)
    return grid_state + delta
