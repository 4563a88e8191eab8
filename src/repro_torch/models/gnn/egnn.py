"""EGNN [arXiv:2102.09844], the E(n)-equivariant GNN: the port of
``repro.models.gnn.egnn`` (forward only).

Per layer:  m_ij = phi_e(h_i, h_j, |x_i - x_j|^2)
            x_i' = x_i + C * sum_j (x_i - x_j) phi_x(m_ij)
            h_i' = phi_h(h_i, sum_j m_ij)
float32 throughout (float64 for float64 parameters). ``blocks`` is a list of
per-layer dicts, where the reference stacks them along a leading axis.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn.common import (dst_layout, positions_for, graph_layout, layernorm,
                                           mlp_apply, mlp_init, mlp_spec,
                                           scatter_sum)
from repro_torch.platform import resolve_device


def param_spec(cfg: GNNConfig, d_in: int | None = None) -> dict:
    """Shapes of one layer's dict in ``blocks`` and of the other entries."""
    d = cfg.d_hidden
    return {
        "embed_species": (cfg.params["n_species"], d),
        "proj_in": mlp_spec((d_in, d)) if d_in else None,
        "readout": mlp_spec((d, d, 1)),
        "blocks": {"phi_e": mlp_spec((2 * d + 1, d, d)), "phi_x": mlp_spec((d, d, 1)),
                   "phi_h": mlp_spec((2 * d, d, d))},
    }


def init_params(cfg: GNNConfig, seed: int = 0, d_in: int | None = None, device=None) -> dict:
    """float32 weights drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_hidden
    return {
        "embed_species": torch.randn((cfg.params["n_species"], d), generator=gen,
                                     device=dev) * 0.1,
        "proj_in": mlp_init(gen, (d_in, d), device=dev) if d_in else None,
        "readout": mlp_init(gen, (d, d, 1), device=dev),
        "blocks": [{"phi_e": mlp_init(gen, (2 * d + 1, d, d), device=dev),
                    "phi_x": mlp_init(gen, (d, d, 1), device=dev),
                    "phi_h": mlp_init(gen, (2 * d, d, d), device=dev)}
                   for _ in range(cfg.n_layers)],
    }


def node_embeddings(params: dict, cfg: GNNConfig, batch: dict, return_pos: bool = False,
                    layout=None):
    """(N, d_hidden) embeddings, and the updated (N, 3) positions with
    ``return_pos``; ``layout`` is ``dst_layout(batch)``, built here when not
    given."""
    layout = layout if layout is not None else dst_layout(batch)
    h = params["embed_species"].index_select(0, batch["species"])
    if params.get("proj_in") is not None and "feats" in batch:
        h = h + mlp_apply(params["proj_in"], batch["feats"].to(h.dtype))
    x = positions_for(h, batch["positions"]).to(h.dtype)
    src, dst = batch["src"], batch["dst"]
    emask = batch["edge_mask"].to(h.dtype)
    for bp in params["blocks"]:
        rel = x.index_select(0, dst) - x.index_select(0, src)
        d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
        m = mlp_apply(bp["phi_e"], torch.cat(
            [h.index_select(0, dst), h.index_select(0, src), d2], dim=-1), final_act=True)
        m = m * emask[:, None]
        # coordinate update (normalized rel for stability)
        wx = mlp_apply(bp["phi_x"], m)
        xagg = scatter_sum(rel / (torch.sqrt(d2) + 1) * wx, layout)
        x = x + xagg / 8.0
        magg = scatter_sum(m, layout)
        h = h + mlp_apply(bp["phi_h"], torch.cat([h, magg], dim=-1))
        h = layernorm(h)   # stabilizes high-degree (non-molecular) graphs
    return (h, x) if return_pos else h


def energy(params: dict, cfg: GNNConfig, batch: dict, n_graphs: int, layout=None,
           pool=None) -> torch.Tensor:
    """(n_graphs,) energies: atom energies pooled over ``pool``
    (``graph_layout(batch, n_graphs)``, built here when not given)."""
    h = node_embeddings(params, cfg, batch, layout=layout)
    e_atom = mlp_apply(params["readout"], h)[:, 0]
    e_atom = e_atom * batch["node_mask"].to(e_atom.dtype)
    return scatter_sum(e_atom, pool if pool is not None else graph_layout(batch, n_graphs))
