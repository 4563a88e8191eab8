"""SchNet [arXiv:1706.08566], continuous-filter convolutions: the port of
``repro.models.gnn.schnet``.

Interaction block: h_j --(atomwise)--> x_j; filter W(r_ij) = MLP(rbf(r_ij));
message = x_j * W(r_ij); aggregate (segment sum); atomwise MLP; residual.
float32 throughout (float64 for float64 parameters). ``blocks`` is a list of
per-layer dicts, where the reference stacks them along a leading axis.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn.common import (arc_ids, dst_layout, gather_rows, gather_rows_multi,
                                           gaussian_rbf, graph_layout, mlp_apply, mlp_init,
                                           mlp_spec, positions_for, scatter_sum)
from repro_torch.platform import resolve_device


def param_spec(cfg: GNNConfig, d_in: int | None = None) -> dict:
    """Shapes of one layer's dict in ``blocks`` and of the other entries."""
    d, p = cfg.d_hidden, cfg.params
    return {
        "embed_species": (p["n_species"], d),
        "proj_in": mlp_spec((d_in, d)) if d_in else None,
        "blocks": {"filter": mlp_spec((p["n_rbf"], d, d)), "in2f": mlp_spec((d, d)),
                   "out": mlp_spec((d, d, d))},
        "readout": mlp_spec((d, d // 2, 1)),
    }


def init_params(cfg: GNNConfig, seed: int = 0, d_in: int | None = None, device=None) -> dict:
    """float32 weights drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the card unless ``"cpu"``): the species table N(0, 0.1^2),
    the MLPs as ``mlp_init``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, p = cfg.d_hidden, cfg.params
    return {
        "embed_species": torch.randn((p["n_species"], d), generator=gen, device=dev) * 0.1,
        "proj_in": mlp_init(gen, (d_in, d), device=dev) if d_in else None,
        "blocks": [{"filter": mlp_init(gen, (p["n_rbf"], d, d), device=dev),
                    "in2f": mlp_init(gen, (d, d), device=dev),
                    "out": mlp_init(gen, (d, d, d), device=dev)} for _ in range(cfg.n_layers)],
        "readout": mlp_init(gen, (d, d // 2, 1), device=dev),
    }


def node_embeddings(params: dict, cfg: GNNConfig, batch: dict, layout=None) -> torch.Tensor:
    """(N, d_hidden) embeddings; ``layout`` is ``dst_layout(batch)``, built
    here when not given, or on a flat mesh the batch's ``MeshArcs``."""
    p = cfg.params
    layout = layout if layout is not None else dst_layout(batch)
    src, dst = arc_ids(batch, layout)
    h = params["embed_species"].index_select(0, batch["species"])
    if params.get("proj_in") is not None and "feats" in batch:
        h = h + mlp_apply(params["proj_in"], batch["feats"].to(h.dtype))
    pos_dst, pos_src = gather_rows_multi(positions_for(h, batch["positions"]), (dst, src))
    rel = pos_dst - pos_src
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    rbf = gaussian_rbf(dist, p["n_rbf"], p["cutoff"]).to(h.dtype)
    emask = batch["edge_mask"][:, None].to(h.dtype)
    for bp in params["blocks"]:
        x = mlp_apply(bp["in2f"], h)
        w = mlp_apply(bp["filter"], rbf) * emask
        msg = gather_rows(x, src) * w
        h = h + mlp_apply(bp["out"], scatter_sum(msg, layout))
    return h


def energy(params: dict, cfg: GNNConfig, batch: dict, n_graphs: int, layout=None,
           pool=None) -> torch.Tensor:
    """(n_graphs,) energies: atom energies pooled over ``pool``
    (``graph_layout(batch, n_graphs)``, built here when not given)."""
    h = node_embeddings(params, cfg, batch, layout)
    e_atom = mlp_apply(params["readout"], h)[:, 0]
    e_atom = e_atom * batch["node_mask"].to(e_atom.dtype)
    return scatter_sum(e_atom, pool if pool is not None else graph_layout(batch, n_graphs))
