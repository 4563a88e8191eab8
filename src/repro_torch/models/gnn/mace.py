"""MACE [arXiv:2206.07697], higher-order E(3)-equivariant message passing:
the port of ``repro.models.gnn.mace`` (forward only).

l=0/1/2 features are carried as (scalars, vectors, symmetric-traceless
matrices) per channel and all products use closed-form equivariant bilinear
maps (dot, outer-sym, matvec, trace), as in the reference.

Per MACE layer:
  A-features (one-particle basis): A_l(u) = sum_edges R_l(r) Y_l(r_hat) (W h_v)
  B-features (correlation order 3): products A (x) A (x) A contracted back to
  l <= 2 via the bilinear maps; update = linear(B) + residual.

Activations are bf16 (``COMPUTE_DTYPE``; float64 for float64 parameters).
The A-features are accumulated over edge chunks exactly as the reference
chunks them (above 2,000,000 arcs, 512-aligned chunks): each chunk's three
segment sums are added into bf16 accumulators, two roundings as in the
reference. The B-features' contractions are taken in float32 and rounded
once, as XLA takes a bf16 contraction.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn.common import (compute_dtype, bessel_rbf, positions_for,
                                           graph_layout, mlp_apply, mlp_init, mlp_spec,
                                           scatter_sum, segment_layout)
from repro_torch.platform import resolve_device

CHUNK_ARCS = 2_000_000     # the reference's single-device chunking threshold
INVARIANT_ROWS = 1 << 18   # nodes a pass of the B-features takes


def _sym_traceless(m: torch.Tensor) -> torch.Tensor:
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * torch.eye(3, dtype=m.dtype, device=m.device) / 3.0


def param_spec(cfg: GNNConfig, d_in: int | None = None) -> dict:
    """Shapes of one layer's dict in ``blocks`` and of the other entries."""
    C, p = cfg.d_hidden, cfg.params
    return {
        "embed_species": (p["n_species"], C),
        "proj_in": mlp_spec((d_in, C)) if d_in else None,
        "blocks": {"radial": mlp_spec((p["n_rbf"], C, 3 * C)), "w_h": (C, C),
                   "w_b": (8 * C, C), "update": mlp_spec((2 * C, C, C))},
        "readout": mlp_spec((C, C, 1)),
    }


def init_params(cfg: GNNConfig, seed: int = 0, d_in: int | None = None, device=None) -> dict:
    """float32 weights drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    C, p = cfg.d_hidden, cfg.params

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return {
        "embed_species": normal((p["n_species"], C), 0.1),
        "proj_in": mlp_init(gen, (d_in, C), device=dev) if d_in else None,
        "blocks": [{
            # radial MLP: n_rbf -> weights for each of the 3 l-channels
            "radial": mlp_init(gen, (p["n_rbf"], C, 3 * C), device=dev),
            "w_h": normal((C, C), 1 / math.sqrt(C)),
            # linear mix of the 8C ACE invariants back into C channels
            "w_b": normal((8 * C, C), 1 / math.sqrt(8 * C)),
            "update": mlp_init(gen, (2 * C, C, C), device=dev),
        } for _ in range(cfg.n_layers)],
        "readout": mlp_init(gen, (C, C, 1), device=dev),
    }


def n_chunks_for(E: int) -> int:
    """The reference's edge chunking on one device: halve the chunks until
    each holds at most 2,000,000 arcs, then back off until E divides into
    512-aligned chunks (an unpadded E falls back to one chunk)."""
    n_chunks = 1
    while E // n_chunks > CHUNK_ARCS:
        n_chunks *= 2
    while n_chunks > 1 and (E % n_chunks or (E // n_chunks) % 512):
        n_chunks //= 2
    return n_chunks


def edge_layouts(batch: dict) -> list:
    """One destination layout per edge chunk, built once and used by every
    layer."""
    dst, n = batch["dst"], batch["species"].shape[0]
    n_chunks = n_chunks_for(dst.shape[0])
    Ec = dst.shape[0] // n_chunks
    return [segment_layout(dst[i * Ec:(i + 1) * Ec], n) for i in range(n_chunks)]


def _invariants(a0, a1, a2) -> torch.Tensor:
    """The 8C channel-diagonal ACE invariants (correlation <= 3), in float32
    over blocks of nodes, rounded once to a0's dtype."""
    n, C = a0.shape
    wide = torch.float64 if a0.dtype == torch.float64 else torch.float32
    b = torch.empty((n, 8 * C), dtype=a0.dtype, device=a0.device)
    for s in range(0, n, INVARIANT_ROWS):
        x0, x1, x2 = (a[s:s + INVARIANT_ROWS].to(wide) for a in (a0, a1, a2))
        dot11 = (x1 * x1).sum(-1)                                    # A1.A1
        tr22 = (x2 * x2).sum((-2, -1))                               # tr(A2 A2)
        quad = (x1[..., :, None] * x2 * x1[..., None, :]).sum((-2, -1))   # A1' A2 A1
        sq = sum(x2[..., :, j, None] * x2[..., None, j, :] for j in range(3))  # A2 A2
        tr222 = (sq * x2.transpose(-1, -2)).sum((-2, -1))            # tr(A2^3)
        b[s:s + INVARIANT_ROWS] = torch.cat(
            [x0, x0 * x0, dot11, tr22,               # order 1-2
             quad, tr222, x0 * dot11, x0 * tr22],    # order 3
            dim=-1).to(a0.dtype)
    return b


def node_embeddings(params: dict, cfg: GNNConfig, batch: dict, layout=None) -> torch.Tensor:
    """(N, C) in bf16 (float64 for float64 parameters); ``layout`` is
    ``edge_layouts(batch)``, one per chunk, built here when not given."""
    p = cfg.params
    n = batch["species"].shape[0]
    cd = compute_dtype(params["embed_species"])
    layouts = layout if layout is not None else edge_layouts(batch)
    h = params["embed_species"].index_select(0, batch["species"]).to(cd)
    if params.get("proj_in") is not None and "feats" in batch:
        h = h + mlp_apply(params["proj_in"], batch["feats"].to(h.dtype))

    src, dst = batch["src"], batch["dst"]
    pos = positions_for(h, batch["positions"])
    rel = pos.index_select(0, dst) - pos.index_select(0, src)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    rhat = rel / dist[:, None]
    del rel
    # l=0,1,2 "spherical harmonics" in tensor form
    y1 = rhat.to(cd)                                              # (E, 3)
    y2 = _sym_traceless(rhat[:, :, None] * rhat[:, None, :]).to(cd)   # (E, 3, 3)
    del rhat
    rbf = bessel_rbf(dist, p["n_rbf"], p["cutoff"])
    del dist
    emask = batch["edge_mask"].to(h.dtype)
    Ec = src.shape[0] // len(layouts)

    for bp in params["blocks"]:
        hw = h @ bp["w_h"].to(h.dtype)                            # (n, C)
        C = h.shape[1]
        a0 = h.new_zeros((n, C))
        a1 = h.new_zeros((n, C, 3))
        a2 = h.new_zeros((n, C, 3, 3))
        for i, lay in enumerate(layouts):
            sl = slice(i * Ec, (i + 1) * Ec)
            radial = mlp_apply(bp["radial"], rbf[sl].to(h.dtype)) * emask[sl][:, None]
            r0, r1, r2 = radial.split(C, dim=-1)
            hsrc = hw.index_select(0, src[sl])                    # (Ec, C)
            a0 += scatter_sum(r0 * hsrc, lay)
            a1 += scatter_sum((r1 * hsrc)[:, :, None] * y1[sl][:, None, :], lay)
            a2 += scatter_sum((r2 * hsrc)[:, :, None, None] * y2[sl][:, None, :, :], lay)
            del radial, r0, r1, r2, hsrc
        feats = _invariants(a0, a1, a2) @ bp["w_b"].to(h.dtype)     # (n, 8C) @ (8C, C)
        del a0, a1, a2
        h = h + mlp_apply(bp["update"], torch.cat([h, feats], dim=-1))
    return h


def energy(params: dict, cfg: GNNConfig, batch: dict, n_graphs: int, layout=None,
           pool=None) -> torch.Tensor:
    """(n_graphs,) energies: atom energies pooled over ``pool``
    (``graph_layout(batch, n_graphs)``, built here when not given)."""
    h = node_embeddings(params, cfg, batch, layout)
    e_atom = mlp_apply(params["readout"], h)[:, 0]
    e_atom = e_atom * batch["node_mask"].to(e_atom.dtype)
    return scatter_sum(e_atom, pool if pool is not None else graph_layout(batch, n_graphs))
