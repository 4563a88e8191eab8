"""Config system of the port: architecture configs + input-shape specs (a copy
of ``repro.configs.base``, which is data; the port keeps its own copy).

Every assigned architecture is a frozen dataclass instance in its own
``configs/<id>.py`` file; the registry maps ``--arch <id>`` strings to
(config, shape-set, smoke-config) triples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


# ---------------------------------------------------------------------- #
# LM family
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared experts (DeepSeek/Qwen-MoE style)
    capacity_factor: float = 1.25
    # Mesh-divisibility transforms (both EXACT math, see models/transformer):
    #   virtual_split: each expert becomes `split` half-width experts whose
    #     contributions sum in the combine einsum (SwiGLU splits along d_ff).
    #   pad_experts_to: dummy experts whose router logits are -inf.
    virtual_split: int = 1
    pad_experts_to: int | None = None

    @property
    def e_pad(self) -> int:
        return self.pad_experts_to or self.n_experts

    @property
    def e_eff(self) -> int:
        return self.e_pad * self.virtual_split

    @property
    def f_eff(self) -> int:
        assert self.d_ff_expert % self.virtual_split == 0
        return self.d_ff_expert // self.virtual_split


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense FFN width (MoE: shared-path width)
    vocab: int
    d_head: int = 128
    moe: MoEConfig | None = None
    swa_window: int | None = None  # sliding-window attention (Mixtral)
    qkv_bias: bool = False         # Qwen1.5 style
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_type: str = "swiglu"       # "swiglu" (3 matmuls) | "gelu" (2 matmuls)
    train_microbatches: int = 1    # gradient-accumulation steps per batch
    remat_policy: str = "full"     # "full" | "dots" (selective: save
                                   # non-batch matmul outputs, skip fwd
                                   # recompute of the big GEMMs)
    family: str = "lm"

    @property
    def _ff_mats(self) -> int:
        return 3 if self.mlp_type == "swiglu" else 2

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.n_heads * self.d_head * 2 + \
            d * self.n_kv_heads * self.d_head * 2
        if self.moe:
            ff = self._ff_mats * d * self.moe.d_ff_expert * self.moe.n_experts \
                + d * self.moe.n_experts  # router
            if self.moe.n_shared:
                ff += self._ff_mats * d * self.moe.d_ff_expert * \
                    self.moe.n_shared + d
        else:
            ff = self._ff_mats * d * f
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff + 2 * d) + emb + d

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.n_params
        d, L, V = self.d_model, self.n_layers, self.vocab
        attn = d * self.n_heads * self.d_head * 2 + \
            d * self.n_kv_heads * self.d_head * 2
        ff = self._ff_mats * d * self.moe.d_ff_expert * \
            (self.moe.top_k + self.moe.n_shared)
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ff + 2 * d) + emb + d


# ---------------------------------------------------------------------- #
# GNN family
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                      # "mace" | "graphcast" | "schnet" | "egnn"
    n_layers: int
    d_hidden: int
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    family: str = "gnn"


# ---------------------------------------------------------------------- #
# RecSys family
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    embed_dim: int
    seq_len: int
    attn_mlp: tuple[int, ...]
    mlp: tuple[int, ...]
    n_items: int
    n_cates: int
    family: str = "recsys"


# ---------------------------------------------------------------------- #
# Shapes
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | full_graph | minibatch |
                       # molecule | serve | retrieval
    params: Mapping[str, Any]


LM_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
               "n_classes": 7}),
    ShapeSpec("minibatch_lg", "minibatch",
              {"n_nodes": 232_965, "n_edges": 114_615_892,
               "batch_nodes": 1024, "fanout": (15, 10), "d_feat": 602,
               "n_classes": 41}),
    ShapeSpec("ogb_products", "full_graph",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
               "n_classes": 47}),
    ShapeSpec("molecule", "molecule",
              {"n_nodes": 30, "n_edges": 64, "batch": 128}),
)

RECSYS_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)


def shapes_for(cfg) -> tuple[ShapeSpec, ...]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[cfg.family]
