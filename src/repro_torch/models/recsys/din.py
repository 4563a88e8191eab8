"""DIN [arXiv:1706.06978], Deep Interest Network: the port of
``repro.models.recsys.din``.

Target attention over the user behavior sequence: each history item is
scored against the candidate item by an MLP over [h, t, h-t, h*t]; the
softmax of the scores (padding filled with the finite -1e30, so a history
that is all padding gets uniform weights, not NaN) pools the history into a
user-interest vector; it is concatenated with the candidate and the context
bag's sum and mean, and a prediction MLP gives the logit.

The context bag is one launch of the embedding-bag kernel per call of
``logits``: the reference calls its bag twice over the same indices, once
for the sum and once for the mean, and the port derives the mean from the
one sum. Everything else is plain PyTorch, as it is XLA in the reference.

Everything is float32, as the reference is. The port never enables TF32:
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default),
so the card's float32 products keep full precision. A float64 parameter
tree runs in float64 throughout (the yardstick ``chip_smoke.py`` compares
against).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.models.gnn.common import mlp_apply, mlp_init
from repro_torch.models.recsys.embedding_bag import bag_mean_from_sum, bag_sum
from repro_torch.platform import resolve_device
from repro_torch.tree import map_tree

MASKED_SCORE = -1e30


def _sizes(cfg: RecSysConfig) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Layer widths of the attention MLP (input [h, t, h-t, h*t] over the
    item||cate embeddings) and of the prediction MLP (input user, target
    and context bag, each 2D wide)."""
    D = cfg.embed_dim
    return (8 * D, *cfg.attn_mlp, 1), (6 * D, *cfg.mlp, 1)


def param_spec(cfg: RecSysConfig) -> dict:
    """The parameter tree's shapes, in the reference's layout."""
    def mlp(sizes):
        return [{"w": (a, b), "b": (b,)} for a, b in zip(sizes[:-1], sizes[1:])]

    attn, pred = _sizes(cfg)
    return {"item_emb": (cfg.n_items, cfg.embed_dim), "cate_emb": (cfg.n_cates, cfg.embed_dim),
            "attn": mlp(attn), "mlp": mlp(pred)}


def init_params(cfg: RecSysConfig, seed: int = 0, device=None) -> dict:
    """float32 parameters drawn from a ``torch.Generator`` seeded ``seed`` on
    ``device`` (the card unless ``"cpu"``): the tables N(0, 0.01^2), the MLPs
    as ``mlp_init``. A seed gives other numbers on the CPU than on the card,
    and other numbers than ``jax.random`` gives: to compare two routes, move
    one tree (``params_to``), or carry JAX weights across with
    ``convert.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    attn, pred = _sizes(cfg)
    D = cfg.embed_dim
    return {
        "item_emb": torch.randn((cfg.n_items, D), generator=gen, device=dev) * 0.01,
        "cate_emb": torch.randn((cfg.n_cates, D), generator=gen, device=dev) * 0.01,
        "attn": mlp_init(gen, attn, device=dev),
        "mlp": mlp_init(gen, pred, device=dev),
    }


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table`` rows at ``idx`` (any shape, int32 in range) -> idx.shape + (D,)."""
    return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, table.shape[-1])


def _hist_embed(params: dict, hist_items: torch.Tensor, hist_cates: torch.Tensor):
    """(B, L, 2D) item||cate embeddings, zero where ``hist_items`` < 0. The
    gathers read row 0 for padding; ``hist_cates`` is never padded, and its
    values at padded positions are masked through ``hist_items``."""
    e = torch.cat([_take(params["item_emb"], hist_items.clamp(min=0)),
                   _take(params["cate_emb"], hist_cates.clamp(min=0))], dim=-1)
    return e * (hist_items >= 0).unsqueeze(-1).to(e.dtype)


def _attention_scores(layers: list[dict], h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The attention MLP over [h, t, h-t, h*t] -> (B, L). The (B, L, 8D)
    features are the largest tensor of a forward; they are released right
    after the first layer's product (when autograd does not keep them)."""
    tb = t.unsqueeze(1).expand_as(h)
    feat = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    x = mlp_apply(layers[:1], feat, final_act=True)
    del feat
    return mlp_apply(layers[1:], x)[..., 0]


def user_vector(params: dict, cfg: RecSysConfig, hist_items, hist_cates, target_items,
                target_cates):
    """Target attention pooling -> the user vector (B, 2D) and the target (B, 2D)."""
    h = _hist_embed(params, hist_items, hist_cates)                  # (B, L, 2D)
    t = torch.cat([_take(params["item_emb"], target_items),
                   _take(params["cate_emb"], target_cates)], dim=-1)  # (B, 2D)
    score = _attention_scores(params["attn"], h, t)
    score = score.masked_fill(hist_items < 0, MASKED_SCORE)
    w = torch.softmax(score.to(torch.promote_types(score.dtype, torch.float32)), dim=-1)
    return torch.bmm(w.to(h.dtype).unsqueeze(1), h).squeeze(1), t


def logits(params: dict, cfg: RecSysConfig, batch: dict) -> torch.Tensor:
    """batch: hist_items/hist_cates (B, L), target_item/target_cate (B,),
    context_bag (B, L_ctx) multi-hot cate ids -> (B,) logits."""
    u, t = user_vector(params, cfg, batch["hist_items"], batch["hist_cates"],
                       batch["target_item"], batch["target_cate"])
    bag = batch["context_bag"]
    total = bag_sum(params["cate_emb"], bag)            # the one kernel launch
    x = torch.cat([u, t, total, bag_mean_from_sum(total, bag)], dim=-1)
    return mlp_apply(params["mlp"], x)[..., 0]


def retrieval_scores(params: dict, cfg: RecSysConfig, batch: dict) -> torch.Tensor:
    """Score ONE user against N candidate items in one batched pass.
    batch: hist_* (1, L), cand_items (N,), cand_cates (N,) -> (N,). The user
    vector attends with the first candidate as its target, as the
    reference's does; the context bag's place in the MLP input is zeros."""
    u, _ = user_vector(params, cfg, batch["hist_items"], batch["hist_cates"],
                       batch["cand_items"][:1], batch["cand_cates"][:1])
    cand = torch.cat([_take(params["item_emb"], batch["cand_items"]),
                      _take(params["cate_emb"], batch["cand_cates"])], dim=-1)   # (N, 2D)
    ctx = cand.new_zeros(cand.shape)
    x = torch.cat([u.expand_as(cand), cand, ctx], dim=-1)
    return mlp_apply(params["mlp"], x)[..., 0]


def params_to(params: dict, device=None, dtype=None) -> dict:
    """A copy of ``params`` on ``device`` (and in ``dtype``, where given)."""
    return map_tree(lambda p: p.to(device=device, dtype=dtype), params)

