"""Train, serve and retrieval steps and synthetic batches for DIN (the port
of ``repro.models.recsys.steps``).

Batches are dicts of int32 tensors keyed as the reference's. ``synth_batch``
makes the same numpy calls in the same order as the reference's, so a seed
gives numpy arrays equal to its, array for array; ``batch_to`` moves them
to a device. The reference's ``param_specs`` and ``build_step`` place the
step on a JAX mesh through ``distribution/sharding.py``; they wait for its
DIN rules on a two-axis mesh (ROADMAP.md Queue A item 12b).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import RecSysConfig, ShapeSpec
from repro_torch.models.recsys import din
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import leaves, map_tree, unflatten


def bce_with_logits(lg: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean of the reference's stable form, max(lg, 0) - lg*y +
    log1p(exp(-|lg|)), in float32 (float64 for float64 logits)."""
    lg = lg.to(torch.promote_types(lg.dtype, torch.float32))
    y = label.to(lg.dtype)
    return torch.mean(torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-lg.abs())))


def make_train_step(cfg: RecSysConfig, opt_cfg: AdamWConfig | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and its gradient by autograd (through the bag kernel's plain
    backward), then ``adamw_update``. ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr``."""
    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, weight_decay=0.0)

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            live = map_tree(lambda p: p.detach().requires_grad_(True), params)
            loss = bce_with_logits(din.logits(live, cfg, batch), batch["label"])
            grads = unflatten(live, torch.autograd.grad(loss, leaves(live)))
        params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: RecSysConfig):
    """``serve_step(params, batch) -> (B,)`` click probabilities."""
    @torch.no_grad()
    def serve_step(params, batch):
        return torch.sigmoid(din.logits(params, cfg, batch))

    return serve_step


def make_retrieval_step(cfg: RecSysConfig, top_k: int = 100):
    """``retrieval_step(params, batch) -> (values, indices)`` of the ``top_k``
    best candidates, best first. ``torch.topk`` breaks exact ties in its own
    order (on the card in no fixed order), ``jax.lax.top_k`` in another."""
    @torch.no_grad()
    def retrieval_step(params, batch):
        return torch.topk(din.retrieval_scores(params, cfg, batch), top_k)

    return retrieval_step


# ---------------------------------------------------------------------- #
# Specs + synthetic batches
# ---------------------------------------------------------------------- #

def batch_specs(cfg: RecSysConfig, shape: ShapeSpec) -> dict:
    """``{key: (shape, dtype)}`` of a batch, in the reference's key order."""
    i32 = torch.int32
    if shape.kind == "retrieval":
        # the reference pads to a 512 multiple so the candidate shard divides its meshes
        N = ((shape.params["n_candidates"] + 511) // 512) * 512
        return {
            "hist_items": ((1, cfg.seq_len), i32),
            "hist_cates": ((1, cfg.seq_len), i32),
            "cand_items": ((N,), i32),
            "cand_cates": ((N,), i32),
        }
    B = shape.params["batch"]
    specs = {
        "hist_items": ((B, cfg.seq_len), i32),
        "hist_cates": ((B, cfg.seq_len), i32),
        "target_item": ((B,), i32),
        "target_cate": ((B,), i32),
        "context_bag": ((B, 16), i32),
    }
    if shape.kind == "train":
        specs["label"] = ((B,), i32)
    return specs


def synth_batch(cfg: RecSysConfig, shape: ShapeSpec, seed: int = 0) -> dict:
    """numpy int32 arrays equal to ``repro.models.recsys.steps.synth_batch``'s
    for the same seed: items Zipf(1.3) clipped at n_items - 1, categories
    and context bags uniform, labels 0/1, and history padded with -1 past a
    length drawn from [L/4, L]."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, _) in batch_specs(cfg, shape).items():
        if k == "label":
            out[k] = rng.integers(0, 2, s).astype(np.int32)
        elif "cate" in k or k == "context_bag":
            out[k] = rng.integers(0, cfg.n_cates, s).astype(np.int32)
        else:
            out[k] = rng.zipf(1.3, s).clip(max=cfg.n_items - 1) \
                .astype(np.int32) if "item" in k else \
                rng.integers(0, cfg.n_items, s).astype(np.int32)
    # mark some history padding (ragged behavior lengths)
    L = cfg.seq_len
    lens = rng.integers(L // 4, L + 1, out["hist_items"].shape[0])
    mask = np.arange(L)[None, :] < lens[:, None]
    out["hist_items"] = np.where(mask, out["hist_items"], -1)
    return out


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as int32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=torch.int32).to(device) for k, v in batch.items()}
