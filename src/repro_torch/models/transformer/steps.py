"""Train, prefill and decode steps of the LM family (the port of
``repro.models.transformer.steps``).

``make_train_step`` is the reference's: the gradient of ``model.lm_loss``
(cross-entropy plus 0.01 x the MoE aux loss; autograd, through the
checkpointed layers, attention and loss chunks, and the embedding gather's
and the MoE dispatch's backward on the float segment sum), accumulated in
float32 over ``cfg.train_microbatches`` and divided by their count, then
``adamw_update`` with global-norm clipping at ``cosine_warmup(count,
warmup=100, total=total_steps)``. ``build_*`` return ``(step_fn, specs,
None, None)`` as the reference does without a mesh; ``specs`` maps each
input to ``(shape, dtype)`` (a windowed model's decode cache capped at the
window). A mesh raises ``NotImplementedError``
(ROADMAP.md Queue A item 12). ``param_shapes`` and ``opt_shapes`` are the
parameter and AdamW-state trees as ``meta`` tensors, for
``launch/dryrun.py``; ``opt_specs``, the state's sharding specs, waits for
the mesh (item 12).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.models.autodiff import value_and_grad
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_warmup
from repro_torch.tree import map_tree

_MESH = "ROADMAP.md Queue A item 12 (distribution/sharding.py)"


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"LM steps on a mesh are not ported yet: {_MESH}")


def param_shapes(cfg: LMConfig) -> dict:
    """The parameter tree as float32 ``meta`` tensors (no allocation), in the
    reference's key layout."""
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return torch.empty(node[0], dtype=torch.float32, device="meta")

    return build(M.param_spec(cfg))


def opt_shapes(cfg: LMConfig) -> dict:
    """The AdamW state of ``param_shapes(cfg)`` as ``meta`` tensors."""
    return adamw_init(param_shapes(cfg))


def make_train_step(cfg: LMConfig, opt_cfg: AdamWConfig | None = None,
                    total_steps: int = 10_000):
    """``train_step(params, opt_state, tokens, labels) -> (params,
    opt_state, metrics)`` with ``metrics`` ``loss``, ``grad_norm`` and
    ``lr``; tokens and labels (B, S) on the parameters' device, B a multiple
    of ``cfg.train_microbatches``."""
    opt_cfg = opt_cfg or AdamWConfig()
    M_ub = max(cfg.train_microbatches, 1)

    def grads_of(params, tokens, labels):
        return value_and_grad(lambda p: M.lm_loss(p, cfg, tokens, labels), params)

    def train_step(params, opt_state, tokens, labels):
        if M_ub == 1:
            loss, grads = grads_of(params, tokens, labels)
        else:
            # gradient accumulation: float32 accumulators, one microbatch's
            # activations at a time
            B, S = tokens.shape
            tok = tokens.reshape(M_ub, B // M_ub, S)
            lab = labels.reshape(M_ub, B // M_ub, S)
            grads = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(M_ub):
                loss_i, g_i = grads_of(params, tok[i], lab[i])
                grads = map_tree(lambda a, g: a + g.to(torch.float32), grads, g_i)
                loss = loss + loss_i
            grads = map_tree(lambda g: g / M_ub, grads)
            loss = loss / M_ub
        lr_scale = cosine_warmup(opt_state["count"], warmup=100, total=total_steps)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def build_train(cfg: LMConfig, shape: ShapeSpec, mesh=None):
    _no_mesh(mesh)
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    specs = {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}
    return make_train_step(cfg), specs, None, None


def build_prefill(cfg: LMConfig, shape: ShapeSpec, mesh=None):
    _no_mesh(mesh)

    def prefill_step(params, tokens):
        return M.prefill(params, cfg, tokens)

    B, S = shape.params["global_batch"], shape.params["seq_len"]
    return prefill_step, {"tokens": ((B, S), torch.int32)}, None, None


def build_decode(cfg: LMConfig, shape: ShapeSpec, mesh=None):
    _no_mesh(mesh)

    def decode_step(params, token, cache, pos):
        return M.decode_step(params, cfg, token, cache, pos)

    B, S = shape.params["global_batch"], shape.params["seq_len"]
    cache = (cfg.n_layers, B, cfg.n_kv_heads, M.cache_len(cfg, S), cfg.d_head)
    specs = {"token": ((B, 1), torch.int32),
             "cache": {"k": (cache, M.COMPUTE_DTYPE), "v": (cache, M.COMPUTE_DTYPE)},
             "pos": ((), torch.int32)}
    return decode_step, specs, None, None


def build_step(cfg: LMConfig, shape: ShapeSpec, mesh=None):
    kind = shape.kind
    if kind == "train":
        return build_train(cfg, shape, mesh)
    if kind == "prefill":
        return build_prefill(cfg, shape, mesh)
    if kind == "decode":
        return build_decode(cfg, shape, mesh)
    raise ValueError(f"unknown LM shape kind {kind}")
