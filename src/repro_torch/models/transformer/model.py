"""Decoder-only transformer (the port of ``repro.models.transformer.model``):
dense GQA/MQA attention with RoPE and optional QKV bias, RMSNorm, SwiGLU or
GELU MLP, tied embeddings; the training passes (``forward_hidden``,
``lm_loss``), prefill and KV-cache decode.

Numbers follow the reference's casts line by line: parameters are float32
and compute is bf16 (``COMPUTE_DTYPE``); RMSNorm and RoPE run in float32 and
cast back; decode scores are cast to float32 before the softmax and the
probabilities back to bf16; logits are a bf16 product cast to float32.
Parameters keep the reference's pytree layout: nested dicts with stacked
``(L, ...)`` leaves under ``"layers"``.

``cast_params`` keeps a bf16 copy of every weight, cast once at load. A
float32 -> bf16 cast rounds the same whether it happens at load or at each
use, so the numbers are those of the reference's cast-at-use, without
re-casting the full-width model's 1.9 GB of float32 weights on every decode
step. Every function here takes either form.

Where the reference leaves attention to XLA, so does the port: decode
attention (one query against the cache) is plain PyTorch on both devices,
and large projections are ``torch.matmul``. Prefill attention calls the
flash-attention kernel through ``kernels.flash_attention.ops`` (the hand-
written CUDA kernel on the card, its plain version on the CPU), where the
reference runs its chunked XLA attention, whose drop-in the Pallas kernel is.

Training runs the reference's chunked attention instead (``train_attention``,
a function of its own that prefill never calls): the flash kernel has no
backward, in the reference or here. Queries go in chunks of 512 (one chunk
when S is not a multiple), KV is expanded to the query heads, the scores are
a bf16 product cast to float32 before the mask and the softmax, and the
probabilities go back to bf16, as in the reference's
``_attention_scores_mha``. Each chunk, each layer (``remat_policy ==
"full"``) and each loss chunk runs under ``torch.utils.checkpoint`` while
grad is enabled, so a (B, H, 512, S) score chunk or a (B, S/8, vocab) logits
chunk is never kept for the backward. The embedding gather's backward, the
scatter-add of the (B*S, d) cotangent into the (V, d) table, is the float
segment-sum kernel (``_EmbedGather``): it adds each row's terms in a fixed
order, so a step and its recomputation, and a run and its restart, give the
same bits.

Left out: MoE and sliding-window attention raise ``NotImplementedError``
naming their ROADMAP.md items; ``ShardingRules``/``constrain`` and
``scan_unroll`` are not ported (one card, a Python loop over the layers).

One deliberate difference: the reference's decode gives the cache slots
past ``pos`` (zeros, not written yet) the position -1, which passes its
causal test, so it attends to them with score 0. The port keeps each slot's
own position, which the causal mask excludes. The two agree exactly when the
cache holds no slot past ``pos`` (ROADMAP.md Queue C).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.segment_sum.ops import segment_layout, segment_sum_float
from repro_torch.platform import resolve_device

COMPUTE_DTYPE = torch.bfloat16

_MOE = "ROADMAP.md Queue A item 17 (MoE)"
_SWA = "ROADMAP.md Queue A item 18 (sliding-window attention and its rolling decode cache)"
_REMAT = "ROADMAP.md Queue A item 13 (the XLA analysis tools; launch/hillclimb.py sets it)"


def check_ported(cfg: LMConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    if cfg.moe:
        raise NotImplementedError(f"{cfg.name}: MoE is not ported yet: {_MOE}")
    if cfg.swa_window is not None:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention is not ported yet: {_SWA}")


# ---------------------------------------------------------------------- #
# Parameters
# ---------------------------------------------------------------------- #

def param_spec(cfg: LMConfig) -> dict:
    """The parameter tree as ``(shape, init)`` leaves, in the reference's key
    layout; ``init`` is ``"normal"`` (std 0.02), ``"normal_out"`` (std
    0.02 / sqrt(2 L), the output projections), ``"zeros"`` or ``"ones"``."""
    check_ported(cfg)
    d, L = cfg.d_model, cfg.n_layers
    hq, hkv, dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    attn = {
        "wq": ((L, d, hq * dh), "normal"),
        "wk": ((L, d, hkv * dh), "normal"),
        "wv": ((L, d, hkv * dh), "normal"),
        "wo": ((L, hq * dh, d), "normal_out"),
    }
    if cfg.qkv_bias:
        attn.update(bq=((L, hq * dh), "zeros"), bk=((L, hkv * dh), "zeros"),
                    bv=((L, hkv * dh), "zeros"))
    mlp = {"w_up": ((L, d, f), "normal"), "w_down": ((L, f, d), "normal_out")}
    if cfg.mlp_type == "swiglu":
        mlp["w_gate"] = ((L, d, f), "normal")
    spec = {
        "embed": ((cfg.vocab, d), "normal"),
        "layers": {"attn": attn, "norm1": ((L, d), "ones"), "norm2": ((L, d), "ones"),
                   "mlp": mlp},
        "norm_f": ((d,), "ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((cfg.vocab, d), "normal")
    return spec


def init_params(cfg: LMConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Parameter tree drawn from a seeded ``torch.Generator`` (stacked
    ``(L, ...)`` leaves). The draws are made on the CPU in a fixed order, so
    one seed gives the same weights whatever ``device`` they go to (the card
    unless ``device="cpu"``). The scales are the reference's; its numbers are
    not (``jax.random`` and ``torch`` draw differently from one seed: carry
    JAX weights across with ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    std = 0.02
    scales = {"normal": std, "normal_out": std / math.sqrt(2 * cfg.n_layers)}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        shape, init = node
        if init == "zeros":
            t = torch.zeros(shape)
        elif init == "ones":
            t = torch.ones(shape)
        else:
            t = torch.randn(shape, generator=gen).mul_(scales[init])
        return t.to(device=dev, dtype=dtype)

    return build(param_spec(cfg))


def cast_params(params: dict, dtype=COMPUTE_DTYPE) -> dict:
    """A copy of ``params`` with every weight in ``dtype`` and the norm
    weights kept float32 (RMSNorm reads them as float32)."""
    return {k: cast_params(v, dtype) if isinstance(v, dict)
            else v if k.startswith("norm") else v.to(dtype)
            for k, v in params.items()}


def params_to(params: dict, device) -> dict:
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def unstack_layers(params: dict, n_layers: int) -> list:
    """The stacked ``params["layers"]`` as one dict of views a layer, from
    ``torch.unbind``: a gradient through them reaches each stacked leaf as
    one ``stack`` of the layers' gradients."""
    out = [{} for _ in range(n_layers)]
    for k, v in params.items():
        for i, part in enumerate(unstack_layers(v, n_layers) if isinstance(v, dict)
                                 else torch.unbind(v, 0)):
            out[i][k] = part
    return out


def _checkpointed(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` while grad is enabled
    (its intermediates are recomputed in the backward instead of kept)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------- #
# Building blocks
# ---------------------------------------------------------------------- #

def rmsnorm(x, w, eps):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _rope(x, pos, theta):
    """x: (B, S, H, Dh), pos: (S,) positions shared across the batch."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos[:, None].float() * freq                      # (S, half)
    cos = torch.cos(ang)[None, :, None, :]                 # (1, S, 1, half)
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention_scores(q, k, v, q_pos, k_pos, window):
    """q: (B, Q, Hkv, rep, Dh), k/v: (B, T, Hkv, Dh); q_pos (Q,), k_pos (T,)
    absolute positions (shared across batch). Returns (B, Q, Hkv, rep, Dh).
    (Grouped layout: the decode path.)"""
    dh = q.shape[-1]
    scores = torch.einsum("bqhrd,bkhd->bhrqk", q, k) / math.sqrt(dh)
    mask = k_pos[None, :] <= q_pos[:, None]                # (Q, T)
    if window is not None:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    scores = torch.where(mask[None, None, None], scores.float(), -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhrqk,bkhd->bqhrd", p, v)


def _qkv(x, p, cfg: LMConfig, pos):
    """The roped projections of x (B, S, d): q (B, S, Hkv, rep, Dh), k and v
    (B, S, Hkv, Dh), in x's dtype."""
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rep = hq // hkv
    cd = x.dtype

    def proj(w, b=None):
        y = torch.matmul(x, w.to(cd))
        if b is not None:
            y = y + b.to(cd)
        return y

    q = proj(p["wq"], p.get("bq")).reshape(B, S, hkv, rep, dh)
    k = proj(p["wk"], p.get("bk")).reshape(B, S, hkv, dh)
    v = proj(p["wv"], p.get("bv")).reshape(B, S, hkv, dh)
    q = _rope(q.reshape(B, S, hq, dh), pos, cfg.rope_theta).reshape(B, S, hkv, rep, dh)
    return q, _rope(k, pos, cfg.rope_theta), v


def _attention_scores_mha(q, k, v, q_pos, k_pos, window):
    """Flat-head layout: q (B, Q, H, Dh), k/v (B, T, H, Dh) with KV expanded
    to the query heads; q_pos (Q,), k_pos (T,). Returns (B, Q, H, Dh). (The
    training path.)"""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    scores = torch.where(mask[None, None], scores.float(), -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def train_attention(x, p, cfg: LMConfig, pos, q_chunk: int = 512):
    """Causal self-attention over x (B, S, d) as the reference's training
    path computes it: queries in chunks of ``q_chunk`` (one chunk when S is
    not a multiple of it), KV expanded to the query heads, each chunk's
    scores (``_attention_scores_mha``) under ``torch.utils.checkpoint``
    while grad is enabled. Returns (B, S, d)."""
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rep = hq // hkv
    q, k, v = _qkv(x, p, cfg, pos)
    qc = min(q_chunk, S)
    n_chunks = S // qc if S % qc == 0 else 1
    if S % qc != 0:
        qc = S
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k      # (B, S, hq, dh)
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    qf = q.reshape(B, S, hq, dh)
    outs = [_checkpointed(_attention_scores_mha, qf[:, c * qc:(c + 1) * qc], kf, vf,
                          pos[c * qc:(c + 1) * qc], pos, cfg.swa_window)
            for c in range(n_chunks)]
    out = torch.cat(outs, dim=1).reshape(B, S, hq * dh)
    return torch.matmul(out, p["wo"].to(x.dtype))


def attention(x, p, cfg: LMConfig, pos, kv_cache=None, cache_pos: int | None = None):
    """Full-sequence (prefill) or single-token (decode) attention.

    x: (B, S, d). pos: (S,) absolute positions (shared across batch).
    kv_cache None: causal self-attention over x through the flash kernel;
    returns ``(out, (k, v))``, the roped k and v ``(B, S, Hkv, Dh)`` for the
    cache (the reference recomputes them in ``prefill``; they are the same
    numbers). Else ``{"k", "v"}`` views ``(B, Hkv, T, Dh)`` of the cache:
    decode against it (S == 1), writing this step's k and v at ``cache_pos``
    in place; returns ``(out, kv_cache)``.
    """
    B, S, _ = x.shape
    hq, dh = cfg.n_heads, cfg.d_head
    cd = x.dtype
    q, k, v = _qkv(x, p, cfg, pos)

    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        ck[:, :, cache_pos:cache_pos + S] = k.to(ck.dtype).transpose(1, 2)
        cv[:, :, cache_pos:cache_pos + S] = v.to(cv.dtype).transpose(1, 2)
        k_pos = torch.arange(ck.shape[2], device=x.device)   # slot t holds position t
        out = _attention_scores(q, ck.transpose(1, 2).to(cd), cv.transpose(1, 2).to(cd),
                                pos, k_pos, cfg.swa_window)
        new = kv_cache
    else:
        out = flash.flash_attention(q.reshape(B, S, hq, dh), k, v, causal=True,
                                    window=cfg.swa_window)
        new = (k, v)

    out = torch.matmul(out.reshape(B, S, hq * dh), p["wo"].to(cd))
    return out, new


def mlp(x, p, cfg: LMConfig):
    cd = x.dtype
    up = torch.matmul(x, p["w_up"].to(cd))
    if cfg.mlp_type == "swiglu":
        gate = torch.matmul(x, p["w_gate"].to(cd))
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return torch.matmul(h, p["w_down"].to(cd))


def _block(x, lp, cfg: LMConfig, attend):
    """A dense block around ``attend(rmsnorm(x)) -> (h, extra)``; returns
    ``(x, extra)``."""
    h, extra = attend(rmsnorm(x, lp["norm1"], cfg.norm_eps))
    x = x + h
    h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + mlp(h2, lp["mlp"], cfg), extra


def layer_fn(x, lp, cfg: LMConfig, pos, kv_cache=None, cache_pos=None):
    """One dense block of the serving passes (prefill on the flash kernel,
    or decode); returns ``(x, cache)`` as ``attention`` returns it (the
    reference's third output, the MoE aux loss, is 0 for a dense block)."""
    check_ported(cfg)
    return _block(x, lp, cfg, lambda h: attention(h, lp["attn"], cfg, pos, kv_cache=kv_cache,
                                                  cache_pos=cache_pos))


def train_layer(x, lp, cfg: LMConfig, pos):
    """One dense block of the training passes, on ``train_attention``."""
    return _block(x, lp, cfg, lambda h: (train_attention(h, lp["attn"], cfg, pos), None))[0]


def logits_from_hidden(params, cfg: LMConfig, h):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, head.to(h.dtype).T)


# ---------------------------------------------------------------------- #
# Training passes
# ---------------------------------------------------------------------- #

class _EmbedGather(torch.autograd.Function):
    """``table[tokens]``, whose backward adds each token's cotangent row into
    its table row on the float segment sum (a ``segment_layout`` of the
    tokens): the kernel on the card, its plain version on the CPU."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        layout = segment_layout(tokens.reshape(-1), ctx.rows)
        return segment_sum_float(grad.reshape(-1, grad.shape[-1]), layout), None


def forward_hidden(params, cfg: LMConfig, tokens, dtype=COMPUTE_DTYPE):
    """tokens (B, S) -> final hidden states (B, S, d) in ``dtype`` and the
    aux loss (0 for a dense model). Each layer runs under
    ``torch.utils.checkpoint`` while grad is enabled (``remat_policy``
    ``"full"``, the configs' default). ``dtype`` is the compute dtype, as in
    ``prefill``."""
    check_ported(cfg)
    if cfg.remat_policy in ("dots", "all_dots"):
        raise NotImplementedError(f"{cfg.name}: remat_policy {cfg.remat_policy!r} is not ported "
                                  f"yet: {_REMAT}")
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    B, S = tokens.shape
    x = _EmbedGather.apply(params["embed"], tokens).to(dtype)
    pos = torch.arange(S, device=x.device)
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x = _checkpointed(train_layer, x, lp, cfg, pos)
    x = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _chunk_loss(h, labels, head):
    """Summed cross-entropy of one chunk: h (B, C, d), labels (B, C)."""
    logits = torch.matmul(h, head.to(h.dtype).T).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).sum()


def lm_loss(params, cfg: LMConfig, tokens, labels, vocab_chunk: int = 8, dtype=COMPUTE_DTYPE):
    """Mean cross-entropy (float32) of ``labels`` (B, S) after ``tokens``
    (B, S), plus 0.01 x the aux loss. Logits are made one sequence chunk at a
    time (``min(vocab_chunk, S)`` chunks, lowered until it divides S), each
    chunk under ``torch.utils.checkpoint`` while grad is enabled, so the
    (B*S, vocab) matrix never exists in full."""
    h, aux = forward_hidden(params, cfg, tokens, dtype)
    B, S, _ = h.shape
    n_chunks = min(vocab_chunk, S)
    while S % n_chunks:
        n_chunks -= 1
    cs = S // n_chunks
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        total = total + _checkpointed(_chunk_loss, h[:, c * cs:(c + 1) * cs],
                                      labels[:, c * cs:(c + 1) * cs], head)
    return total / (B * S) + 0.01 * aux


# ---------------------------------------------------------------------- #
# Serving passes
# ---------------------------------------------------------------------- #

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=COMPUTE_DTYPE,
                  device=None) -> dict:
    """Stacked (L, B, Hkv, T, Dh) zero cache of capacity ``max_len``."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _embed(params, tokens, dtype):
    return F.embedding(tokens, params["embed"]).to(dtype)


def decode_step(params, cfg: LMConfig, token, cache, pos: int, dtype=COMPUTE_DTYPE):
    """One decode step. token (B, 1) int, pos (an int) the position shared by
    the whole batch. Writes this step's k/v into ``cache`` in place (the
    reference returns an updated copy). Returns (logits (B, vocab) float32,
    cache). ``dtype`` is the compute dtype: bf16 as in the reference;
    float32 with float32 parameters evaluates the same weights without
    rounding to bf16, as a yardstick for the bf16 routes."""
    check_ported(cfg)
    pos = int(pos)
    x = _embed(params, token, dtype)
    posb = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        x, _ = layer_fn(x, lp, cfg, posb,
                        kv_cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_pos=pos)
    h = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, h)[:, 0, :]
    return logits.float(), cache


def prefill(params, cfg: LMConfig, tokens, cache: dict | None = None, dtype=COMPUTE_DTYPE):
    """Full-sequence prefill building the KV cache; returns (last-token
    logits (B, vocab) float32, cache).

    Without ``cache`` the cache is new and holds exactly the S prompt
    positions, as the reference's does; with one (capacity >= S, from
    ``init_kv_cache``) the prompt's k/v go into its first S slots in place,
    so a server need not copy them into its serving cache. ``dtype`` is the
    compute dtype, as in ``decode_step``.
    """
    check_ported(cfg)
    B, S = tokens.shape
    x = _embed(params, tokens, dtype)
    pos = torch.arange(S, device=x.device)
    if cache is None:
        cache = init_kv_cache(cfg, B, S, dtype=dtype, device=x.device)
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        x, (k, v) = layer_fn(x, lp, cfg, pos)
        cache["k"][i, :, :, :S] = k.transpose(1, 2)
        cache["v"][i, :, :, :S] = v.transpose(1, 2)
    h = rmsnorm(x[:, -1:, :], params["norm_f"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, h)[:, 0, :]
    return logits.float(), cache
