"""Decoder-only transformer (the port of ``repro.models.transformer.model``):
GQA/MQA attention with RoPE and optional QKV bias, RMSNorm, SwiGLU or GELU
MLP, top-k capacity-dispatch MoE with padded, virtual-split and shared
experts, sliding-window attention with a rolling decode cache, tied
embeddings; the training passes (``forward_hidden``, ``lm_loss``), prefill
and KV-cache decode.

Numbers follow the reference's casts line by line: parameters are float32
and compute is bf16 (``COMPUTE_DTYPE``); RMSNorm, RoPE and the router run in
float32 and cast back; decode scores are cast to float32 before the softmax
and the probabilities back to bf16; logits are a bf16 product cast to
float32. Parameters keep the reference's pytree layout: nested dicts with
stacked ``(L, ...)`` leaves under ``"layers"``.

``cast_params`` keeps a bf16 copy of every weight, cast once at load, but
the norm weights and the router, which the reference reads as float32. A
float32 -> bf16 cast rounds the same whether it happens at load or at each
use, so the numbers are those of the reference's cast-at-use, without
re-casting the weights on every decode step. Every function here takes
either form.

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
``_attention_scores_mha``; with a window and S > 2 x window each chunk sees
only the keys its window can reach, as in the reference. Each chunk, each
layer (``remat_policy == "full"``) and each loss chunk runs under
``torch.utils.checkpoint`` while grad is enabled, so a (B, H, 512, S) score
chunk or a (B, S/8, vocab) logits chunk is never kept for the backward. The
embedding gather's backward, the scatter-add of the (B*S, d) cotangent into
the (V, d) table, is the float segment-sum kernel (``_EmbedGather``): it
adds each row's terms in a fixed order, so a step and its recomputation,
and a run and its restart, give the same bits.

MoE (``moe_block``) keeps the reference's rules (router, top-k, slot order,
capacity, virtual split, aux loss) but not its GSPMD mapping: the reference
dispatches and combines through one-hot einsums, which GSPMD shards; on one
card an index dispatch computes the same numbers without the (B, S, E, C)
one-hot tensors. The dispatch is a gather of token rows into expert slots
(``_SlotGather``), whose backward adds each token's slot rows on the float
segment-sum kernel, in a fixed order as the embedding's does. The combine
sums each token's K x virtual_split bf16 products ``gate * y`` in float32
and rounds once, as the reference's bf16 einsum does. The pad experts'
slots, which the router never fills, are not computed.

Left out: ``ShardingRules``/``constrain`` and ``scan_unroll`` (one card, a
Python loop over the layers).

Two deliberate differences in decode (ROADMAP.md Queue C, caveats 4 and
8). The reference gives the cache slots that hold no position yet (zeros)
the position -1, which passes its causal and window tests, so it attends to
them with score 0; the port masks them. And with a window, the reference's
``launch/serve.py`` places prefill's last window at a slot offset that the
rolling decode reads correctly only when the prompt length is a multiple of
the window; the port writes every position at slot ``position % T``, the
rule decode reads by. The two agree exactly when the cache holds no
unwritten slot and, with a window, when P <= window or P % window == 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.segment_sum.ops import SegmentLayout, segment_layout, segment_sum_float
from repro_torch.platform import resolve_device

COMPUTE_DTYPE = torch.bfloat16

_REMAT = "ROADMAP.md Queue A item 13 (the XLA analysis tools; launch/hillclimb.py sets it)"


# ---------------------------------------------------------------------- #
# Parameters
# ---------------------------------------------------------------------- #

def param_spec(cfg: LMConfig) -> dict:
    """The parameter tree as ``(shape, init)`` leaves, in the reference's key
    layout; ``init`` is ``"normal"`` (std 0.02), ``"normal_out"`` (std
    0.02 / sqrt(2 L), the output projections), ``"zeros"`` or ``"ones"``.
    An MoE config has ``layers["moe"]`` (``router`` over the padded experts,
    the ``e_eff`` experts of width ``f_eff`` and, with shared experts,
    ``shared``) in place of ``layers["mlp"]``."""
    d, L = cfg.d_model, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = {
        "wq": ((L, d, hq * dh), "normal"),
        "wk": ((L, d, hkv * dh), "normal"),
        "wv": ((L, d, hkv * dh), "normal"),
        "wo": ((L, hq * dh, d), "normal_out"),
    }
    if cfg.qkv_bias:
        attn.update(bq=((L, hq * dh), "zeros"), bk=((L, hkv * dh), "zeros"),
                    bv=((L, hkv * dh), "zeros"))

    def ffn(width, experts=()):
        out = {"w_up": ((L, *experts, d, width), "normal"),
               "w_down": ((L, *experts, width, d), "normal_out")}
        if cfg.mlp_type == "swiglu":
            out["w_gate"] = ((L, *experts, d, width), "normal")
        return out

    layers = {"attn": attn, "norm1": ((L, d), "ones"), "norm2": ((L, d), "ones")}
    if cfg.moe:
        moe = {"router": ((L, d, cfg.moe.e_pad), "normal"),
               **ffn(cfg.moe.f_eff, (cfg.moe.e_eff,))}
        if cfg.moe.n_shared:
            moe["shared"] = ffn(cfg.moe.n_shared * cfg.moe.f_eff)
        layers["moe"] = moe
    else:
        layers["mlp"] = ffn(cfg.d_ff)
    spec = {"embed": ((cfg.vocab, d), "normal"), "layers": layers, "norm_f": ((d,), "ones")}
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((cfg.vocab, d), "normal")
    return spec


def param_numel(cfg: LMConfig) -> int:
    """The number of weights in ``param_spec(cfg)``."""
    def count(node):
        return (sum(count(v) for v in node.values()) if isinstance(node, dict)
                else math.prod(node[0]))
    return count(param_spec(cfg))


def _keeps_f32(key: str) -> bool:
    """The leaves the reference reads as float32 whatever the compute dtype:
    the norm weights (RMSNorm) and the router."""
    return key.startswith("norm") or key == "router"


def init_params(cfg: LMConfig, seed: int = 0, dtype=torch.float32, device=None,
                on_device: bool = False) -> dict:
    """Parameter tree drawn from a seeded ``torch.Generator`` (stacked
    ``(L, ...)`` leaves). The scales are the reference's; its numbers are
    not (``jax.random`` and ``torch`` draw differently from one seed: carry
    JAX weights across with ``convert.params_from_jax``).

    By default the draws are made on the CPU in a fixed order, so one seed
    gives the same weights whatever ``device`` they go to (the card unless
    ``device="cpu"``). ``on_device=True`` draws on ``device`` itself from a
    generator there, one layer of a stacked leaf at a time, each draw in
    float32 and stored in ``dtype`` but the norm weights and the router,
    which stay float32 (``cast_params``'s form): a full-width MoE model's
    bf16 weights are made on the card without its float32 copy ever
    existing (qwen2-moe-a2.7b: 30.3 GB in bf16, 60.6 GB in float32). The
    two draws give different numbers from one seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if on_device else "cpu").manual_seed(seed)
    std = 0.02
    scales = {"normal": std, "normal_out": std / math.sqrt(2 * cfg.n_layers)}

    def draw(shape, init):
        if on_device:
            return torch.randn(shape, generator=gen, device=dev).mul_(scales[init])
        return torch.randn(shape, generator=gen).mul_(scales[init])

    def build(node, key="", stacked=False):
        if isinstance(node, dict):
            return {k: build(v, k, stacked or k == "layers") for k, v in node.items()}
        shape, init = node
        if not on_device:
            t = (torch.zeros(shape) if init == "zeros" else torch.ones(shape) if init == "ones"
                 else draw(shape, init))
            return t.to(device=dev, dtype=dtype)
        out_dtype = torch.float32 if _keeps_f32(key) else dtype
        if init in ("zeros", "ones"):
            return (torch.zeros if init == "zeros" else torch.ones)(shape, dtype=out_dtype,
                                                                    device=dev)
        if not stacked:
            return draw(shape, init).to(out_dtype)
        t = torch.empty(shape, dtype=out_dtype, device=dev)
        for layer in t:
            layer.copy_(draw(shape[1:], init))
        return t

    return build(param_spec(cfg))


def cast_params(params: dict, dtype=COMPUTE_DTYPE) -> dict:
    """A copy of ``params`` with every weight in ``dtype`` and the norm
    weights and the router kept float32 (the reference reads them as
    float32)."""
    return {k: cast_params(v, dtype) if isinstance(v, dict)
            else v if _keeps_f32(k) else v.to(dtype)
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


def _key_window(c: int, qc: int, S: int, win: int | None) -> slice | None:
    """The keys query chunk ``c`` (of ``qc`` queries) can reach through a
    window ``win``, as the reference slices them (``model.py:243-253``):
    when S > 2 win and qc + win < S, the ``qc + win`` keys from
    ``clamp(c qc - win, 0, S - qc - win)``; else None (every key)."""
    if win is None or S <= 2 * win or qc + win >= S:
        return None
    start = min(max(c * qc - win, 0), S - qc - win)
    return slice(start, start + qc + win)


def train_attention(x, p, cfg: LMConfig, pos, q_chunk: int = 512):
    """Causal (and, with ``cfg.swa_window``, windowed) self-attention over x
    (B, S, d) as the reference's training path computes it: queries in
    chunks of ``q_chunk`` (one chunk when S is not a multiple of it), KV
    expanded to the query heads, each chunk's scores
    (``_attention_scores_mha``) over the keys its window reaches
    (``_key_window``) under ``torch.utils.checkpoint`` while grad is
    enabled. Returns (B, S, d)."""
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
    outs = []
    for c in range(n_chunks):
        keys = _key_window(c, qc, S, cfg.swa_window) or slice(None)
        outs.append(_checkpointed(_attention_scores_mha, qf[:, c * qc:(c + 1) * qc], kf[:, keys],
                                  vf[:, keys], pos[c * qc:(c + 1) * qc], pos[keys],
                                  cfg.swa_window))
    out = torch.cat(outs, dim=1).reshape(B, S, hq * dh)
    return torch.matmul(out, p["wo"].to(x.dtype))


def cache_positions(T: int, pos: int, window: int | None, device) -> torch.Tensor:
    """The absolute position each of a decode cache's T slots holds once
    position ``pos`` is written: slot t holds t without a window; with one,
    the cache rolls (position p at slot p % T) and a slot holds the newest p
    <= pos with p % T == t. A slot that holds no position yet gets pos + 1,
    which the causal mask excludes."""
    slot = torch.arange(T, device=device)
    if window is None:
        return slot
    held = pos - (pos - slot) % T
    return torch.where(held >= 0, held, pos + 1)


def attention(x, p, cfg: LMConfig, pos, kv_cache=None, cache_pos: int | None = None):
    """Full-sequence (prefill) or single-token (decode) attention.

    x: (B, S, d). pos: (S,) absolute positions (shared across batch).
    kv_cache None: causal (and windowed) self-attention over x through the
    flash kernel; returns ``(out, (k, v))``, the roped k and v ``(B, S, Hkv,
    Dh)`` for the cache (the reference recomputes them in ``prefill``; they
    are the same numbers). Else ``{"k", "v"}`` views ``(B, Hkv, T, Dh)`` of
    the cache: decode against it (S == 1), writing this step's k and v at
    slot ``cache_pos`` (``cache_pos % T`` with a window: the rolling cache)
    in place; returns ``(out, kv_cache)``.
    """
    B, S, _ = x.shape
    hq, dh = cfg.n_heads, cfg.d_head
    cd = x.dtype
    q, k, v = _qkv(x, p, cfg, pos)

    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        T = ck.shape[2]
        slot = cache_pos % T if cfg.swa_window else cache_pos
        ck[:, :, slot:slot + S] = k.to(ck.dtype).transpose(1, 2)
        cv[:, :, slot:slot + S] = v.to(cv.dtype).transpose(1, 2)
        k_pos = cache_positions(T, cache_pos, cfg.swa_window, x.device)
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


# ---------------------------------------------------------------------- #
# MoE
# ---------------------------------------------------------------------- #

def moe_capacity(S: int, moe) -> int:
    """Slots an expert takes from each batch row of S tokens (the
    reference's C): 1 in decode."""
    return max(int(math.ceil(S * moe.top_k / moe.n_experts * moe.capacity_factor)), 1)


def moe_route(x, router, moe, gate_i=None):
    """The reference's router over x (B, S, d): float32 logits ``x @
    router`` (the card keeps TF32 off, PyTorch's default, or routes flip),
    -1e30 for the pad experts, softmax, the top ``top_k`` probabilities
    (or those at the experts ``gate_i`` forces) renormalised by max(sum,
    1e-9). Returns ``probs`` (B, S, e_pad), ``gate_v`` (B, S, K) float32,
    ``gate_i`` (B, S, K) int64 and ``pos`` (B, S, K): each selection's slot
    in its expert, counting the selections of its batch row token-major,
    rank-minor (dropped ones too)."""
    B, S, _ = x.shape
    E, K = moe.e_pad, moe.top_k
    logits = torch.matmul(x.float(), router.float())
    if E > moe.n_experts:                               # pad experts are never selected
        logits = logits.masked_fill(torch.arange(E, device=x.device) >= moe.n_experts, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if gate_i is None:
        gate_v, gate_i = torch.topk(probs, K, dim=-1)
    else:
        gate_v = probs.gather(-1, gate_i)
    gate_v = gate_v / gate_v.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = gate_i.reshape(B, S * K)
    sel = F.one_hot(flat, E)                            # (B, S*K, E)
    pos = (sel.cumsum(1) - sel).gather(2, flat[..., None])[..., 0]
    return probs, gate_v, gate_i, pos.reshape(B, S, K)


def _moe_slots(gate_i, pos, moe, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each selection's row in the dispatch buffer, which holds the real
    experts' slots expert-major (virtual expert, batch row, slot): virtual
    expert ``e * virtual_split + j`` is expert e's j-th slice, so a
    selection fills one slot of each of its expert's ``virtual_split``
    slices. Returns ``slots`` (B*S*K*vs,) in token-major, rank-, then
    slice-minor order, a dropped selection (slot >= C) pointing at the
    spare row past the buffer, and ``keep`` (B, S, K)."""
    B = gate_i.shape[0]
    vs = moe.virtual_split
    rows = moe.n_experts * vs * B * C
    keep = pos < C
    ve = gate_i[..., None] * vs + torch.arange(vs, device=gate_i.device)
    b = torch.arange(B, device=gate_i.device)[:, None, None, None]
    slots = (ve * B + b) * C + pos[..., None]
    return torch.where(keep[..., None], slots, rows).reshape(-1), keep


class _SlotGather(torch.autograd.Function):
    """The dispatch buffer: ``rows`` + 1 rows, row ``slots[i]`` holding token
    ``i // per``'s row of x (N, d) (``per`` = K x virtual_split selections a
    token), the rest 0; the last row is the spare that dropped selections
    write. Its backward adds each token's ``per`` slot rows of the cotangent
    (the spare's is 0) on the float segment sum, in selection order: the
    kernel on the card, its plain version on the CPU."""

    @staticmethod
    def forward(ctx, x, slots, rows):
        N, d = x.shape
        per = slots.numel() // N
        ctx.save_for_backward(slots)
        ctx.n, ctx.per = N, per
        buf = x.new_zeros((rows + 1, d))
        buf.index_copy_(0, slots, x[:, None].expand(N, per, d).reshape(N * per, d))
        return buf

    @staticmethod
    def backward(ctx, grad):
        (slots,) = ctx.saved_tensors
        n, per, dev = ctx.n, ctx.per, slots.device
        layout = SegmentLayout(ids=torch.arange(n, device=dev).repeat_interleave(per),
                               order=torch.arange(n * per, device=dev),
                               row_ptr=torch.arange(n + 1, device=dev) * per)
        return segment_sum_float(grad.index_select(0, slots), layout), None, None


def moe_dispatch(x, gate_i, pos, moe, C: int):
    """x (B, S, d) gathered into the real experts' slots: ``buf`` (E_real,
    B*C, d), E_real = n_experts x virtual_split, empty slots 0 (the
    reference's ``einsum(dispatch, x)`` without its pad experts' slots,
    which no selection fills), and ``_moe_slots``' ``slots`` and ``keep``."""
    B, S, d = x.shape
    slots, keep = _moe_slots(gate_i, pos, moe, C)
    rows = moe.n_experts * moe.virtual_split * B * C
    buf = _SlotGather.apply(x.reshape(B * S, d), slots, rows)
    return buf[:rows].view(moe.n_experts * moe.virtual_split, B * C, d), slots, keep


def moe_block(x, p, cfg: LMConfig, routes: list | None = None, forced: dict | None = None):
    """Top-k capacity-dispatch MoE (the reference's ``moe_block``, without
    its GSPMD one-hot einsums). x (B, S, d); capacity C per batch row
    (``moe_capacity``); a selection past its expert's C slots is dropped.
    The experts run as batched products over their slots, each virtual
    half's y rounded on its own; each token's output is the float32 sum of
    its kept ``bf16(gate) * y`` products, rounded once, plus the shared
    experts' MLP of x. Returns (out (B, S, d), aux), ``aux`` the reference's
    load-balancing loss over all ``e_pad`` experts: E x sum(mean router
    probability x fraction of selections, dropped ones too).

    ``routes``, a list, gets this call's routing record (``gate_i``,
    ``gate_v``, ``pos``, ``keep``, ``probs``, ``C``). ``forced``, another
    call's record, makes this call take its experts in place of its own
    top-k, gated by its own probabilities there: two routes' arithmetic can
    then be held without a near-tie that rounds the other way sending a
    token to other experts (as ``launch.serve.generate(forced=)`` forces
    tokens)."""
    moe = cfg.moe
    B, S, d = x.shape
    K, vs, E = moe.top_k, moe.virtual_split, moe.e_pad
    C = moe_capacity(S, moe)
    cd = x.dtype
    probs, gate_v, gate_i, pos = moe_route(
        x, p["router"], moe, None if forced is None else forced["gate_i"].to(x.device))
    buf, slots, keep = moe_dispatch(x, gate_i, pos, moe, C)

    er = buf.shape[0]
    up = torch.bmm(buf, p["w_up"][:er].to(cd))
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(buf, p["w_gate"][:er].to(cd))) * up
    else:
        h = F.gelu(up, approximate="tanh")
    y = torch.bmm(h, p["w_down"][:er].to(cd)).reshape(-1, d)
    y = torch.cat([y, y.new_zeros((1, d))])             # the spare row of dropped selections

    w = torch.where(keep, gate_v.to(cd), 0).repeat_interleave(vs, dim=-1)   # (B, S, K*vs)
    picked = y.index_select(0, slots).view(B * S, K * vs, d)
    out = (picked.float() * w.reshape(B * S, K * vs, 1).float()).sum(1).to(cd).view(B, S, d)
    if moe.n_shared:
        out = out + mlp(x, p["shared"], cfg)

    counts = torch.bincount(gate_i.reshape(-1), minlength=E)
    aux = E * (probs.mean(dim=(0, 1)) * (counts.float() / (B * S) / K)).sum()
    if routes is not None:
        routes.append({"gate_i": gate_i.detach(), "gate_v": gate_v.detach(), "pos": pos,
                       "keep": keep, "probs": probs.detach(), "C": C})
    return out, aux


def _block(x, lp, cfg: LMConfig, attend, routes=None, forced=None):
    """A block around ``attend(rmsnorm(x)) -> (h, extra)``, its MLP or MoE
    after (``routes`` and ``forced`` as ``moe_block`` takes them); returns
    ``(x, extra, aux)``, ``aux`` the MoE's aux loss (0 for a dense
    block)."""
    h, extra = attend(rmsnorm(x, lp["norm1"], cfg.norm_eps))
    x = x + h
    h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if cfg.moe:
        h2, aux = moe_block(h2, lp["moe"], cfg, routes, forced)
    else:
        h2, aux = mlp(h2, lp["mlp"], cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h2, extra, aux


def layer_fn(x, lp, cfg: LMConfig, pos, kv_cache=None, cache_pos=None, routes=None,
             forced=None):
    """One block of the serving passes (prefill on the flash kernel, or
    decode); returns ``(x, cache, aux)``, ``cache`` as ``attention`` returns
    it. ``routes`` and ``forced`` go to ``moe_block``."""
    return _block(x, lp, cfg, lambda h: attention(h, lp["attn"], cfg, pos, kv_cache=kv_cache,
                                                  cache_pos=cache_pos), routes, forced)


def train_layer(x, lp, cfg: LMConfig, pos):
    """One block of the training passes, on ``train_attention``; returns
    ``(x, aux)``."""
    x, _, aux = _block(x, lp, cfg, lambda h: (train_attention(h, lp["attn"], cfg, pos), None))
    return x, aux


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
    aux loss summed over the layers (float32; 0 for a dense model). Each
    layer runs under ``torch.utils.checkpoint`` while grad is enabled
    (``remat_policy`` ``"full"``, the configs' default). ``dtype`` is the
    compute dtype, as in ``prefill``."""
    if cfg.remat_policy in ("dots", "all_dots"):
        raise NotImplementedError(f"{cfg.name}: remat_policy {cfg.remat_policy!r} is not ported "
                                  f"yet: {_REMAT}")
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    B, S = tokens.shape
    x = _EmbedGather.apply(params["embed"], tokens).to(dtype)
    pos = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        x, aux_l = _checkpointed(train_layer, x, lp, cfg, pos)
        aux = aux + aux_l
    x = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    return x, aux


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
    """Stacked (L, B, Hkv, T, Dh) zero cache: T = ``max_len``, capped at
    the window with one (the rolling cache)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len(cfg, max_len), cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_len(cfg: LMConfig, max_len: int) -> int:
    """A decode cache's capacity T for ``max_len`` positions: capped at the
    window with one."""
    return min(max_len, cfg.swa_window) if cfg.swa_window else max_len


def _embed(params, tokens, dtype):
    return F.embedding(tokens, params["embed"]).to(dtype)


def decode_step(params, cfg: LMConfig, token, cache, pos: int, dtype=COMPUTE_DTYPE,
                routes: list | None = None, forced: list | None = None):
    """One decode step. token (B, 1) int, pos (an int) the position shared by
    the whole batch. Writes this step's k/v into ``cache`` in place (the
    reference returns an updated copy). Returns (logits (B, vocab) float32,
    cache). ``dtype`` is the compute dtype: bf16 as in the reference;
    float32 with float32 parameters evaluates the same weights without
    rounding to bf16, as a yardstick for the bf16 routes. An MoE model's
    layers append their routing to ``routes`` and take layer i's experts
    from ``forced[i]`` where given (``moe_block``)."""
    pos = int(pos)
    x = _embed(params, token, dtype)
    posb = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        x, _, _ = layer_fn(x, lp, cfg, posb,
                           kv_cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_pos=pos,
                           routes=routes, forced=None if forced is None else forced[i])
    h = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, h)[:, 0, :]
    return logits.float(), cache


def prefill(params, cfg: LMConfig, tokens, cache: dict | None = None, dtype=COMPUTE_DTYPE,
            routes: list | None = None, forced: list | None = None):
    """Full-sequence prefill building the KV cache; returns (last-token
    logits (B, vocab) float32, cache).

    Without ``cache`` the cache is new and holds exactly the S prompt
    positions (the last window of them with a window), as the reference's
    does; with one (from ``init_kv_cache``, capacity T >= S without a
    window, else it raises) the prompt's k/v go into it in place, so a
    server need not copy them into its serving cache. Position p goes to
    slot p, or with a window the last min(S, T) positions to slot p % T, the
    slot the rolling decode reads it from (the reference's
    ``launch/serve.py`` places them elsewhere when S > window and S % window
    != 0: ROADMAP.md Queue C caveat 8). ``dtype`` is the compute dtype, and
    ``routes`` and ``forced`` an MoE model's routing, as in ``decode_step``.
    """
    B, S = tokens.shape
    x = _embed(params, tokens, dtype)
    pos = torch.arange(S, device=x.device)
    if cache is None:
        cache = init_kv_cache(cfg, B, S, dtype=dtype, device=x.device)
    T = cache["k"].shape[3]
    if not cfg.swa_window and T < S:
        raise ValueError(f"a cache of {T} slots cannot hold a prompt of {S} positions without a "
                         f"window")
    kept = min(S, T) if cfg.swa_window else S
    slots = torch.arange(S - kept, S, device=x.device) % T
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        x, (k, v), _ = layer_fn(x, lp, cfg, pos, routes=routes,
                                forced=None if forced is None else forced[i])
        cache["k"][i].index_copy_(2, slots, k[:, S - kept:].transpose(1, 2).to(cache["k"].dtype))
        cache["v"][i].index_copy_(2, slots, v[:, S - kept:].transpose(1, 2).to(cache["v"].dtype))
    h = rmsnorm(x[:, -1:, :], params["norm_f"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, h)[:, 0, :]
    return logits.float(), cache
