"""Plain PyTorch version of the flash-attention kernel: the materialised
softmax of ``repro.kernels.flash_attention.ref.attention_ref``, in float32,
with masked scores filled with the finite ``-1e30`` (so a row that is masked
everywhere averages ``v`` over all keys, as the kernel's does)."""

from __future__ import annotations

import torch

NEG_FILL = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, q_start: int = 0) -> torch.Tensor:
    """q: (BH, Sq, d), k/v: (BHk, Sk, d) with BH % BHk == 0 (GQA: q row bh
    reads kv row bh // rep) -> (BH, Sq, d) in q's dtype. ``q_start`` is the
    first query's position (0: the whole problem; more: a slice of its
    rows, as ``chip_smoke.py`` holds a long sequence's last rows)."""
    BHq, Sq, d = q.shape
    BHk, Sk, _ = k.shape
    rep = BHq // BHk
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    q_pos = torch.arange(q_start, q_start + Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, NEG_FILL)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
