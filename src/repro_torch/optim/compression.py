"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

Two schemes, each a compress -> (all-reduce) -> decompress transform of one
gradient tensor that carries its compression error to the next step
instead of losing it:

  * top-k sparsification (Deep Gradient Compression style): the k
    largest-magnitude entries of the tensor kept, every entry whose
    magnitude reaches the k-th largest (ties are kept);
  * int8 quantization: a symmetric per-tensor scale ``max|g| / 127 +
    1e-12``, values rounded half to even and clipped to +-127.

Each returns the dense decompressed tensor and the new error. Nothing in the
port calls them: the reference's training path never does either (its
dry-run only measures the bytes they would save).
"""

from __future__ import annotations

import torch


def topk_compress_decompress(g: torch.Tensor, k_fraction: float, error=None):
    """``(kept, new_error)``: ``g`` (plus ``error``) zeroed outside its
    top-k magnitudes, k = max(int(size x k_fraction), 1), and what was
    dropped."""
    if error is not None:
        g = g + error
    flat = g.reshape(-1)
    k = max(int(flat.numel() * k_fraction), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(g.abs() >= thresh, g, torch.zeros_like(g))
    return kept, g - kept


def int8_compress_decompress(g: torch.Tensor, error=None):
    """``(dequantized, new_error)``: ``g`` (plus ``error``) quantized to
    int8 with one symmetric scale and back to float32 (a 4x cut of the
    bytes on the wire for float32 gradients)."""
    if error is not None:
        g = g + error
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g - deq
