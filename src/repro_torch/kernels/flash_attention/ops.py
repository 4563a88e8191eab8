"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=, window=)`` keeps the reference's
signature (``repro.kernels.flash_attention.ops.flash_attention``): q
``(B, Sq, Hq, d)``, k/v ``(B, Sk, Hkv, d)`` with ``Hq % Hkv == 0`` (query
head h reads kv head ``h // (Hq // Hkv)``), float32 or bfloat16, causal and
sliding-window masks on absolute positions that start at 0 for both q and
k. On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
computes the plain version, ``ref.attention_ref``; on a ``meta`` tensor it
returns an empty result. ``launches`` counts the kernel's launches and
nothing else. Every call books ``cost`` of its shapes with the counters open on its
thread (``kernels/cost.py``).

The kernel takes the batch, sequence and head strides of each input, so the
``(B, S, H, d)`` projections go in without a ``.contiguous()`` copy. Only an
input whose last dimension is strided, whose rows are not 16-byte aligned
(the kernel's vector loads and tensor maps), or that repeats rows through a
zero stride, is copied first. On the card d must be one of
``KERNEL_HEAD_DIMS``; bfloat16 with d of 64 or 128 runs the tensor-core
kernel (``wgmma``, K/V tiles brought in by TMA), everything else the
float32 CUDA-core kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import kernel_call
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0

KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WINDOW_CAP = 1 << 30   # beyond every position the kernel takes (int32)

_SYMBOLS = {
    "flash_attention_fwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, H, d), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    B, _, Hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k and v must be (B={B}, Sk, Hkv, d={d}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] < 1 or k.shape[2] < 1 or Hq % k.shape[2]:
        raise ValueError(f"need Sk >= 1 and Hq ({Hq}) a multiple of Hkv ({k.shape[2]})")
    if max(q.shape[1], k.shape[1]) >= 2**31 or B * Hq >= 2**31:
        raise ValueError("sequence lengths and B * Hq must fit an int32")
    if window is not None and int(window) != window:
        raise ValueError(f"window must be an int or None, got {window!r}")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it in place, else a compact copy."""
    size = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all((s * size) % 16 == 0 and (s > 0 or n == 1)
                    for s, n in zip(t.stride()[:3], t.shape[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _rows_sum(a: int, b: int, slope: int, c: int, Sk: int) -> int:
    """Sum over the query rows i in [a, b) of ``slope * i + c`` where that is
    positive, and of Sk where it is not (a row masked everywhere)."""
    if a >= b:
        return 0
    if slope == 0:
        return (b - a) * (c if c > 0 else Sk)
    p0, p1 = (max(a, 1 - c), b) if slope > 0 else (a, min(b, c))
    n = max(p1 - p0, 0)
    kept = slope * ((p0 + p1 - 1) * n // 2) + c * n if n else 0
    return kept + (b - a - n) * Sk


def pairs(Sq: int, Sk: int, causal: bool = True, window: int | None = None) -> int:
    """The (query, key) pairs the scores need: the unmasked ones of each
    query row, and all Sk keys of a row masked everywhere (it averages v over
    them). Positions start at 0 for both queries and keys. Query row i sees
    keys [max(i - window + 1, 0), min(i, Sk - 1)] (no window: from 0; not
    causal: to Sk - 1), a count linear in i between the rows where a bound
    turns, so the sum is taken in closed form, stretch by stretch."""
    turns = {0, Sq}
    if causal:
        turns.add(min(max(Sk - 1, 0), Sq))
    if window is not None:
        turns.add(min(max(int(window) - 1, 0), Sq))
    cuts = sorted(turns)
    total = 0
    for a, b in zip(cuts, cuts[1:]):
        # hi = i (slope 1) below Sk - 1 when causal, else Sk - 1; lo = i - window + 1 (slope
        # 1) from row window - 1 on when windowed, else 0; the row sees hi - lo + 1 keys
        hi_s, hi_c = (1, 0) if causal and a < Sk - 1 else (0, Sk - 1)
        lo_s, lo_c = (1, 1 - int(window)) if window is not None and a >= int(window) - 1 \
            else (0, 0)
        total += _rows_sum(a, b, hi_s - lo_s, hi_c - lo_c + 1, Sk)
    return total


def cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, d: int, itemsize: int,
         causal: bool = True, window: int | None = None) -> tuple[float, float]:
    """``(flops, bytes)`` of one call: the two products q k^T and p v over the
    pairs the masks keep (``pairs``), 4 d FLOPs a pair and query head; q, k
    and v read once and the output written once."""
    flops = 4 * B * Hq * d * pairs(Sq, Sk, causal, window)
    return float(flops), float((2 * B * Sq * Hq + 2 * B * Sk * Hkv) * d * itemsize)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, d), k/v: (B, Sk, Hkv, d) -> (B, Sq, Hq, d) in q's dtype."""
    _check(q, k, v, window)
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, _ = k.shape
    with kernel_call("flash_attention", cost, B, Sq, Sk, Hq, Hkv, d, q.element_size(), causal,
                     window, dtype=q.dtype):
        return _flash_attention(q, k, v, causal, window)


def _flash_attention(q, k, v, causal, window):
    global launches
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, _ = k.shape
    if q.device.type == "meta":
        return torch.empty((B, Sq, Hq, d), dtype=q.dtype, device="meta")
    if q.device.type == "cpu":
        qf = q.transpose(1, 2).reshape(B * Hq, Sq, d)
        kf = k.transpose(1, 2).reshape(B * Hkv, Sk, d)
        vf = v.transpose(1, 2).reshape(B * Hkv, Sk, d)
        out = attention_ref(qf, kf, vf, causal=causal, window=window)
        return out.reshape(B, Hq, Sq, d).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    out = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device)
    if Sq == 0 or B == 0:
        return out
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    win = 0 if window is None else max(-_WINDOW_CAP, min(int(window), _WINDOW_CAP))
    lib = _build.load("flash_attention", _SYMBOLS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  strides, B, Hq, Hkv, Sq, Sk, d, _DTYPES[q.dtype], int(causal),
                                  int(window is not None), win, stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    return out
