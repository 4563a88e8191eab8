"""The port's flash attention against the JAX package's.

On the CPU the wrapper computes its plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode (as
tests/test_kernels.py runs it) and against the reference's oracle
``attention_ref`` (tests/test_torch_gpu.py holds the CUDA kernel against the
plain version on the card). Inputs are drawn with numpy from a seed, cast to
the dtype on each side (the same round-to-nearest-even), and handed to both
packages.

Tolerances are tests/test_kernels.py:160's. float32: 2e-5; nothing is rounded
to a narrower type, so only the summation order and the kernel's online
rescaling differ (about 1e-6 here). bfloat16: 2e-2; the output is a bf16
number (one unit in the last place is 7.8e-3 for |o| in [1, 2) and 1.6e-2 in
[2, 4)), and the Pallas kernel rounds p to bf16 before its PV product
(relative 2^-9) where the plain version keeps p in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed=42):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Sq, Hq, D), dtype=np.float32),
            r.standard_normal((B, Sk, Hkv, D), dtype=np.float32),
            r.standard_normal((B, Sk, Hkv, D), dtype=np.float32))


def _port(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(TORCH[dtype]) for a in arrays)
    return fa.flash_attention(q, k, v, **kw).float().numpy()


def _jax_ref(arrays, dtype, causal, window):
    q, k, v = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    out = jax_attention_ref(q.transpose(0, 2, 1, 3).reshape(B * Hq, Sq, D),
                            k.transpose(0, 2, 1, 3).reshape(B * Hkv, Sk, D),
                            v.transpose(0, 2, 1, 3).reshape(B * Hkv, Sk, D),
                            causal=causal, window=window)
    return np.asarray(out.reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3).astype(jnp.float32))


def _jax_pallas(arrays, dtype, causal, window):
    q, k, v = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays)
    return np.asarray(jax_flash(q, k, v, causal=causal, window=window).astype(jnp.float32))


def _err(a, b):
    return float(np.max(np.abs(a - b)))


def _held_against_the_reference(shape, dtype, causal, window):
    arrays = _inputs(*shape)
    got = _port(arrays, dtype, causal=causal, window=window)
    assert got.shape == arrays[0].shape and np.isfinite(got).all()
    assert _err(got, _jax_pallas(arrays, dtype, causal, window)) < TOL[dtype]
    assert _err(got, _jax_ref(arrays, dtype, causal, window)) < TOL[dtype]
    return arrays, got


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (2, 128, 128, 4, 2, 32),     # GQA
    (1, 256, 256, 8, 1, 64),     # MQA
    (2, 64, 64, 4, 4, 16),       # MHA
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_matches_pallas_and_ref(B, Sq, Sk, Hq, Hkv, D, causal, window, dtype):
    """tests/test_kernels.py's flash sweep, through the port."""
    _held_against_the_reference((B, Sq, Sk, Hq, Hkv, D), dtype, causal, window)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (32, 96, True, None),        # fewer queries than keys: row q sees keys 0..q
    (96, 32, True, None),        # more queries than keys
    (96, 32, True, 24),
    (48, 80, False, 16),         # a window without the causal mask
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unequal_lengths(Sq, Sk, causal, window, dtype):
    _held_against_the_reference((1, Sq, Sk, 4, 2, 16), dtype, causal, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_masked_everywhere_averages_v(dtype):
    """Rows q >= Sk + window - 1 see no key (causal, window 8, Sk 16): with
    the finite -1e30 fill every key gets the same weight, and the row is the
    mean of v over all Sk keys, as in the reference; never NaN."""
    Sk, window = 16, 8
    arrays, got = _held_against_the_reference((1, 40, Sk, 2, 1, 16), dtype, True, window)
    v = torch.from_numpy(arrays[2]).to(TORCH[dtype]).float().numpy()
    mean_v = v.mean(axis=1)                                   # (1, Hkv, D)
    first = Sk + window - 1
    want = np.broadcast_to(mean_v[:, None], got[:, first:].shape)
    np.testing.assert_allclose(got[:, first:], want, atol=TOL[dtype], rtol=0)
    assert _err(got[:, first - 1], mean_v) > 10 * TOL[dtype]  # the last row that sees keys does not


def test_strided_inputs_on_the_cpu():
    """Views of one fused projection give the same answer as compact copies."""
    r = np.random.default_rng(3)
    qkv = torch.from_numpy(r.standard_normal((2, 48, 3, 4, 16), dtype=np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_plain_version_is_the_layout_of_the_reference_oracle():
    arrays = _inputs(1, 24, 24, 2, 2, 8)
    q, k, v = (torch.from_numpy(a).transpose(1, 2).reshape(2, 24, 8) for a in arrays)
    flat = attention_ref(q, k, v, causal=True, window=5).reshape(1, 2, 24, 8).transpose(1, 2)
    np.testing.assert_array_equal(flat.numpy(), _port(arrays, "float32", causal=True, window=5))


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    before = fa.launches
    _port(_inputs(1, 16, 16, 2, 2, 8), "bfloat16", causal=True)
    assert fa.launches == before


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="4-D"):
        fa.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="share a dtype"):
        fa.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(torch.zeros(1, 8, 3, 16), k, k)
    with pytest.raises(ValueError, match="Sk >= 1"):
        fa.flash_attention(q, k[:, :0], k[:, :0])
    with pytest.raises(ValueError, match="alike"):
        fa.flash_attention(q, k, torch.zeros(1, 9, 2, 16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, k, window=2.5)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
