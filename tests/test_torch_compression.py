"""The port's gradient compression (``repro_torch.optim.compression``)
against the reference's (``repro.optim.compression``), in float32: both the
decompressed gradient and the error it carries are bit-equal, over ties at
the top-k threshold, a ``k_fraction`` so small that k = 1, an all-zero
gradient, values that round half to even, and error feedback carried over
two steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as ref
from repro_torch.optim import compression as port
from repro_torch import optim as port_optim


def _grads(case):
    rng = np.random.default_rng(len(case))
    if case == "normal":
        return rng.standard_normal((37, 11)).astype(np.float32)
    if case == "ties":          # many entries equal to the k-th magnitude, of both signs
        g = rng.choice(np.float32([-3, -2, -1, 1, 2, 3]), size=(8, 25)).astype(np.float32)
        return g
    if case == "zeros":
        return np.zeros((5, 7), np.float32)
    if case == "halves":        # exact halves of the int8 step: round half to even
        return (np.arange(-40, 41, dtype=np.float32) * 0.5 * (127.0 / 20.0)).astype(np.float32)
    return rng.standard_normal(1000).astype(np.float32) * np.float32(1e-3)


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k_fraction", [0.5, 0.1, 1e-9])
@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "small"])
def test_topk_equals_the_reference_over_two_steps(case, k_fraction):
    g0 = _grads(case)
    g1 = np.roll(g0, 3) * np.float32(0.5)
    kept, err = port.topk_compress_decompress(torch.as_tensor(g0), k_fraction)
    jkept, jerr = ref.topk_compress_decompress(jnp.asarray(g0), k_fraction)
    _same(kept, jkept)
    _same(err, jerr)
    kept, err = port.topk_compress_decompress(torch.as_tensor(g1), k_fraction, err)
    jkept, jerr = ref.topk_compress_decompress(jnp.asarray(g1), k_fraction, jerr)
    _same(kept, jkept)
    _same(err, jerr)
    if k_fraction == 1e-9 and case != "zeros":      # k = 1: ties aside, one entry survives
        assert int((kept != 0).sum()) >= 1


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "halves", "small"])
def test_int8_equals_the_reference_over_two_steps(case):
    g0 = _grads(case)
    g1 = np.flip(g0).copy() * np.float32(1.5)
    deq, err = port.int8_compress_decompress(torch.as_tensor(g0))
    jdeq, jerr = ref.int8_compress_decompress(jnp.asarray(g0))
    _same(deq, jdeq)
    _same(err, jerr)
    deq, err = port.int8_compress_decompress(torch.as_tensor(g1), err)
    jdeq, jerr = ref.int8_compress_decompress(jnp.asarray(g1), jerr)
    _same(deq, jdeq)
    _same(err, jerr)


def test_int8_rounds_half_to_even_and_clips():
    scale = 127.0 / 127.0 + 1e-12
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -127.0])
    deq, err = port.int8_compress_decompress(g)
    assert torch.equal(deq, torch.tensor([127.0, 0.0, 2.0, 2.0, -0.0, -2.0, -127.0]) * scale)
    assert torch.equal(err, g - deq)


def test_exported_from_optim():
    assert port_optim.topk_compress_decompress is port.topk_compress_decompress
    assert port_optim.int8_compress_decompress is port.int8_compress_decompress
