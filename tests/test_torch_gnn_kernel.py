"""The float segment sum of the port (``segment_sum_float``, the GNNs'
scatter) on the CPU, where it runs its plain version, against
``jax.ops.segment_sum`` (what the reference's ``scatter_sum`` calls) and an
exact float64 sum. The kernel itself runs only on the card:
``tests/test_torch_gpu.py`` holds it against this plain version there.

Tolerances:

- float32: within rtol 1e-6 and atol 1e-6 x the row's sum of |v| of JAX
  (both add float32 terms, in orders that may differ), and within the bound
  any float32 summation order keeps of the float64 sum
  (``checks.segment_sum_excess``, which also covers the CPU's own order);
- bf16: ``jax.ops.segment_sum`` accumulates in bf16 on the CPU, the port in
  float32 with one rounding, so the two are not held to each other tightly:
  the port's distance from the float64 sum is no larger than JAX's plus one
  bf16 ulp of the largest magnitude (``checks.hold_bf16``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro_torch.checks import hold_bf16, segment_sum_excess
from repro_torch.kernels.segment_sum import ops as sk

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _vals(rng, E, F, dtype, lo=-100.0, hi=100.0):
    v = rng.uniform(lo, hi, (E, F)).astype(np.float32)
    t = torch.as_tensor(v).to(dtype)
    return t, t.float().numpy()     # the values as the port holds them, exactly in float32


def _hold(vals_t, ids, n, squeeze=False):
    """Port vs JAX vs the float64 sum, by the rules of the module docstring."""
    lay = sk.segment_layout(ids, n)
    got = sk.segment_sum_float(vals_t[:, 0] if squeeze else vals_t, lay)
    assert got.dtype == vals_t.dtype
    assert got.shape == ((n,) if squeeze else (n, vals_t.shape[1]))
    got = got.reshape(n, -1)
    jdt = DTYPES[str(vals_t.dtype).removeprefix("torch.")][1]
    jv = jnp.asarray(vals_t.float().numpy()).astype(jdt)
    want = torch.as_tensor(np.array(jax.ops.segment_sum(jv, jnp.asarray(ids),
                                                          num_segments=n).astype(jnp.float32)))
    exact = torch.zeros((n, vals_t.shape[1]), dtype=torch.float64).index_add_(
        0, torch.as_tensor(ids, dtype=torch.int64), vals_t.double())
    ids_t = torch.as_tensor(ids, dtype=torch.int64)
    if vals_t.dtype == torch.float32:
        assert segment_sum_excess(vals_t, ids_t, n, got, exact.float())[0] <= 0
        scale = torch.zeros_like(exact).index_add_(0, ids_t, vals_t.double().abs())
        assert bool(((got.double() - want.double()).abs() <= 1e-6 * want.double().abs()
                     + 1e-6 * scale).all())
    else:
        r = hold_bf16(got, want, exact)
        assert r["ok"], r
        # and the port's own float32 sums, rounded once
        assert segment_sum_excess(vals_t, ids_t, n, got, exact.to(torch.bfloat16))[0] <= 0
    return got


@pytest.mark.parametrize("F", [1, 3, 17, 64, 9 * 16])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_float_segment_sum_against_jax_and_float64(dtype, F):
    rng = np.random.default_rng(F)
    n, E = 97, 2500
    ids = rng.integers(0, n - 10, E)           # rows n-10.. stay empty
    vals, _ = _vals(rng, E, F, DTYPES[dtype][0])
    got = _hold(vals, ids, n)
    assert not got[n - 10:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["E = 0", "rows of one arc", "masked pad arcs",
                                  "non-contiguous view", "(E,) values", "2,000 arcs a row"])
def test_float_segment_sum_edge_cases(dtype, case):
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(7)
    if case == "E = 0":
        got = _hold(torch.zeros((0, 5), dtype=tdt), np.zeros(0, np.int64), 13)
        assert not got.any()
    elif case == "rows of one arc":
        ids = rng.permutation(300)[:200]
        vals, _ = _vals(rng, 200, 8, tdt)
        got = _hold(vals, ids, 300)
        assert torch.equal(got[torch.as_tensor(ids)], vals)     # one term: no rounding
    elif case == "masked pad arcs":
        ids = rng.integers(0, 50, 1000)
        vals, _ = _vals(rng, 1000, 16, tdt)
        mask = torch.as_tensor(rng.random(1000) < 0.7)
        ids[~mask.numpy()] = 0                               # pad arcs 0 -> 0, zeroed
        _hold(vals * mask[:, None].to(tdt), ids, 50)
    elif case == "non-contiguous view":
        base, _ = _vals(rng, 1500, 40, tdt)
        view = base[::2, 3:35]
        assert not view.is_contiguous()
        _hold(view, rng.integers(0, 30, 750), 30)
    elif case == "(E,) values":
        vals, _ = _vals(rng, 3840, 1, tdt)
        _hold(vals, np.repeat(np.arange(128), 30), 128, squeeze=True)
    else:   # the bf16 scratch case: about 2,000 arcs a row into 10 rows
        vals, _ = _vals(rng, 20_000, 4, tdt, lo=-1.0, hi=1.3)
        _hold(vals, rng.integers(0, 10, 20_000), 10)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 400), st.integers(1, 60), st.integers(1, 40), st.booleans(),
       st.integers(0, 10_000))
def test_float_segment_sum_property(E, n, F, bf16, seed):
    rng = np.random.default_rng(seed)
    vals, _ = _vals(rng, E, F, torch.bfloat16 if bf16 else torch.float32)
    _hold(vals, rng.integers(0, n, E), n)


def test_segment_layout_is_the_stable_csr_order():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, 900)
    lay = sk.segment_layout(torch.as_tensor(ids.astype(np.int32)), 45)
    ref = sk.csr_layout(ids, 45)
    np.testing.assert_array_equal(lay.order.numpy(), ref.order)
    np.testing.assert_array_equal(lay.row_ptr.numpy(), ref.row_ptr)
    assert lay.n == 45 and lay.ids.dtype == torch.int64
    top = int(ids.max())
    with pytest.raises(ValueError, match=rf"\[0, {top}\)"):
        sk.segment_layout(ids, top)
    with pytest.raises(ValueError, match="lie in"):
        sk.segment_layout(np.array([0, -1]), 4)


def test_float_segment_sum_refuses_what_it_does_not_take():
    lay = sk.segment_layout(np.array([0, 1, 1]), 2)
    with pytest.raises(ValueError, match="E = 3"):
        sk.segment_sum_float(torch.zeros(4, 2), lay)
    with pytest.raises(ValueError, match=r"\(E,\) or \(E, F\)"):
        sk.segment_sum_float(torch.zeros(3, 2, 2), lay)
    with pytest.raises(ValueError, match="meta"):
        sk.segment_sum_float(torch.zeros(3, 2, device="meta"), lay)
    before = sk.float_launches
    # on the CPU the plain version runs, float64 included, and no kernel is counted
    out = sk.segment_sum_float(torch.ones(3, 2, dtype=torch.float64), lay)
    assert out.dtype == torch.float64 and out.tolist() == [[1, 1], [2, 2]]
    assert sk.float_launches == before
