"""The port's embedding bag against the JAX package's.

On the CPU the kernel's wrapper computes its plain PyTorch version; it is
held against the reference's oracle ``repro.kernels.embedding_bag.ref``
(the XLA path of ``models/recsys/embedding_bag.py``), not against the Pallas
kernel, which does not run on the installed jax (ROADMAP.md Queue C, caveat
1). tests/test_torch_gpu.py holds the CUDA kernel against the plain version
on the card. The bag modes and the ragged form are held against
``repro.models.recsys.embedding_bag``, and their gradients against
``jax.grad``. Inputs are drawn with numpy from a seed and handed to both.

Tolerances. float32: rtol = atol = 1e-5, tests/test_kernels.py:202's; both
sides sum at most 20 float32 rows, in orders that differ (about 1e-7 here).
bfloat16: the port sums in float32 and rounds once to bf16, so it is held
within one bf16 unit in the last place of a float64 sum of the same bf16
rows; the reference's XLA path is within two (it may round in between).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro.models.recsys import embedding_bag as J
from repro_torch.kernels.embedding_bag import ops as bag
from repro_torch.models.recsys import embedding_bag as P

TOL = 1e-5
SWEEP = [(100, 8, 4, 5), (500, 24, 13, 7), (1000, 32, 32, 20)]


def _inputs(V, D, B, L, seed=0, lo=-1):
    r = np.random.default_rng(seed)
    return (r.standard_normal((V, D), dtype=np.float32),
            r.integers(lo, V, (B, L)).astype(np.int32))


def _port_sum(table, idx):
    return bag.embedding_bag_sum(torch.from_numpy(table), torch.from_numpy(idx)).numpy()


@pytest.mark.parametrize("V,D,B,L", SWEEP + [(50, 18, 9, 6), (100, 18, 33, 1), (100, 18, 7, 0),
                                              (100, 18, 0, 5)],
                         ids=["sweep-100", "sweep-500", "sweep-1000", "padding-rows", "L1", "L0",
                              "B0"])
def test_plain_bag_matches_the_reference_oracle(V, D, B, L):
    table, idx = _inputs(V, D, B, L, seed=V + B)
    if V == 50:
        idx[::3] = -1                                    # bags that are all padding
    got = _port_sum(table, idx)
    want = np.asarray(embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx)))
    assert got.shape == want.shape == (B, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if V == 50:
        assert not got[::3].any()
    if L == 0:
        assert not got.any()


def test_plain_bag_in_bf16_rounds_a_float32_sum_once():
    table, idx = _inputs(1000, 32, 64, 20, seed=3)
    t16 = torch.from_numpy(table).bfloat16()
    got = bag.embedding_bag_sum(t16, torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    exact = P.embedding_bag(t16.double(), torch.from_numpy(idx)).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got.double().numpy() - exact) <= ulp)
    want = np.asarray(embedding_bag_ref(jnp.asarray(table, jnp.bfloat16), jnp.asarray(idx)),
                      np.float64)
    assert np.all(np.abs(want - exact) <= 2 * ulp)


def test_the_plain_route_launches_no_kernel_and_checks_its_inputs():
    table, idx = _inputs(100, 8, 4, 5)
    before = bag.launches
    _port_sum(table, idx)
    P.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), mode="mean")
    assert bag.launches == before
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(ValueError, match="int32"):
        bag.embedding_bag_sum(t, i.long())
    with pytest.raises(ValueError, match="contiguous"):
        bag.embedding_bag_sum(t, i.t())
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        bag.embedding_bag_sum(t[0], i)


# ----------------------------- bag modes ---------------------------------- #

MODES = [("sum", False), ("mean", False), ("max", False), ("sum", True), ("mean", True)]


def _mode_inputs(seed=1):
    table, idx = _inputs(300, 18, 21, 9, seed=seed)
    idx[4] = -1                                          # a bag that is all padding
    w = np.random.default_rng(seed + 1).uniform(0.5, 2.0, idx.shape).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("mode,weighted", MODES,
                         ids=["sum", "mean", "max", "weighted-sum", "weighted-mean"])
def test_bag_modes_match_the_reference(mode, weighted):
    table, idx, w = _mode_inputs()
    got = P.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                          torch.from_numpy(w) if weighted else None, mode=mode).numpy()
    want = np.asarray(J.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                      jnp.asarray(w) if weighted else None, mode=mode))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)   # the empty bag's max is -inf


@pytest.mark.parametrize("mode,weighted", MODES,
                         ids=["sum", "mean", "max", "weighted-sum", "weighted-mean"])
def test_bag_gradients_match_jax_grad(mode, weighted):
    """The table's gradient of <bag(table), c> for a random cotangent c: for
    an unweighted sum or mean, the kernel route's autograd Function (plain
    backward); otherwise autograd through the plain ops."""
    table, idx, w = _mode_inputs(seed=5)
    c = np.random.default_rng(9).standard_normal((idx.shape[0], table.shape[1]), dtype=np.float32)
    if mode == "max":
        c[4] = 0                                         # the empty bag's -inf has no gradient
    weights = jnp.asarray(w) if weighted else None
    want = jax.grad(lambda t: jnp.sum(J.embedding_bag(t, jnp.asarray(idx), weights, mode=mode)
                                      * c))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = P.embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(w) if weighted else None,
                          mode=mode)
    (out * torch.from_numpy(c)).nan_to_num(neginf=0.0).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_kernel_route_gradient_equals_autograd_through_the_plain_version():
    table, idx, _ = _mode_inputs(seed=7)
    c = torch.from_numpy(np.random.default_rng(2).standard_normal((21, 18), dtype=np.float32))
    a = torch.from_numpy(table).requires_grad_(True)
    (P.bag_sum(a, torch.from_numpy(idx)) * c).sum().backward()
    b = torch.from_numpy(table).requires_grad_(True)
    (bag.embedding_bag_sum_ref(b, torch.from_numpy(idx)) * c).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_ragged_bag_matches_the_reference(mode):
    r = np.random.default_rng(4)
    table = r.standard_normal((200, 18), dtype=np.float32)
    flat = r.integers(0, 200, 60).astype(np.int32)
    seg = np.sort(r.integers(0, 12, 60)).astype(np.int32)
    seg[seg == 5] = 6                                    # bag 5 is empty
    got = P.ragged_embedding_bag(torch.from_numpy(table), torch.from_numpy(flat),
                                 torch.from_numpy(seg), 12, mode=mode).numpy()
    want = np.asarray(J.ragged_embedding_bag(jnp.asarray(table), jnp.asarray(flat),
                                             jnp.asarray(seg), 12, mode=mode))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_hand_made_cases_of_the_reference_semantics_test():
    """tests/test_models_semantics.py::test_embedding_bag_modes's cases, and
    the same cases through the reference, all equal exactly."""
    table = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([[0, 1, -1], [2, -1, -1]], dtype=torch.int32)
    s = P.embedding_bag(table, idx, mode="sum")
    torch.testing.assert_close(s[0], table[0] + table[1], rtol=0, atol=0)
    m = P.embedding_bag(table, idx, mode="mean")
    torch.testing.assert_close(m[1], table[2], rtol=0, atol=0)
    r = P.ragged_embedding_bag(table, torch.tensor([0, 1, 2]), torch.tensor([0, 0, 1]), 2)
    torch.testing.assert_close(r[0], table[0] + table[1], rtol=0, atol=0)
    jt, ji = jnp.arange(12.0).reshape(4, 3), jnp.asarray(idx.numpy())
    for mode, got in (("sum", s), ("mean", m)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(J.embedding_bag(jt, ji, mode=mode)))
    np.testing.assert_array_equal(r.numpy(), np.asarray(J.ragged_embedding_bag(
        jt, jnp.array([0, 1, 2]), jnp.array([0, 0, 1]), 2)))


def test_unknown_modes_raise():
    table, idx = torch.zeros(4, 3), torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        P.embedding_bag(table, idx, mode="median")
    with pytest.raises(ValueError):
        P.ragged_embedding_bag(table, idx[0], idx[0], 1, mode="median")
