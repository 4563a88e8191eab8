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

import pathlib
import re

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


# ------------------- the stretch definition (ops.STRETCH) ------------------- #

S = sk.STRETCH
WIDTHS = (0, 1, S - 1, S, S + 1, 2 * S, 2 * S + 1, 5 * S + 3)


def _rows_of(widths, rng, extra_rows=0):
    """Segment ids with row i holding widths[i] arcs, the arcs shuffled; ``extra_rows``
    empty rows after them."""
    ids = np.repeat(np.arange(len(widths)), widths)
    rng.shuffle(ids)
    return ids, len(widths) + extra_rows


def _numpy_two_level(vals32: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """The definition with explicit loops: per row, per stretch of S arcs in edge
    order, a float32 sum from 0; then the stretch partials in order, from 0."""
    out = np.zeros((n, vals32.shape[1]), np.float32)
    for r in range(n):
        arcs = np.flatnonzero(ids == r)
        total = np.zeros(vals32.shape[1], np.float32)
        for s0 in range(0, len(arcs), S):
            part = np.zeros(vals32.shape[1], np.float32)
            for e in arcs[s0:s0 + S]:
                part = part + vals32[e]
            total = total + part
        out[r] = total
    return out


@pytest.mark.parametrize("F", [1, 3, 8, 144])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_is_the_numpy_two_level_sum(dtype, F):
    rng = np.random.default_rng(F)
    ids, n = _rows_of(WIDTHS, rng, extra_rows=2)
    vals, vals32 = _vals(rng, ids.size, F, DTYPES[dtype][0])
    want = torch.from_numpy(_numpy_two_level(vals32, ids, n)).to(vals.dtype)
    got = sk.segment_sum_float_ref(vals, torch.as_tensor(ids), n)
    assert got.dtype == vals.dtype and torch.equal(got, want)
    # through the wrapper and its layout too
    assert torch.equal(sk.segment_sum_float(vals, sk.segment_layout(ids, n)), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rows_of_at_most_one_stretch_keep_the_single_float32_sum(dtype):
    rng = np.random.default_rng(11)
    ids, n = _rows_of(WIDTHS, rng)
    vals, _ = _vals(rng, ids.size, 24, DTYPES[dtype][0])
    got = sk.segment_sum_float_ref(vals, torch.as_tensor(ids), n)
    single = torch.zeros((n, 24)).index_add_(0, torch.as_tensor(ids), vals.float()).to(vals.dtype)
    narrow = [i for i, w in enumerate(WIDTHS) if w <= S]
    wide = [i for i, w in enumerate(WIDTHS) if w > S]
    assert torch.equal(got[narrow], single[narrow])
    if dtype == "float32":      # several stretches add in another order (bf16 may round it away)
        assert not torch.equal(got[wide], single[wide])
    # with no row past a stretch, the result is the single sum everywhere
    keep = np.isin(ids, narrow)
    sub = sk.segment_sum_float_ref(vals[torch.as_tensor(keep)], torch.as_tensor(ids[keep]), n)
    assert torch.equal(sub, torch.zeros((n, 24)).index_add_(
        0, torch.as_tensor(ids[keep]), vals[torch.as_tensor(keep)].float()).to(vals.dtype))


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 3 * S + 5), st.integers(0, 600), st.integers(2, 12), st.booleans(),
       st.integers(0, 10_000))
def test_a_rows_bits_do_not_depend_on_the_other_rows(d, others, n, bf16, seed):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.zeros(d, np.int64), rng.integers(1, n, others)])
    rng.shuffle(ids)
    vals, _ = _vals(rng, ids.size, 5, torch.bfloat16 if bf16 else torch.float32)
    got = sk.segment_sum_float(vals, sk.segment_layout(ids, n))
    moved = ids.copy()
    rest = np.flatnonzero(ids != 0)
    moved[rest] = rng.permutation(ids[rest])
    moved[rest[: len(rest) // 3]] = rng.integers(1, n, len(rest) // 3)
    again = sk.segment_sum_float(vals, sk.segment_layout(moved, n))
    assert torch.equal(got[0], again[0])
    assert torch.equal(got[0], sk.segment_sum_float(vals[torch.as_tensor(ids == 0)],
                                                    sk.segment_layout(np.zeros(d, np.int64), 1))[0])


def _table_of(row_ptr: np.ndarray):
    """The work table by loops: the wide rows and their stretches, then the batches,
    a new one wherever a row's start on the path of rows and narrow arcs enters a new
    block of BATCH_ITEMS."""
    d = np.diff(row_ptr)
    rows = np.flatnonzero(d > S)
    per = -(-d[rows] // S)
    batches, pos, block = [], 0, -1
    for r in range(d.size):
        if pos // sk.BATCH_ITEMS != block:
            batches.append(r)
            block = pos // sk.BATCH_ITEMS
        pos += 1 + (d[r] if d[r] <= S else 0)
    return (rows, np.concatenate([[0], np.cumsum(per)]), np.repeat(np.arange(rows.size), per),
            np.array(batches + [d.size]))


def _assert_table(lay):
    rows, ptr, owner, batches = _table_of(lay.row_ptr.numpy())
    t = lay.stretches
    for got, want in ((t.rows, rows), (t.ptr, ptr), (t.owner, owner), (t.batches, batches)):
        assert got.dtype == torch.int64 and got.device == lay.row_ptr.device
        np.testing.assert_array_equal(got.numpy(), want)
    # a batch: at most BATCH_ITEMS rows, at most BATCH_ITEMS + S arcs of rows under a stretch
    d = lay.row_ptr.diff().numpy()
    for a, b in zip(batches[:-1], batches[1:]):
        assert 1 <= b - a <= sk.BATCH_ITEMS
        assert d[a:b][d[a:b] <= S].sum() <= sk.BATCH_ITEMS + S


def test_stretch_table_of_segment_layout():
    rng = np.random.default_rng(5)
    ids, n = _rows_of(WIDTHS + (3 * S, 0, 7), rng, extra_rows=4)
    lay = sk.segment_layout(ids, n)
    _assert_table(lay)
    assert lay.stretches.rows.tolist() == [4, 5, 6, 7, 8]
    assert lay.stretches.ptr.tolist() == [0, 2, 4, 7, 13, 16]
    # no wide row: an empty table; no rows at all: the same
    _assert_table(sk.segment_layout(np.arange(40) % 7, 9))
    assert sk.segment_layout(np.arange(40) % 7, 9).stretches.owner.numel() == 0
    _assert_table(sk.segment_layout(np.zeros(0, np.int64), 0))
    # many empty rows, and rows of about BATCH_ITEMS arcs
    _assert_table(sk.segment_layout(rng.integers(0, 50, 2_000) * 97, 5_000))
    _assert_table(sk.segment_layout(np.repeat(np.arange(40), rng.integers(10, 20, 40)), 40))
    # a layout made by hand derives its table from row_ptr
    row_ptr = torch.tensor([0, 0, S + 1, S + 1, 4 * S + 2])
    hand = sk.SegmentLayout(ids=torch.repeat_interleave(torch.arange(4), row_ptr.diff()),
                            order=torch.arange(4 * S + 2), row_ptr=row_ptr)
    _assert_table(hand)
    assert hand.stretches.rows.tolist() == [1, 3] and hand.stretches.ptr.tolist() == [0, 2, 6]


@pytest.mark.parametrize("n", [0, 1, 2, 7, 40])
@pytest.mark.parametrize("width", [0, 1, 2, 3, 4, 8, S, S + 1, 3 * S])
def test_stretch_table_of_rows_of_one_width_by_arithmetic(n, width):
    """A layout told that every row has ``width`` arcs derives the same table
    without reading ``row_ptr``."""
    row_ptr = torch.arange(n + 1) * width
    lay = sk.SegmentLayout(ids=torch.arange(n).repeat_interleave(width),
                           order=torch.arange(n * width), row_ptr=row_ptr, width=width)
    _assert_table(lay)
    general = sk.stretch_table(row_ptr)
    for f in ("rows", "ptr", "owner", "batches"):
        assert torch.equal(getattr(lay.stretches, f), getattr(general, f))


def test_the_stretch_and_batch_constants_are_the_kernels():
    """ops.STRETCH and ops.BATCH_ITEMS are csrc/segment_sum.cu's kStretch and
    kBatchItems, each written once there."""
    src = (pathlib.Path(sk.__file__).parent / "csrc" / "segment_sum.cu").read_text()
    for name, value in (("kStretch", sk.STRETCH), ("kBatchItems", sk.BATCH_ITEMS)):
        (found,) = re.findall(rf"constexpr (?:long long|int) {name} = (\d+);", src)
        assert int(found) == value


def test_stretch_table_of_the_moe_slot_gathers_layout(monkeypatch):
    """``_SlotGather``'s backward builds its layout by hand: it carries the same
    table, and its result is the plain scatter's."""
    from repro_torch.models.transformer import model as PM

    seen = []

    def spy(values, layout):
        seen.append(layout)
        return sk.segment_sum_float(values, layout)

    monkeypatch.setattr(PM, "segment_sum_float", spy)
    rng = np.random.default_rng(2)
    N, per, d, rows = 40, 6, 8, 300
    slots = torch.as_tensor(rng.permutation(rows + 1)[:N * per])
    x = torch.as_tensor(rng.standard_normal((N, d)).astype(np.float32)).requires_grad_(True)
    buf = PM._SlotGather.apply(x, slots, rows)
    g = torch.as_tensor(rng.standard_normal(buf.shape).astype(np.float32))
    buf.backward(g)
    (lay,) = seen
    assert lay.width == per                          # its table came by arithmetic
    _assert_table(lay)
    assert lay.stretches.owner.numel() == 0          # per slot rows a token, under a stretch
    want = torch.zeros(N, d).index_add_(0, torch.arange(N).repeat_interleave(per), g[slots])
    assert torch.equal(x.grad, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F", [1, 8, 144])
def test_rows_of_several_stretches_against_jax_and_float64(dtype, F):
    rng = np.random.default_rng(31 + F)
    ids, n = _rows_of(WIDTHS, rng, extra_rows=3)
    vals, _ = _vals(rng, ids.size, F, DTYPES[dtype][0])
    got = _hold(vals, ids, n, squeeze=F == 1)
    assert not got[len(WIDTHS):].any()
