"""The port's two kernels against the JAX package's, bit for bit.

On the CPU each wrapper computes its plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode (as
tests/test_kernels.py runs it) and against the reference's oracles
(tests/test_torch_gpu.py holds the CUDA kernels against their plain
versions on the card). Inputs are made with numpy from a seed and handed
to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kcore import _bs_iters, _hindex_by_bsearch
from repro.core.kcore import hindex_rows_ref as jax_hindex_bsearch
from repro.graph.structs import Graph as JaxGraph
from repro.kernels.kcore_hindex.ops import hindex_rows as jax_hindex_pallas
from repro.kernels.kcore_hindex.ref import hindex_rows_ref as jax_hindex_sorted
from repro.kernels.segment_sum.ops import blocked_layout, segment_sum_blocked
from repro_torch.core.dispatch import _hindex_ell, _stage_ell
from repro_torch.graph.structs import build_ell, from_reference
from repro_torch.kernels.kcore_hindex import ops as hk
from repro_torch.kernels.segment_sum import ops as sk

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_hindex(nbr, est, n_iters):
    return hk.hindex_rows(_t(nbr), _t(est), n_iters).numpy()


# ------------------------------ kcore_hindex ------------------------------ #

@pytest.mark.parametrize("rows,width", [(8, 8), (64, 32), (130, 17), (5, 600)])
def test_hindex_shapes(rows, width):
    r = np.random.default_rng(rows * 1000 + width)
    nbr = r.integers(0, 50, (rows, width)).astype(np.int32)
    est = r.integers(0, 50, rows).astype(np.int32)
    got = _port_hindex(nbr, est, 7)
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_pallas(jnp.asarray(nbr), jnp.asarray(est), n_iters=7)))
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_sorted(jnp.asarray(nbr), jnp.asarray(est))))


@pytest.mark.parametrize("n_iters", [0, 1, 2, 3, 5])
def test_hindex_partial_probes_match_the_reference(n_iters):
    """Too few probes give a partial answer; it must be the reference's."""
    r = np.random.default_rng(n_iters)
    nbr = r.integers(0, 50, (40, 24)).astype(np.int32)
    est = r.integers(0, 50, 40).astype(np.int32)
    got = _port_hindex(nbr, est, n_iters)
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_pallas(jnp.asarray(nbr), jnp.asarray(est), n_iters=n_iters)))
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_bsearch(jnp.asarray(nbr), jnp.asarray(est), n_iters)))


@pytest.mark.parametrize("seed", range(8))
def test_hindex_random_tiles(seed):
    r = np.random.default_rng(seed)
    rows, width = int(r.integers(1, 41)), int(r.integers(1, 41))
    nbr = r.integers(0, 64, (rows, width)).astype(np.int32)
    est = r.integers(0, 64, rows).astype(np.int32)
    got = _port_hindex(nbr, est, 8)
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_pallas(jnp.asarray(nbr), jnp.asarray(est), n_iters=8)))
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_sorted(jnp.asarray(nbr), jnp.asarray(est))))


# The CUDA kernel's wide-row passes (csrc/kcore_hindex.cu, W > 2048), modelled
# in numpy and held against the reference at every variant's border width. A
# pass bins the row, clipped at cap = min(est_u, W), into a window of unit bins
# [base, base + nb) plus one count of everything above it; the probes are
# replayed from the suffix counts until one falls where the window cannot
# decide it, and the next pass moves the window. Nothing on the main path
# calls this model.

KERNEL_WINDOW = 8192   # kcore_hindex.cu's kWindow


def _replay(S, base, nb, n_iters, lo, hi, it):
    """Probes from (lo, hi, it) against S[i] = #{v >= base + i}, i in [0, nb];
    (done, lo, hi, it), done False at a probe the window does not decide."""
    while it < n_iters and lo < hi:
        mid = (lo + hi + 1) // 2
        i = max(mid, 1) - base
        if i < 0:                     # C(k) >= C(base)
            if S[0] < mid:
                return False, lo, hi, it
            ok = True
        elif i > nb:                  # C(k) <= C(base + nb)
            if S[nb] >= mid:
                return False, lo, hi, it
            ok = False
        else:
            ok = S[i] >= mid
        lo, hi = (mid, hi) if ok else (lo, mid - 1)
        it += 1
    return True, lo, hi, it


def _model_hindex_rows(nbr, est, n_iters, window=KERNEL_WINDOW):
    """The kernel's answer and the passes it makes over each row."""
    out, passes = [], []
    for row, eu in zip(nbr.astype(np.int64), est.astype(np.int64)):
        cap = min(int(eu), nbr.shape[1])
        v = np.minimum(row, cap)
        lo, hi, it, base, n_pass = 0, int(eu), 0, 1, 0
        while it < n_iters and lo < hi:
            nb = min(window, max(0, cap - base + 1))
            i = v - base
            hist = np.bincount(i[(i >= 0) & (i < nb)], minlength=nb)
            over = int((i >= nb).sum())
            S = np.append(np.cumsum(hist[::-1])[::-1] + over, over)
            n_pass += 1
            done, lo, hi, it = _replay(S, base, nb, n_iters, lo, hi, it)
            if done:
                break
            mid = (lo + hi + 1) // 2
            base = lo + 1 if hi - lo <= window else max(lo + 1, mid - window // 2)
        out.append(lo)
        passes.append(n_pass)
    return np.array(out, np.int32), np.array(passes)


def _border_tile(width, seed):
    """Rows at a variant's border width: random values and estimates, est_u
    above W, zero estimates, a row of zeros and a row of equal values."""
    r = np.random.default_rng(seed)
    rows = 12
    nbr = r.integers(0, 3 * width, (rows, width)).astype(np.int32)
    est = r.integers(0, 3 * width, rows).astype(np.int32)
    est[0], est[1], est[2] = 0, 3 * width + 7, 2**16     # zero, and far above W
    nbr[3] = 0
    nbr[4] = width // 2
    est[5] = 1
    return nbr, est


@pytest.mark.parametrize("width", [8, 9, 32, 33, 2048, 2049])
def test_hindex_window_model_matches_the_reference_for_every_n_iters(width):
    nbr, est = _border_tile(width, width)
    for n_iters in range(21):
        got, passes = _model_hindex_rows(nbr, est, n_iters)
        want = np.asarray(jax_hindex_bsearch(jnp.asarray(nbr), jnp.asarray(est), n_iters))
        np.testing.assert_array_equal(got, want, err_msg=f"n_iters={n_iters}")
        np.testing.assert_array_equal(got, _port_hindex(nbr, est, n_iters))
        assert passes.max() <= 1         # cap <= 8192: the first window decides every probe
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_sorted(jnp.asarray(nbr), jnp.asarray(est))))


@pytest.mark.parametrize("window", [1, 4, 16, 100])
def test_hindex_window_model_moves_its_window_exactly(window):
    """Small windows force the passes that move the window (centred on an
    undecided probe, or over the whole interval left)."""
    r = np.random.default_rng(window)
    nbr = r.integers(0, 400, (16, 300)).astype(np.int32)
    est = r.integers(0, 500, 16).astype(np.int32)
    est[0] = 0
    nbr[1, :] = 299
    for n_iters in (0, 1, 3, 7, 9, 10, 13):
        got, passes = _model_hindex_rows(nbr, est, n_iters, window)
        want = np.asarray(jax_hindex_bsearch(jnp.asarray(nbr), jnp.asarray(est), n_iters))
        np.testing.assert_array_equal(got, want, err_msg=f"n_iters={n_iters}")
    assert passes.max() > 1
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_sorted(jnp.asarray(nbr), jnp.asarray(est))))


def test_hindex_window_model_wide_row_beyond_the_kernel_window():
    """A row whose h-index lies far above 8192 takes several passes at the
    kernel's own window; the answer stays the reference's for partial and
    full probe counts."""
    r = np.random.default_rng(7)
    nbr = r.integers(0, 30000, (2, 20000)).astype(np.int32)
    est = np.array([30000, 12000], np.int32)
    for n_iters in (2, 5, 11, 16):
        got, passes = _model_hindex_rows(nbr, est, n_iters)
        want = np.asarray(jax_hindex_bsearch(jnp.asarray(nbr), jnp.asarray(est), n_iters))
        np.testing.assert_array_equal(got, want, err_msg=f"n_iters={n_iters}")
    assert passes[0] > 1
    np.testing.assert_array_equal(got, np.asarray(jax_hindex_sorted(jnp.asarray(nbr), jnp.asarray(est))))


def _jax_ell_round(g, est, n_iters):
    """One h-index round of the reference's Pallas ELL route (interpret mode)."""
    from repro.graph.structs import build_ell as jax_build_ell

    ell = jax_build_ell(g, widths=(2, 4, 8, 32))
    est_ext = np.concatenate([est, np.zeros(1, np.int32)]).astype(np.int32)
    new_ext = est_ext.copy()
    for b in ell.buckets:
        h = jax_hindex_pallas(jnp.asarray(est_ext[b.nbrs]), jnp.asarray(est_ext[b.ids]), n_iters=n_iters)
        new_ext[b.ids] = np.asarray(h, np.int32)
    return new_ext[: g.n]


def _port_ell_round(g, est, n_iters):
    tiles = _stage_ell(build_ell(from_reference(g), widths=(2, 4, 8, 32)), CPU)
    return _hindex_ell(_t(est), tiles, n_iters).numpy()


@pytest.mark.parametrize("seed", range(6))
def test_ell_round_on_ragged_graphs(seed):
    """The port's ELL route == the reference's Pallas ELL route == the XLA
    segment-op binary search, on ragged degree-bucketed layouts."""
    r = np.random.default_rng(seed)
    n, e = int(r.integers(2, 49)), int(r.integers(0, 121))
    g = JaxGraph.from_edges(r.integers(0, n, (e, 2)), n=n)
    hi = max(g.max_deg, 1) * 2 + 1
    est = r.integers(0, hi, n).astype(np.int32)
    est[g.deg == 0] = 0          # the ELL route's exactness precondition
    n_iters = _bs_iters(hi)
    got = _port_ell_round(g, est, n_iters)
    np.testing.assert_array_equal(got, _jax_ell_round(g, est, n_iters))
    est_j = jnp.asarray(est)
    seg = np.asarray(_hindex_by_bsearch(est_j, est_j[jnp.asarray(g.dst)], jnp.asarray(g.src), g.n, n_iters))
    np.testing.assert_array_equal(got, seg)


def test_ell_round_pow2_boundary_and_empty_rows():
    """A hub whose degree sits exactly on a bucket width, padded rows, and
    isolated vertices."""
    g = JaxGraph.from_edges([(0, i) for i in range(1, 9)], n=12)
    est = g.deg.astype(np.int32)
    n_iters = _bs_iters(g.max_deg)
    got = _port_ell_round(g, est, n_iters)
    np.testing.assert_array_equal(got, _jax_ell_round(g, est, n_iters))
    assert (got[9:] == 0).all()


# ------------------------------ segment_sum ------------------------------- #

def _jax_segment_sums(vals, seg, n):
    lo = blocked_layout(seg, n, R=16, be=32)
    blocked = np.asarray(segment_sum_blocked(jnp.asarray(vals), lo, n)[:, 0])
    plain = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=n))
    np.testing.assert_array_equal(blocked, plain)
    return plain


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_segment_sum_bit_exact(seed, order):
    r = np.random.default_rng(seed)
    E, n = int(r.integers(1, 401)), int(r.integers(1, 81))
    seg = r.integers(0, n, E)
    if order == "sorted":
        seg = np.sort(seg)
    vals = r.integers(0, 2**20, E).astype(np.int32)
    layout = sk.csr_layout(seg, n)
    if order == "sorted":
        np.testing.assert_array_equal(layout.order, np.arange(E))
    got = sk.segment_sum(_t(vals[layout.order]), _t(layout.row_ptr)).numpy()
    np.testing.assert_array_equal(got, _jax_segment_sums(vals, seg, n))


@pytest.mark.parametrize("E,n", [(1, 17), (3, 40), (64, 5)])
def test_segment_sum_empty_segments(E, n):
    """Rows past the last id, and rows between ids, come out 0 (hypothesis
    found E=1, n=17 leaving rows of the reference's blocked layout unset)."""
    seg = np.zeros(E, np.int64) if E < n else np.sort(np.arange(E) % n)
    vals = np.arange(1, E + 1, dtype=np.int32)
    layout = sk.csr_layout(seg, n)
    got = sk.segment_sum(_t(vals[layout.order]), _t(layout.row_ptr)).numpy()
    np.testing.assert_array_equal(got, _jax_segment_sums(vals, seg, n))
    assert (got[seg.max() + 1:] == 0).all()


def test_segment_sum_wraps_like_int32():
    vals = np.array([2**31 - 1, 5, -(2**31), -3], np.int32)
    seg = np.array([0, 0, 1, 1])
    layout = sk.csr_layout(seg, 2)
    got = sk.segment_sum(_t(vals), _t(layout.row_ptr)).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=2))
    np.testing.assert_array_equal(got, want)


# The CUDA kernel's merge path (csrc/segment_sum.cu), modelled in numpy and
# held against the reference. The n row ends and E arcs form one path of
# n + E items (a row's end after its last arc); a block takes ITEMS_PER_BLOCK
# items, whose start a first kernel finds by a 32-ary search of row_ptr, and
# stages its row ends and then its arcs, the arcs from the 16-byte chunks that
# hold them (``head`` is how many 4-byte words vals starts past a
# 16-byte boundary), and each thread walks ITEMS_PER_THREAD items: an arc adds,
# a row end stores. A thread's first row gets the partial sums of the threads
# before it from a segmented scan; the row a block ends in is left as a carry
# that a last pass adds. Nothing on the main path calls this model.

M32 = 0xFFFFFFFF


def _warp_search(row_ptr, n, E, d):
    """segment_sum.cu's path_search_rows: rows consumed in the first d items."""
    lo, hi = max(d - E, 0), min(d, n)
    while lo < hi:
        step = (hi - lo + 31) // 32
        below = [p < hi and row_ptr[p + 1] + p < d for p in (lo + lane * step for lane in range(32))]
        nb = sum(below)
        assert below == [True] * nb + [False] * (32 - nb)        # a prefix of the lanes
        if nb == 0:
            hi = lo
        else:
            last = lo + (nb - 1) * step
            hi, lo = min(last + step, hi), last + 1
    return lo


def _block_search(ends, ni, nj, d):
    lo, hi = max(d - nj, 0), min(d, ni)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if ends[mid] + mid < d else (lo, mid)
    return lo


def _model_segment_sum(vals, row_ptr, head=0):
    """The kernel's answer, and per block its (i0, j0, rows, arcs, carry)."""
    vals = [int(v) & M32 for v in vals]
    row_ptr = [int(x) for x in row_ptr]
    n, E = len(row_ptr) - 1, len(vals)
    T, K, items = sk.THREADS, sk.ITEMS_PER_THREAD, sk.ITEMS_PER_BLOCK
    out, stores, blocks = [None] * n, [0] * n, []
    for b in range(-(-(n + E) // items)):
        d0, d1 = b * items, min((b + 1) * items, n + E)
        i0, i1 = _warp_search(row_ptr, n, E, d0), _warp_search(row_ptr, n, E, d1)
        j0, j1 = d0 - i0, d1 - i1
        ni, nj = i1 - i0, j1 - j0
        ends = [row_ptr[i0 + 1 + k] - j0 for k in range(ni)]
        assert all(0 <= e <= nj for e in ends)                     # rows end inside the block
        # staging: chunks of 4 words from the 16-byte boundary below vals + j0
        h = (head + j0) % 4
        stage = {}                                                 # after the ni row ends
        for q in range(0, h + nj, 4):
            for e in range(4):
                if h <= q + e < h + nj:
                    stage[ni + q + e + (q + e) // 16] = vals[j0 + q + e - h]
        assert len(stage) == nj and max(stage, default=0) < items + items // 16 + 9
        tails, flags, firsts, heads = [], [], [], []
        for t in range(T):
            dt = min(t * K, ni + nj)
            dt_end = min(dt + K, ni + nj)
            i = first = _block_search(ends, ni, nj, dt)
            j, acc, head_sum, ended = dt - first, 0, 0, False
            for _ in range(dt, dt_end):
                if i < ni and ends[i] <= j:
                    if ended:
                        out[i0 + i] = acc
                        stores[i0 + i] += 1
                    else:
                        head_sum = acc
                    ended, acc, i = True, 0, i + 1
                else:
                    acc = (acc + stage[ni + h + j + (h + j) // 16]) & M32
                    j += 1
            tails.append(acc)
            flags.append(ended)
            firsts.append(first)
            heads.append(head_sum)
        assert i == ni                                             # the last thread ends at i1
        S = []
        for t in range(T):
            S.append(tails[t] if flags[t] or t == 0 else (tails[t] + S[-1]) & M32)
        for t in range(T):
            if flags[t]:
                out[i0 + firsts[t]] = (heads[t] + (S[t - 1] if t else 0)) & M32
                stores[i0 + firsts[t]] += 1
        blocks.append((i0, j0, ni, nj, (i1, S[-1])))
    assert stores == [1] * n                                       # every row stored once
    for _, _, _, _, (r, v) in blocks:                              # the carry pass
        if v and r < n:
            out[r] = (out[r] + v) & M32
        assert r < n or v == 0
    return np.array(out, np.uint32).view(np.int32), blocks


CHUNK = sk.ITEMS_PER_BLOCK


def _lengths(case, r):
    if case.startswith("E="):
        E = {"E=0": 0, "E=1": 1, "E=chunk-1": CHUNK - 1, "E=chunk": CHUNK,
             "E=chunk+1": CHUNK + 1}[case]
        n = 300 if E else 5000
        return np.bincount(r.integers(0, n, E), minlength=n)
    if case == "one row over many chunks among empty rows":
        lengths = np.zeros(3000, np.int64)
        lengths[1500] = 3 * CHUNK + 17
        return lengths
    if case == "chunk edges on row edges":            # 16 items a row: 256 rows a block
        return np.full(3 * CHUNK // 16, sk.ITEMS_PER_THREAD - 1)
    if case == "a row of a whole chunk":              # its arcs and its end fill a block
        return np.full(3, CHUNK - 1)
    if case == "empty rows at both ends":
        return np.concatenate([np.zeros(5000, np.int64), r.integers(0, 40, 200),
                               np.zeros(5000, np.int64)])
    if case == "every row one arc":
        return np.ones(3 * CHUNK // 2 + 5, np.int64)
    raise KeyError(case)


@pytest.mark.parametrize("head", [0, 1, 3])
@pytest.mark.parametrize("case", ["E=0", "E=1", "E=chunk-1", "E=chunk", "E=chunk+1",
                                  "one row over many chunks among empty rows",
                                  "chunk edges on row edges", "a row of a whole chunk",
                                  "empty rows at both ends", "every row one arc"])
def test_segment_sum_merge_path_model_matches_the_reference(case, head):
    r = np.random.default_rng(len(case) * 10 + head)
    lengths = _lengths(case, r)
    row_ptr = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    E = int(row_ptr[-1])
    vals = r.integers(-2**31, 2**31, E).astype(np.int32)          # sums wrap
    got, blocks = _model_segment_sum(vals, row_ptr, head)
    np.testing.assert_array_equal(got, sk.segment_sum_ref(_t(vals), _t(row_ptr)).numpy())
    seg = np.repeat(np.arange(len(lengths)), lengths)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                          num_segments=len(lengths)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sk.segment_sum(_t(vals), _t(row_ptr)).numpy())
    assert len(blocks) == -(-(len(lengths) + E) // CHUNK)
    if case == "one row over many chunks among empty rows":
        assert sum(row == 1500 for *_, (row, _) in blocks) >= 3   # carried over 3 blocks
    if case in ("chunk edges on row edges", "a row of a whole chunk"):
        assert all(j0 == row_ptr[i0] for i0, j0, *_ in blocks)    # blocks start on row edges


# ------------------------------- wrappers --------------------------------- #

@pytest.mark.parametrize("case", ["dtype", "rank", "strided", "est_shape", "n_iters"])
def test_hindex_wrapper_rejects_what_the_kernel_does_not_take(case):
    nbr = torch.zeros((4, 8), dtype=torch.int32)
    est = torch.zeros(4, dtype=torch.int32)
    args = {"dtype": (nbr.long(), est, 3), "rank": (nbr.view(-1), est, 3),
            "strided": (nbr.t(), torch.zeros(8, dtype=torch.int32), 3),
            "est_shape": (nbr, est[:3], 3), "n_iters": (nbr, est, -1)}[case]
    with pytest.raises(ValueError):
        hk.hindex_rows(*args)


@pytest.mark.parametrize("case", ["dtype", "row_ptr_dtype", "strided", "empty_row_ptr"])
def test_segment_sum_wrapper_rejects_what_the_kernel_does_not_take(case):
    vals = torch.zeros(6, dtype=torch.int32)
    row_ptr = torch.tensor([0, 3, 6])
    args = {"dtype": (vals.float(), row_ptr), "row_ptr_dtype": (vals, row_ptr.int()),
            "strided": (torch.zeros(12, dtype=torch.int32)[::2], row_ptr),
            "empty_row_ptr": (vals, torch.zeros(0, dtype=torch.int64))}[case]
    with pytest.raises(ValueError):
        sk.segment_sum(*args)


def test_csr_layout_rejects_out_of_range_ids():
    with pytest.raises(ValueError):
        sk.csr_layout(np.array([0, 5]), 5)
