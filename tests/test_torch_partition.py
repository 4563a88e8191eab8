"""The port's shard layout (``repro_torch.graph.partition``) against
``repro.graph.partition``: the same geometry and the same arrays, dead slots
and padding included, on the grid of ``tests/test_partition.py``."""

import numpy as np
import pytest

from repro.graph import generators as jax_gen
from repro.graph import partition as jax_part
from repro.graph.padding import next_pow2 as jax_next_pow2
from repro_torch.graph import generators as gen
from repro_torch.graph import partition
from repro_torch.graph.padding import next_pow2

FIELDS = ("n_shards", "n_real", "verts_per_shard", "arcs_per_shard", "n_pad")
ARRAYS = ("src", "dst", "arc_mask", "deg", "vert_mask")


def _assert_same(port, ref):
    assert {f: getattr(port, f) for f in FIELDS} == {f: getattr(ref, f) for f in FIELDS}
    for k in ARRAYS:
        a, b = getattr(port, k), getattr(ref, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _arcs(n, seed, dead=0.0):
    """src-sorted arcs with degrees in [0, 5), a ``dead`` share of them
    masked off, as the streaming engine's slot arrays hold them."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 5, n).astype(np.int32)
    src = np.repeat(np.arange(n, dtype=np.int32), deg)
    dst = rng.integers(0, max(n, 1), src.size).astype(np.int32)
    mask = rng.random(src.size) >= dead
    return src, dst, mask, deg


@pytest.mark.parametrize("pow2", [False, True])
@pytest.mark.parametrize("n", [1, 5, 97, 100])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shard_layout_equals_reference(n, n_shards, pow2):
    src, _, _, _ = _arcs(n, n * 31 + n_shards)
    for floor in (0, 64):
        V, A, bounds = partition.shard_layout(n, src, n_shards, pow2=pow2,
                                              min_arcs_per_shard=floor)
        rV, rA, rbounds = jax_part.shard_layout(n, src, n_shards, pow2=pow2,
                                                min_arcs_per_shard=floor)
        assert (V, A) == (rV, rA)
        np.testing.assert_array_equal(bounds, rbounds)


@pytest.mark.parametrize("dead", [0.0, 0.3, 1.0], ids=["live", "dead slots", "all dead"])
@pytest.mark.parametrize("n", [1, 5, 97, 100])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shard_arc_arrays_equal_reference(n, n_shards, dead):
    src, dst, mask, deg = _arcs(n, n * 7 + n_shards, dead)
    for kw in ({}, {"pow2": True}, {"arc_multiple": 16, "min_arcs_per_shard": 40}):
        _assert_same(partition.shard_arc_arrays(n, src, dst, mask, deg, n_shards, **kw),
                     jax_part.shard_arc_arrays(n, src, dst, mask, deg, n_shards, **kw))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 8, 16])
@pytest.mark.parametrize("name", ["ba", "star", "FC", "empty"])
def test_shard_graph_and_balance_equal_reference(name, n_shards):
    make = {"ba": lambda G: G.barabasi_albert(97, 3, seed=0), "star": lambda G: G.star(5),
            "FC": lambda G: G.snap_analogue("FC", 0.02, seed=0),
            "empty": lambda G: G.erdos_renyi(10, 0, seed=0)}[name]
    port = partition.shard_graph(make(gen), n_shards)
    ref = jax_part.shard_graph(make(jax_gen), n_shards)
    _assert_same(port, ref)
    assert partition.balance_report(port) == jax_part.balance_report(ref)


def test_balance_from_counts_equals_reference():
    for real, A in [(np.array([10, 20, 30]), 32), (np.zeros(0), 8), (np.array([0, 0]), 8)]:
        assert partition.balance_from_counts(real, A) == jax_part.balance_from_counts(real, A)


def test_next_pow2_equals_reference():
    for x in [-3, 0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 2**31 - 1]:
        assert next_pow2(x) == jax_next_pow2(x)
