"""The port's block store (``repro_torch.graph.blockstore``) against
``repro.graph.blockstore``: the same manifest and files, the same padded
blocks (equal to the port's ``shard_arc_arrays`` too), stores that open in
either package, the same ``BlockCache`` counters over the same accesses and
the same ``plan_blocks`` choices, on the graphs of ``tests/test_blockstore.py``."""

import json

import numpy as np
import pytest

from repro.graph import blockstore as jax_bs
from repro.graph import generators as jax_gen
from repro_torch.graph import blockstore as bs
from repro_torch.graph import generators as gen
from repro_torch.graph.partition import balance_report, shard_arc_arrays, shard_graph

BLOCK_ARRAYS = ("src", "dst", "mask")


def _assert_blocks_equal(a, b):
    assert (a.bid, a.arcs_real, a.nbytes) == (b.bid, b.arcs_real, b.nbytes)
    for k in BLOCK_ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _manifest(store):
    return json.loads((store.path / bs.MANIFEST).read_text())


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_store_equals_the_reference_and_shard_arc_arrays(tmp_path, n_blocks):
    g, jg = gen.barabasi_albert(123, 3, seed=5), jax_gen.barabasi_albert(123, 3, seed=5)
    port = bs.BlockStore.create(tmp_path / "p", g, n_blocks=n_blocks)
    ref = jax_bs.BlockStore.create(tmp_path / "r", jg, n_blocks=n_blocks)
    assert _manifest(port) == _manifest(ref)
    assert sorted(f.name for f in port.path.iterdir()) == sorted(f.name for f in ref.path.iterdir())
    sg = shard_arc_arrays(g.n, g.src, g.dst, np.ones(g.num_arcs, bool), g.deg, n_blocks)
    assert (port.V, port.A, port.n_pad) == (sg.verts_per_shard, sg.arcs_per_shard, sg.n_pad)
    for b in range(n_blocks):
        blk = port.block(b)
        _assert_blocks_equal(blk, ref.block(b))
        for k, want in zip(BLOCK_ARRAYS, (sg.src[b], sg.dst[b], sg.arc_mask[b])):
            np.testing.assert_array_equal(getattr(blk, k), want, err_msg=k)
        assert port.vertex_range(b) == ref.vertex_range(b)
    assert (port.total_arc_bytes, port.block_arc_bytes) == (ref.total_arc_bytes,
                                                             ref.block_arc_bytes)
    assert port.total_arc_bytes == g.num_arcs * bs.ARC_SLOT_BYTES == jax_bs.ARC_SLOT_BYTES * g.num_arcs
    assert port.balance() == ref.balance() == balance_report(shard_graph(g, n_blocks))
    with pytest.raises(IndexError):
        port.block(n_blocks)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_cross_between_the_packages(tmp_path, writer):
    g, jg = gen.erdos_renyi(n=200, m=800, seed=1), jax_gen.erdos_renyi(n=200, m=800, seed=1)
    if writer == "port":
        bs.BlockStore.create(tmp_path / "s", g, n_blocks=4)
    else:
        jax_bs.BlockStore.create(tmp_path / "s", jg, n_blocks=4)
    port, ref = bs.BlockStore.open(tmp_path / "s"), jax_bs.BlockStore.open(tmp_path / "s")
    for k in ("n", "n_blocks", "V", "A", "num_arcs"):
        assert getattr(port, k) == getattr(ref, k), k
    np.testing.assert_array_equal(port.arcs_per_block, ref.arcs_per_block)
    np.testing.assert_array_equal(port.live_per_block, ref.live_per_block)
    for b in range(4):
        _assert_blocks_equal(port.block(b), ref.block(b))
    raw_src, _, raw_mask = port.block_raw(0)
    assert raw_src.shape[0] == port.arcs_per_block[0]
    assert isinstance(raw_src, np.memmap) and raw_mask.dtype == bool


# access sequences of tests/test_blockstore.py: (n_blocks, budget from one block's bytes, gets)
CACHE_CASES = {
    "budget": (8, lambda block: 2 * block, [*range(8), 7, 6, 0]),
    "recency": (4, lambda block: 2 * block, [0, 1, 0, 2, 0]),
    "over-budget": (2, lambda block: 1, [0, 1, 0]),
    "unbounded": (8, lambda block: None, [*range(8), 3, 3]),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_cache_counters_equal_the_reference(tmp_path, case):
    n_blocks, budget, gets = CACHE_CASES[case]
    port = bs.BlockStore.create(tmp_path / "p", gen.barabasi_albert(200, 3, seed=3),
                                n_blocks=n_blocks)
    ref = jax_bs.BlockStore.create(tmp_path / "r", jax_gen.barabasi_albert(200, 3, seed=3),
                                   n_blocks=n_blocks)
    nbytes = budget(port.block_arc_bytes)
    pc, rc = bs.BlockCache(port, budget_bytes=nbytes), jax_bs.BlockCache(ref, budget_bytes=nbytes)
    assert pc.stats() == rc.stats()
    for b in gets:
        _assert_blocks_equal(pc.get(b), rc.get(b))
        assert pc.stats() == rc.stats(), b
    s = pc.stats()
    assert s["over_budget"] == (case == "over-budget")
    assert (s["evictions"] == 0) == (case == "unbounded")
    if case == "recency":
        assert s["hits"] == 2   # block 0 touched before block 2 evicted block 1
    if case == "over-budget":
        assert s["resident_blocks"] == 1 and s["loads"] == 3


@pytest.mark.parametrize("budget", [None, 1, 4096, 64 * 1024, 10**9])
@pytest.mark.parametrize("graph", ["ba", "star"])
def test_plan_blocks_equals_the_reference(graph, budget):
    make = {"ba": lambda G: G.barabasi_albert(2000, 4, seed=7), "star": lambda G: G.star(50)}[graph]
    g, jg = make(gen), make(jax_gen)
    for max_blocks in (64, 4096):
        got = bs.plan_blocks(g.n, g.src, budget, max_blocks=max_blocks)
        assert got == jax_bs.plan_blocks(jg.n, jg.src, budget, max_blocks=max_blocks)
        assert got <= max_blocks


def test_create_from_raw_arrays_with_dead_slots(tmp_path):
    """Masked (dead) arcs persist through the store, as the reference's do."""
    src = np.array([0, 0, 1, 2, 2, 3], np.int32)
    dst = np.array([1, 2, 0, 0, 3, 2], np.int32)
    mask = np.array([True, True, True, True, False, False])
    port = bs.BlockStore.create(tmp_path / "p", n=4, src=src, dst=dst, arc_mask=mask, n_blocks=2)
    ref = jax_bs.BlockStore.create(tmp_path / "r", n=4, src=src, dst=dst, arc_mask=mask,
                                   n_blocks=2)
    assert _manifest(port) == _manifest(ref)
    assert int(port.live_per_block.sum()) == 4
    sg = shard_arc_arrays(4, src, dst, mask, np.zeros(4, np.int32), 2)
    for b in range(2):
        _assert_blocks_equal(port.block(b), ref.block(b))
        np.testing.assert_array_equal(port.block(b).mask, sg.arc_mask[b])
    with pytest.raises(ValueError, match="n/src/dst"):
        bs.BlockStore.create(tmp_path / "q", n=4, src=src)


def test_overwrite_guard_and_version_refusal(tmp_path):
    g = gen.star(10)
    bs.BlockStore.create(tmp_path / "s", g, n_blocks=2)
    with pytest.raises(FileExistsError):
        bs.BlockStore.create(tmp_path / "s", g, n_blocks=2)
    store = bs.BlockStore.create(tmp_path / "s", g, n_blocks=4, overwrite=True)
    assert bs.BlockStore.open(tmp_path / "s").n_blocks == 4
    manifest = store.path / bs.MANIFEST
    manifest.write_text(manifest.read_text().replace('"version": 1', '"version": 99'))
    with pytest.raises(ValueError, match="version"):
        bs.BlockStore.open(tmp_path / "s")
    with pytest.raises(ValueError, match="version"):
        jax_bs.BlockStore.open(tmp_path / "s")
    store.delete()
    assert not store.path.exists()
