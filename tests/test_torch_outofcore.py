"""The port's out-of-core decomposition (``repro_torch.core.outofcore``) against
``repro.core.outofcore.outofcore_decompose``.

On the CPU (the kernels' plain versions) every ``OutOfCoreResult`` and
``OutOfCoreStats`` field must equal the reference's, except the walls
(``ms_per_round``, ``phase_s``'s value), ``peak_rss_bytes`` and the build
counts, on the graphs, budgets and seeds of ``tests/test_outofcore.py``;
cores equal BZ, the bills equal the port's in-memory host loop and fused
runs, stores written by either package decompose identically in the other,
and the flight runs and ``kcore_ooc_*`` metrics equal the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import outofcore as jax_ooc
from repro.graph import blockstore as jax_bs
from repro.graph import generators as jax_gen
from repro.graph.structs import Graph as JaxGraph
from repro.obs import flight as jax_flight
from repro.obs import metrics as jax_metrics
from repro_torch.core import outofcore as ooc
from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import blockstore as bs
from repro_torch.graph import generators as gen
from repro_torch.graph.structs import Graph
from repro_torch.obs import flight, metrics

STATS = ("messages_per_round", "active_per_round", "changed_per_round")
# what the two packages measure on their own clocks and processes
NOT_COMPARED = ("peak_rss_bytes", "ms_per_round")

FAMILIES = {
    "erdos_renyi": dict(n=300, m=1200),
    "barabasi_albert": dict(n=400, m_attach=3),
    "community": dict(n=300, n_blocks=5, deg_in=6, deg_out=1),
    "rmat": dict(scale=8, edge_factor=4),
}


def _assert_bills(a, b):
    np.testing.assert_array_equal(a.core, b.core)
    assert (a.rounds, a.converged) == (b.rounds, b.converged)
    for k in STATS:
        np.testing.assert_array_equal(getattr(a.stats, k), getattr(b.stats, k), err_msg=k)


def _assert_same(port, ref):
    """Every result and stats field but the walls, the peak RSS and the
    build counts."""
    _assert_bills(port, ref)
    assert port.core.dtype == ref.core.dtype
    assert set(port.phase_s) == set(ref.phase_s)
    assert port.dispatch == "torch"
    if ref.block_stats is None:
        assert port.block_stats is None
        return
    got, want = dataclasses.asdict(port.block_stats), dataclasses.asdict(ref.block_stats)
    for k in NOT_COMPARED:
        got.pop(k), want.pop(k)
    assert got == want
    assert port.block_stats.skip_rate == ref.block_stats.skip_rate
    assert set(port.block_stats.to_json()) == set(ref.block_stats.to_json())


def _both(make, **kw):
    """The same call through both packages on the same seeded graph."""
    port = ooc.outofcore_decompose(make(gen), device="cpu", **kw)
    ref = jax_ooc.outofcore_decompose(make(jax_gen), **kw)
    _assert_same(port, ref)
    return port, ref


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_budget_8192_equals_the_reference_host_loop_and_bz(family, seed):
    def make(G):
        return getattr(G, family)(**FAMILIES[family], seed=seed)

    port, _ = _both(make, mem_budget=8192)
    g = make(gen)
    assert port.converged
    np.testing.assert_array_equal(port.core, bz_core_numbers(g))
    _assert_bills(port, kcore_decompose(g, device="cpu"))


def test_no_budget_equals_the_reference_and_the_fused_run():
    def make(G):
        return G.barabasi_albert(500, 3, seed=2)

    port, _ = _both(make, n_blocks=8)
    _assert_bills(port, kcore_decompose(make(gen), fused=True, device="cpu"))
    unplanned, _ = _both(make)
    assert unplanned.block_stats.n_blocks == 8 and unplanned.block_stats.mem_budget is None


def test_budget_4096_cycles_blocks():
    """The reference's acceptance: a budget far below the arc arrays makes
    the LRU evict while the result stays exact."""
    port, _ = _both(lambda G: G.barabasi_albert(600, 4, seed=3), mem_budget=4096)
    st = port.block_stats
    assert st.n_blocks > 1 and st.evictions >= 1 and st.mem_budget == 4096
    assert st.device_block_bytes < st.total_arc_bytes
    np.testing.assert_array_equal(port.core, bz_core_numbers(gen.barabasi_albert(600, 4, seed=3)))


def test_forced_block_count_skips_quiet_blocks():
    port, _ = _both(lambda G: G.community(n=400, n_blocks=8, deg_in=8, deg_out=1, seed=4),
                    n_blocks=16)
    st = port.block_stats
    assert st.blocks_skipped >= 1 and 0.0 < st.skip_rate < 1.0
    assert st.block_rounds + st.blocks_skipped == st.rounds * st.n_blocks


@pytest.mark.parametrize("cap", [1, 3])
def test_max_rounds_cap_stops_unconverged(cap):
    port, _ = _both(lambda G: G.chain(60), n_blocks=4, max_rounds=cap)
    assert not port.converged and port.rounds == cap


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("how", ["path", "open store"])
def test_store_inputs_cross_between_the_packages(tmp_path, writer, how):
    """A store written by either package decomposes identically in both,
    from its directory (degrees rebuilt from the blocks) or opened (with
    ``deg=``), and a store the caller owns survives the run."""
    g, jg = gen.barabasi_albert(300, 3, seed=5), jax_gen.barabasi_albert(300, 3, seed=5)
    if writer == "port":
        bs.BlockStore.create(tmp_path / "s", g, n_blocks=4)
    else:
        jax_bs.BlockStore.create(tmp_path / "s", jg, n_blocks=4)
    if how == "path":
        port = ooc.outofcore_decompose(str(tmp_path / "s"), device="cpu")
        ref = jax_ooc.outofcore_decompose(str(tmp_path / "s"))
    else:
        port = ooc.outofcore_decompose(bs.BlockStore.open(tmp_path / "s"), deg=g.deg,
                                       device="cpu")
        ref = jax_ooc.outofcore_decompose(jax_bs.BlockStore.open(tmp_path / "s"), deg=jg.deg)
    _assert_same(port, ref)
    _assert_bills(port, kcore_decompose(g, device="cpu"))
    assert (tmp_path / "s" / "manifest.json").exists()


def test_deg_on_a_raw_array_store_with_dead_arcs(tmp_path):
    """A store built from masked arrays (a quarter of the edges dead, both
    arcs of each) with the live degrees passed in: equal to the reference
    and to BZ on the live graph."""
    g = gen.erdos_renyi(n=250, m=1000, seed=6)
    rng = np.random.default_rng(6)
    lo, hi = np.minimum(g.src, g.dst), np.maximum(g.src, g.dst)
    dead_keys = np.unique(lo * g.n + hi)
    dead_keys = dead_keys[rng.random(dead_keys.size) < 0.25]
    mask = ~np.isin(lo * g.n + hi, dead_keys)
    deg = np.bincount(g.src[mask], minlength=g.n).astype(np.int32)
    kw = dict(n=g.n, src=g.src, dst=g.dst, arc_mask=mask, n_blocks=4)
    port = ooc.outofcore_decompose(bs.BlockStore.create(tmp_path / "p", **kw), deg=deg,
                                   device="cpu")
    ref = jax_ooc.outofcore_decompose(jax_bs.BlockStore.create(tmp_path / "r", **kw), deg=deg)
    _assert_same(port, ref)
    live = Graph.from_edges(np.stack([g.src[mask], g.dst[mask]], 1), n=g.n)
    np.testing.assert_array_equal(port.core, bz_core_numbers(live))


@pytest.mark.parametrize("make,n_blocks,core", [
    (lambda G: G.complete(12), 3, 11), (lambda G: G.cycle(20), 4, 2), (lambda G: G.star(15), 2, 1),
])
def test_structured_graphs(make, n_blocks, core):
    port, _ = _both(make, n_blocks=n_blocks)
    assert (port.core == core).all()


def test_isolated_vertices_and_the_empty_graph():
    port, _ = _both(lambda G: G.erdos_renyi(n=60, m=40, seed=7), n_blocks=4)
    _assert_bills(port, kcore_decompose(gen.erdos_renyi(n=60, m=40, seed=7), device="cpu"))
    empty = ooc.outofcore_decompose(Graph.from_edges(np.zeros((0, 2), np.int64)), device="cpu")
    _assert_same(empty, jax_ooc.outofcore_decompose(JaxGraph.from_edges(np.zeros((0, 2),
                                                                                  np.int64))))
    assert empty.core.shape == (0,) and empty.converged and empty.rounds == 0


def test_temporary_store_goes_unless_kept(tmp_path):
    g = gen.barabasi_albert(100, 3, seed=8)
    ooc.outofcore_decompose(g, n_blocks=2, store_dir=str(tmp_path), device="cpu")
    assert list(tmp_path.iterdir()) == []
    ooc.outofcore_decompose(g, n_blocks=2, store_dir=str(tmp_path), keep_store=True,
                            device="cpu")
    (kept,) = tmp_path.iterdir()
    assert bs.BlockStore.open(kept / "store").n_blocks == 2


@pytest.fixture
def recorders():
    flight.enable()
    flight.reset()
    jax_flight.enable()
    jax_flight.reset()
    ends = {"port": [], "ref": []}

    def keep(which):
        return lambda ev: ends[which].append(ev) if ev["kind"] == "run_end" else None

    flight.get_recorder().add_observer(keep("port"))
    jax_flight.get_recorder().add_observer(keep("ref"))
    yield ends
    flight.get_recorder()._observers.clear()
    jax_flight.get_recorder()._observers.clear()
    for f in (flight, jax_flight):
        f.disable()
        f.reset()


def _series(records):
    return [(r.engine, r.mode, r.round, r.frontier, r.messages, r.changed, r.est_rises,
             r.drop_hist, r.est_sum) for r in records]


def test_flight_run_equals_the_reference(recorders):
    port, ref = _both(lambda G: G.barabasi_albert(150, 3, seed=9), mem_budget=4096)
    assert len(flight.records()) == port.rounds > 1
    assert _series(flight.records()) == _series(jax_flight.records())
    (got,), (want,) = recorders["port"], recorders["ref"]
    assert got.pop("peak_rss_bytes") > 0 and want.pop("peak_rss_bytes") > 0
    assert got == want
    assert got["mode"] == "out_of_core" and got["converged"]
    assert flight.get_recorder().last_run_rounds == port.rounds


OOC_COUNTERS = ("kcore_ooc_blocks_loaded_total", "kcore_ooc_blocks_skipped_total",
                "kcore_ooc_evictions_total")
OOC_GAUGES = ("kcore_ooc_device_block_bytes", "kcore_ooc_total_arc_bytes",
              "kcore_ooc_cache_peak_bytes", "kcore_block_imbalance")


def test_metrics_equal_the_reference():
    """The eight series the run publishes: the counters move by the same
    amounts and the gauges read the same, but the process's RSS."""
    before = {n: (metrics.counter(n).value, jax_metrics.counter(n).value) for n in OOC_COUNTERS}
    port, _ = _both(lambda G: G.barabasi_albert(150, 3, seed=10), mem_budget=4096)
    for n in OOC_COUNTERS:
        assert (metrics.counter(n).value - before[n][0]
                == jax_metrics.counter(n).value - before[n][1]), n
    for n in OOC_GAUGES:
        assert metrics.gauge(n).value == jax_metrics.gauge(n).value, n
    loaded = metrics.counter("kcore_ooc_blocks_loaded_total").value - before[OOC_COUNTERS[0]][0]
    assert loaded == port.block_stats.blocks_loaded
    assert metrics.gauge("kcore_block_imbalance").value >= 1.0
    assert metrics.gauge("kcore_ooc_peak_rss_bytes").value > 0
    assert jax_metrics.gauge("kcore_ooc_peak_rss_bytes").value > 0


def test_default_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ooc.outofcore_decompose(gen.chain(10), store_dir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []
