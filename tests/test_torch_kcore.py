"""The port's decomposition against ``repro.core.kcore_decompose``.

Cores, rounds, convergence and the per-round messages, active and changed
counts must be bit-equal between the port (on the CPU, so through the
kernels' plain versions) and the reference, in host-loop and fused mode,
with the reference dispatched both to XLA and to its Pallas kernels
(interpret mode). The flight recorder's series must match too.
"""

import numpy as np
import pytest
import torch

from repro.core import bz_core_numbers as jax_bz
from repro.core import kcore as jax_kcore
from repro.graph import build_ell as jax_build_ell
from repro.graph import generators as jax_gen
from repro.obs import flight as jax_flight
from repro_torch.core import bz, dispatch, kcore
from repro_torch.core.runtime import fused_converge_dense
from repro_torch.graph import build_ell, from_reference
from repro_torch.graph import generators as gen
from repro_torch.obs import flight

GATE_SCALE = 0.02
GRAPHS = {
    "fig1": lambda G: G.fig1_example()[0],
    "chain": lambda G: G.chain(60),
    "star": lambda G: G.star(40),
    "ba": lambda G: G.barabasi_albert(300, 4, seed=1),
    "er": lambda G: G.erdos_renyi(300, 1200, seed=2),
    **{a: (lambda a: lambda G: G.snap_analogue(a, GATE_SCALE, seed=0))(a)
       for a in ("EEN", "G31", "FC", "PTBR", "MGF")},
}
STATS = ("messages_per_round", "active_per_round", "changed_per_round")

_port_cache: dict = {}


def _port(name, fused):
    key = (name, fused)
    if key not in _port_cache:
        _port_cache[key] = kcore.kcore_decompose(GRAPHS[name](gen), fused=fused, device="cpu")
    return _port_cache[key]


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.core, ref.core)
    assert port.rounds == ref.rounds
    assert port.converged == ref.converged
    for k in STATS:
        np.testing.assert_array_equal(getattr(port.stats, k), getattr(ref.stats, k), err_msg=k)


def _same_graph(port, ref):
    assert (port.n, port.m) == (ref.n, ref.m)
    for k in ("src", "dst", "offsets", "deg"):
        a, b = getattr(port, k), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("abbrev", list(gen.SNAP_BY_ABBREV))
def test_snap_analogue_arrays_equal_the_reference(abbrev):
    """Every Table-I analogue (R-MAT, BA, ER, block model, star law) comes
    out array for array as the reference's generator makes it."""
    _same_graph(gen.snap_analogue(abbrev, GATE_SCALE, seed=1),
                jax_gen.snap_analogue(abbrev, GATE_SCALE, seed=1))


def test_from_edges_cleans_like_the_reference():
    """Self loops dropped, both directions of a pair merged, duplicates
    removed, arcs sorted by source then destination; with and without n."""
    from repro.graph import Graph as JaxGraph
    from repro_torch.graph import Graph

    rng = np.random.default_rng(4)
    for edges in [rng.integers(0, 40, (2000, 2)), rng.integers(0, 5000, (30000, 2)),
                  np.array([[3, 3], [1, 1]]), np.array([[2, 0], [0, 2], [2, 0]])]:
        _same_graph(Graph.from_edges(edges), JaxGraph.from_edges(edges))
        _same_graph(Graph.from_edges(edges, n=6000), JaxGraph.from_edges(edges, n=6000))


@pytest.mark.parametrize("dispatch_mode", ["xla", "pallas"])
@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_decomposition_bit_equal_to_reference(name, fused, dispatch_mode):
    ref = jax_kcore.kcore_decompose(GRAPHS[name](jax_gen),
                                    jax_kcore.KCoreConfig(dispatch=dispatch_mode), fused=fused)
    port = _port(name, fused)
    _assert_same(port, ref)
    assert port.dispatch == "torch"


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("cap", [1, 3, 7])
def test_max_rounds_cap(fused, cap):
    ref = jax_kcore.kcore_decompose(jax_gen.chain(60), jax_kcore.KCoreConfig(max_rounds=cap),
                                    fused=fused)
    port = kcore.kcore_decompose(gen.chain(60), kcore.KCoreConfig(max_rounds=cap),
                                 fused=fused, device="cpu")
    assert not port.converged
    _assert_same(port, ref)


@pytest.fixture
def recorders():
    flight.enable()
    flight.reset()
    jax_flight.enable()
    jax_flight.reset()
    yield
    flight.disable()
    flight.reset()
    jax_flight.disable()
    jax_flight.reset()


def _series(records):
    return [(r.round, r.frontier, r.messages, r.changed, r.est_rises, r.drop_hist, r.est_sum)
            for r in records]


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("name", ["fig1", "ba", "EEN"])
def test_flight_series_equal_reference(recorders, name, fused):
    jax_kcore.kcore_decompose(GRAPHS[name](jax_gen), fused=fused)
    kcore.kcore_decompose(GRAPHS[name](gen), fused=fused, device="cpu")
    port, ref = flight.records(), jax_flight.records()
    assert len(port) > 1
    assert _series(port) == _series(ref)
    assert {r.dispatch for r in port[1:]} == {"torch"}


def test_flight_series_equal_across_modes(recorders):
    g = gen.barabasi_albert(200, 3, seed=4)
    kcore.kcore_decompose(g, device="cpu")
    host = _series(flight.records())
    flight.reset()
    kcore.kcore_decompose(g, fused=True, device="cpu")
    fused = _series(flight.records())
    # the fused run's per-round drop histograms are unknown except the last
    assert [s[:4] for s in host] == [s[:4] for s in fused]


def _masked_inputs(seed):
    r = np.random.default_rng(seed)
    g = jax_gen.erdos_renyi(120, 400, seed=seed)
    est = r.integers(0, g.max_deg + 2, g.n).astype(np.int32)
    arc_mask = r.random(g.num_arcs) < 0.8
    active = r.random(g.n) < 0.6
    return g, est, arc_mask, active


@pytest.mark.parametrize("seed", range(4))
def test_masked_round_segment_bit_equal(seed):
    """One masked superstep from an arbitrary state, dead arcs included."""
    import jax.numpy as jnp

    g, est, arc_mask, active = _masked_inputs(seed)
    n_iters = kcore._bs_iters(g.max_deg + 2)
    want = jax_kcore.masked_round_segment(
        jnp.asarray(est), jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(arc_mask),
        jnp.asarray(active), g.n, n_iters)
    pg = from_reference(g)
    got = kcore.masked_round_segment(
        torch.from_numpy(est), torch.from_numpy(pg.src), torch.from_numpy(pg.dst),
        torch.from_numpy(pg.offsets), torch.from_numpy(arc_mask), torch.from_numpy(active), n_iters)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(3))
def test_fused_convergence_contract(seed):
    """``(est', rounds, stopped, final_active, buffers)`` equal to the
    reference's while_loop, including the final unproductive round."""
    import jax.numpy as jnp

    g, est, arc_mask, active = _masked_inputs(seed)
    n_iters, cap = kcore._bs_iters(g.max_deg + 2), g.n + 1
    want = jax_kcore.fused_convergence(
        jnp.asarray(est), jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(arc_mask),
        jnp.asarray(active), jnp.asarray(g.deg), n=g.n, n_iters=n_iters, max_rounds=cap)
    got = kcore.fused_convergence(
        torch.from_numpy(est), torch.from_numpy(g.src), torch.from_numpy(g.dst),
        torch.from_numpy(g.offsets), torch.from_numpy(arc_mask), torch.from_numpy(active),
        torch.from_numpy(g.deg), n_iters, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1], got[2], got[3]) == (int(want[1]), bool(want[2]), int(want[3]))
    for a, b in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["ba", "MGF"])
def test_segment_route_bills_equal_ell_route(name):
    """The ``ell=None`` binary-search route (the streaming slice's) bills
    the same as the ELL route on a from-scratch decomposition."""
    g = GRAPHS[name](gen)
    res = kcore.kcore_decompose(g, fused=True, device="cpu")
    out = fused_converge_dense(g.deg, np.ones(g.n, bool), g.src, g.dst, np.ones(g.num_arcs, bool),
                               g.deg, n=g.n, n_iters=kcore._bs_iters(g.max_deg),
                               max_rounds=g.n + 1, device="cpu", ell=None)
    np.testing.assert_array_equal(out.est, res.core)
    assert out.rounds == res.rounds and out.dispatch == "torch"
    np.testing.assert_array_equal(out.msgs, res.stats.messages_per_round[1:])
    np.testing.assert_array_equal(out.changed, res.stats.changed_per_round[1:])


def test_masked_round_program_rejects_unsorted_arcs():
    g = gen.chain(5)
    plan = dispatch.resolve_plan("cpu")
    with pytest.raises(ValueError, match="sorted"):
        dispatch.masked_round_program(g.n, 3, plan, g.src[::-1], g.dst[::-1])


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_ell_and_bz_equal_reference(name):
    ref = GRAPHS[name](jax_gen)
    port = GRAPHS[name](gen)
    carried = from_reference(ref)
    for k in ("src", "dst", "offsets", "deg"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
        np.testing.assert_array_equal(getattr(carried, k), getattr(ref, k))
    assert (port.n, port.m) == (ref.n, ref.m)
    ell_ref, ell = jax_build_ell(ref), build_ell(port)
    carried_ell = from_reference(ell_ref)
    assert len(ell.buckets) == len(ell_ref.buckets) == len(carried_ell.buckets)
    for b, rb, cb in zip(ell.buckets, ell_ref.buckets, carried_ell.buckets):
        assert b.width == rb.width == cb.width and b.rows_real == rb.rows_real
        np.testing.assert_array_equal(b.nbrs, rb.nbrs)
        np.testing.assert_array_equal(cb.ids, rb.ids)
    np.testing.assert_array_equal(bz.bz_core_numbers(port), jax_bz(ref))


def test_from_reference_rejects_other_objects():
    with pytest.raises(TypeError):
        from_reference(object())


# ------------------------- the other static modes ------------------------- #

# the (mode, backend) pairs of tests/test_kcore_engine.py:35-38, and block_gs
# at the beyond-paper config's 16 blocks (configs/kcore_paper.py)
STATIC_MODES = [("jacobi", "segment", 8), ("jacobi", "ell", 8), ("jacobi", "ell_pallas", 8),
                ("block_gs", "segment", 8), ("block_gs", "segment", 16)]


@pytest.mark.parametrize("mode,backend,n_blocks", STATIC_MODES)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_static_modes_bit_equal_to_reference(name, mode, backend, n_blocks):
    ref = jax_kcore.kcore_decompose(
        GRAPHS[name](jax_gen), jax_kcore.KCoreConfig(mode=mode, backend=backend, n_blocks=n_blocks))
    port = kcore.kcore_decompose(
        GRAPHS[name](gen), kcore.KCoreConfig(mode=mode, backend=backend, n_blocks=n_blocks),
        device="cpu")
    _assert_same(port, ref)
    assert port.converged and port.dispatch == "torch"


@pytest.mark.parametrize("n_blocks", [1, 3, 7, 64])
def test_block_gs_on_awkward_block_counts(n_blocks):
    """n not a multiple of the blocks (padding vertices), one block (= jacobi
    order), and more blocks than a block's vertices fill (empty blocks)."""
    ref = jax_kcore.kcore_decompose(jax_gen.barabasi_albert(97, 3, seed=0),
                                    jax_kcore.KCoreConfig(mode="block_gs", n_blocks=n_blocks))
    port = kcore.kcore_decompose(gen.barabasi_albert(97, 3, seed=0),
                                 kcore.KCoreConfig(mode="block_gs", n_blocks=n_blocks),
                                 device="cpu")
    _assert_same(port, ref)


@pytest.mark.parametrize("mode", ["ell", "block_gs"])
@pytest.mark.parametrize("cap", [1, 4])
def test_other_modes_max_rounds_cap(mode, cap):
    cfg = dict(backend="ell") if mode == "ell" else dict(mode="block_gs")
    ref = jax_kcore.kcore_decompose(jax_gen.chain(60), jax_kcore.KCoreConfig(max_rounds=cap, **cfg))
    port = kcore.kcore_decompose(gen.chain(60), kcore.KCoreConfig(max_rounds=cap, **cfg),
                                 device="cpu")
    assert not port.converged
    _assert_same(port, ref)


@pytest.mark.parametrize("mode,backend", [("jacobi", "ell"), ("jacobi", "ell_pallas"),
                                          ("block_gs", "segment")])
@pytest.mark.parametrize("name", ["fig1", "ba", "EEN"])
def test_other_modes_flight_series_equal_reference(recorders, name, mode, backend):
    jax_kcore.kcore_decompose(GRAPHS[name](jax_gen), jax_kcore.KCoreConfig(mode=mode, backend=backend))
    kcore.kcore_decompose(GRAPHS[name](gen), kcore.KCoreConfig(mode=mode, backend=backend),
                          device="cpu")
    port, ref = flight.records(), jax_flight.records()
    assert len(port) > 1
    assert _series(port) == _series(ref)
    assert {r.mode for r in port} == {f"{mode}/{backend}"}


def test_fused_block_gs_raises_as_the_reference_does():
    with pytest.raises(ValueError, match="requires mode='jacobi'"):
        jax_kcore.kcore_decompose(jax_gen.chain(10), jax_kcore.KCoreConfig(mode="block_gs"),
                                  fused=True)
    with pytest.raises(ValueError, match="requires mode='jacobi'"):
        kcore.kcore_decompose(gen.chain(10), kcore.KCoreConfig(mode="block_gs", fused=True),
                              device="cpu")
    with pytest.raises(ValueError, match="unsupported combo"):
        kcore.kcore_decompose(gen.chain(10), kcore.KCoreConfig(backend="dense"), device="cpu")


def test_paper_configs_equal_the_reference():
    from repro.configs import kcore_paper as jax_paper
    from repro_torch.configs import kcore_paper

    for name in ("CONFIG", "CONFIG_BEYOND"):
        port, ref = getattr(kcore_paper, name), getattr(jax_paper, name)
        assert {f: getattr(port, f) for f in ("mode", "backend", "n_blocks", "max_rounds",
                                              "widths", "fused")} == \
            {f: getattr(ref, f) for f in ("mode", "backend", "n_blocks", "max_rounds",
                                          "widths", "fused")}
    assert kcore_paper.GRAPHS == jax_paper.GRAPHS


@pytest.mark.parametrize("name", ["ba", "FC", "star"])
def test_block_gs_round_program_sweeps_blocks_in_order(name):
    """One round of the staged block-Gauss-Seidel program equals the
    reference's ``_make_round_block_gs`` round from an arbitrary state."""
    import jax.numpy as jnp

    from repro.graph.partition import shard_graph as jax_shard_graph

    g = GRAPHS[name](jax_gen)
    r = np.random.default_rng(3)
    est = r.integers(0, g.max_deg + 2, g.n).astype(np.int32)
    n_iters = kcore._bs_iters(g.max_deg + 2)
    sg = jax_shard_graph(g, 5)
    est_pad = np.zeros(sg.n_pad, np.int32)
    est_pad[:g.n] = est
    want_est, want_ch = jax_kcore._make_round_block_gs(sg, n_iters)(jnp.asarray(est_pad))
    body = dispatch.block_gs_round_program(g.n, g.src, g.dst, 5, n_iters,
                                           dispatch.resolve_plan("cpu"))
    got_est, got_ch, recv = body(torch.from_numpy(est))
    np.testing.assert_array_equal(got_est.numpy(), np.asarray(want_est)[:g.n])
    np.testing.assert_array_equal(got_ch.numpy(), np.asarray(want_ch)[:g.n])
    np.testing.assert_array_equal(recv.numpy(),
                                  jax_kcore._receivers_np(g, np.asarray(want_ch)[:g.n]))
