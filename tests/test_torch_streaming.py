"""The port's streaming engine (``repro_torch.streaming``) against
``repro.streaming``.

The delta layer's arrays, the churn batches, the insertion upper bound, the
seed model and every accounting field of each batch's ``BatchResult`` must
be bit-equal between the port (on the CPU, so through the kernels' plain
versions) and the reference, in each frontier mode; the streaming gate's
nine committed mean ratios must reproduce exactly.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import bz_core_numbers as jax_bz
from repro.core import cost_model as jax_cost
from repro.graph import generators as jax_gen
from repro.obs import flight as jax_flight
from repro.streaming import delta as jax_delta
from repro.streaming import engine as jax_engine
from repro_torch.core import cost_model
from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import from_reference
from repro_torch.graph import generators as gen
from repro_torch.obs import flight, trace
from repro_torch.streaming import delta, engine
from repro_torch.streaming import (EdgeBatch, StreamingConfig, StreamingKCoreEngine,
                                   random_churn_batch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPHS = {
    "ba": lambda G: G.barabasi_albert(300, 4, seed=1),
    "er": lambda G: G.erdos_renyi(300, 1200, seed=2),
    "EEN": lambda G: G.snap_analogue("EEN", 0.05, seed=0),
}
MODES = ("dense", "compact", "fused", "auto")
STATS = ("messages_per_round", "active_per_round", "changed_per_round")
# walls and kernel builds are not accounting (``stage_s`` is the port's own wall)
EXEMPT = {"patch_s", "seed_s", "converge_s", "reconstruct_s", "recompiles", "compile_s",
          "stage_s"}
SLOTS = ("src", "dst", "live", "hole", "row_off", "deg")


def _batch(b):
    return EdgeBatch.make(insert=b.insert, delete=b.delete)


def _assert_batch_equal(port, ref):
    for f in dataclasses.fields(ref):
        if f.name in EXEMPT:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "stats":
            for k in STATS:
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        elif f.name == "delta":
            for k in ("inserted", "deleted", "touched"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
            assert a.compacted == b.compacted
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


# ------------------------------- delta ------------------------------------ #

@pytest.mark.parametrize("n_insert,n_delete", [(12, 12), (0, 5), (7, 0), (3, 10**6)])
@pytest.mark.parametrize("name", ["ba", "EEN", "tiny"])
def test_random_churn_batch_equals_reference(name, n_insert, n_delete):
    make = GRAPHS.get(name, lambda G: G.chain(1))
    g_port, g_ref = make(gen), make(jax_gen)
    r_port, r_ref = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        got = random_churn_batch(g_port, n_insert, n_delete, r_port)
        want = jax_delta.random_churn_batch(g_ref, n_insert, n_delete, r_ref)
        np.testing.assert_array_equal(got.insert, want.insert)
        np.testing.assert_array_equal(got.delete, want.delete)


@pytest.mark.parametrize("slack,min_slack,dead_frac", [(0.3, 4, 0.25), (0.15, 2, 0.2),
                                                      (0.0, 1, 0.05)])
def test_patchable_csr_slots_equal_reference(slack, min_slack, dead_frac):
    """10 random batches with vertex growth, duplicates, self-loops, unknown
    deletes and forced compactions: every slot array, the fragmentation
    bookkeeping and the materialized graph equal the reference's."""
    rng = np.random.default_rng(2)
    g_ref = jax_gen.erdos_renyi(80, 220, seed=0)
    port = delta.PatchableCSR(gen.erdos_renyi(80, 220, seed=0), slack=slack,
                              min_slack=min_slack, compact_dead_frac=dead_frac)
    ref = jax_delta.PatchableCSR(g_ref, slack=slack, min_slack=min_slack,
                                 compact_dead_frac=dead_frac)
    for t in range(10):
        b = jax_delta.random_churn_batch(g_ref, 10, 10 + 5 * (t % 3), rng)
        if t % 3 == 0:   # growth + duplicate + self-loop + unknown delete
            b = jax_delta.EdgeBatch.make(
                insert=np.concatenate([b.insert, [[g_ref.n + 1 + t, 0], [3, 3], [1, 2], [2, 1]]]),
                delete=np.concatenate([b.delete, [[900, 901]]]))
        got, want = port.apply_batch(_batch(b)), ref.apply_batch(b)
        for k in ("inserted", "deleted", "touched"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert got.compacted == want.compacted
        for k in SLOTS:
            np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
        assert (port.n, port.m, port.dead, port.compactions) == \
            (ref.n, ref.m, ref.dead, ref.compactions)
        g_ref = ref.to_graph()
        mat = port.to_graph()
        for k in ("src", "dst", "offsets", "deg"):
            np.testing.assert_array_equal(getattr(mat, k), getattr(g_ref, k), err_msg=k)
        assert (mat.n, mat.m) == (g_ref.n, g_ref.m)
    assert ref.compactions > 0
    state = port.state_dict()
    restored = delta.PatchableCSR.from_state(state, slack=slack, min_slack=min_slack,
                                             compact_dead_frac=dead_frac)
    for k in SLOTS:
        np.testing.assert_array_equal(getattr(restored, k), getattr(port, k))


def test_apply_batch_rebuild_equals_reference():
    rng = np.random.default_rng(4)
    g_port, g_ref = gen.barabasi_albert(120, 3, seed=2), jax_gen.barabasi_albert(120, 3, seed=2)
    for t in range(5):
        b = jax_delta.random_churn_batch(g_ref, 8, 8, rng)
        if t == 2:
            b = jax_delta.EdgeBatch.make(insert=np.concatenate([b.insert, [[130, 4]]]),
                                         delete=b.delete)
        got, want = delta.apply_batch(g_port, _batch(b)), jax_delta.apply_batch(g_ref, b)
        for k in ("inserted", "deleted", "touched"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        for k in ("src", "dst", "offsets", "deg"):
            np.testing.assert_array_equal(getattr(got.graph, k), getattr(want.graph, k))
        g_port, g_ref = got.graph, want.graph


# ---------------------------- upper bound --------------------------------- #

@pytest.mark.parametrize("name", ["er", "ba", "rmat"])
def test_insertion_upper_bound_equals_reference(name):
    """On the patched CSR's slot arrays (dead slots, and rows whose every
    slot is dead or that have no slot live at all), the port's bound equals
    the reference's vectorized bound and its union-find oracle."""
    make = {"er": lambda G: G.erdos_renyi(100, 300, seed=2),
            "ba": lambda G: G.barabasi_albert(120, 3, seed=2),
            "rmat": lambda G: G.rmat(7, 3, seed=1)}[name]
    rng = np.random.default_rng(7)
    g = make(jax_gen)
    csr = jax_delta.PatchableCSR(g, slack=0.5, compact_dead_frac=0.9)
    core = jax_bz(g).astype(np.int64)
    for t in range(4):
        b = jax_delta.random_churn_batch(g, 15, 25, rng)
        if t == 1:   # strip every arc of vertex 0: a row with no live arc
            nbrs = g.dst[g.src == 0]
            b = jax_delta.EdgeBatch.make(insert=b.insert[(b.insert != 0).all(axis=1)],
                                         delete=np.concatenate(
                                             [b.delete, np.stack([np.zeros_like(nbrs), nbrs], 1)]))
        d = csr.apply_batch(b)
        g2 = csr.to_graph()
        oce = np.zeros(g2.n, np.int64)
        oce[: core.shape[0]] = core
        want = jax_engine._insertion_upper_bound_unionfind(g2, oce, d.inserted)
        ref = jax_engine._insertion_upper_bound_arrays(g2.n, csr.src, csr.dst, csr.live,
                                                       csr.deg, oce, d.inserted)
        got = engine._insertion_upper_bound_arrays(g2.n, csr.src, csr.dst, csr.live, csr.deg,
                                                   oce, d.inserted, device="cpu")
        np.testing.assert_array_equal(ref, want)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64
        assert (~csr.live[csr.row_off[0]:csr.row_off[1]]).all() or t != 1
        g, core = g2, jax_bz(g2).astype(np.int64)


def test_warm_start_seed_equals_reference():
    rng = np.random.default_rng(3)
    g_ref = jax_gen.barabasi_albert(150, 3, seed=1)
    core = jax_bz(g_ref)
    for _ in range(4):
        b = jax_delta.random_churn_batch(g_ref, 12, 12, rng)
        d_ref = jax_delta.apply_batch(g_ref, b)
        d_port = delta.apply_batch(from_reference(g_ref), _batch(b))
        got = engine.warm_start_seed(d_port.graph, core, d_port, device="cpu")
        want = jax_engine.warm_start_seed(d_ref.graph, core, d_ref)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
            assert a.dtype == w.dtype
        assert (got[0] >= jax_bz(d_ref.graph)).all()
        g_ref, core = d_ref.graph, jax_bz(d_ref.graph)


# ----------------------------- seed model --------------------------------- #

def test_choose_seed_equals_reference():
    rng = np.random.default_rng(9)
    for trial in range(60):
        n = int(rng.integers(1, 60))
        b = int(rng.integers(0, 40))
        inserted = rng.integers(0, n, (b, 2)).astype(np.int64)
        deg = rng.integers(0, 30, n).astype(np.int32)
        old_core = np.minimum(rng.integers(0, 30, n), deg).astype(np.int64)
        if trial % 3 == 0:
            old_core[:] = 0       # a bulk load: raises of many levels
        model = cost_model.SeedCostModel(degree_seed_rounds=float(rng.integers(4, 20)))
        jmodel = jax_cost.SeedCostModel(degree_seed_rounds=model.degree_seed_rounds)
        got = cost_model.choose_seed(inserted, deg, old_core, model)
        want = jax_cost.choose_seed(inserted, deg, old_core, jmodel)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert cost_model.estimate_ub_passes(inserted, deg, old_core) == \
            jax_cost.estimate_ub_passes(inserted, deg, old_core)


# ------------------------------- engine ----------------------------------- #

_ENGINE_CASES = [(name, mode) for name in GRAPHS for mode in MODES]


@pytest.mark.parametrize("name,mode", _ENGINE_CASES)
def test_engine_batches_equal_reference(name, mode):
    """4 churn batches; every BatchResult field but the walls and the builds
    equals the reference engine's in the same mode."""
    ref = jax_engine.StreamingKCoreEngine(GRAPHS[name](jax_gen),
                                          jax_engine.StreamingConfig(frontier=mode))
    port = StreamingKCoreEngine(GRAPHS[name](gen), StreamingConfig(frontier=mode), device="cpu")
    np.testing.assert_array_equal(port.core, ref.core)
    rng = np.random.default_rng(5)
    for t in range(4):
        b = jax_delta.random_churn_batch(ref.graph, 12 + 20 * (t == 3), 12, rng)
        got, want = port.apply_batch(_batch(b)), ref.apply_batch(b)
        _assert_batch_equal(got, want)
        assert got.converged and got.flag_reads >= got.rounds
        np.testing.assert_array_equal(got.core, bz_core_numbers(port.graph))
        if mode == "auto":
            assert got.mode in ("compact", "fused")


@pytest.mark.parametrize("mode", MODES)
def test_engine_grows_the_vertex_set(mode):
    ref = jax_engine.StreamingKCoreEngine(jax_gen.barabasi_albert(100, 3, seed=0),
                                          jax_engine.StreamingConfig(frontier=mode))
    port = StreamingKCoreEngine(gen.barabasi_albert(100, 3, seed=0),
                                StreamingConfig(frontier=mode), device="cpu")
    new = np.stack([np.arange(100, 112), np.arange(0, 12)], 1)
    clique = np.array([(i, j) for i in range(112, 118) for j in range(i + 1, 118)])
    for b in (jax_delta.EdgeBatch.make(insert=new),
              jax_delta.EdgeBatch.make(insert=clique, delete=[(0, 1), (5, 7)])):
        got, want = port.apply_batch(_batch(b)), ref.apply_batch(b)
        _assert_batch_equal(got, want)
    assert port.n == ref.n == 118
    assert (port.core[112:] == 5).all()


@pytest.mark.parametrize("mode", MODES)
def test_engine_deletes_every_edge(mode):
    ref = jax_engine.StreamingKCoreEngine(jax_gen.barabasi_albert(60, 3, seed=4),
                                          jax_engine.StreamingConfig(frontier=mode))
    port = StreamingKCoreEngine(gen.barabasi_albert(60, 3, seed=4),
                                StreamingConfig(frontier=mode), device="cpu")
    b = jax_delta.EdgeBatch.make(delete=jax_delta.canonical_edges(ref.graph))
    got, want = port.apply_batch(_batch(b)), ref.apply_batch(b)
    _assert_batch_equal(got, want)
    assert (got.core == 0).all() and port.m == 0
    b = jax_delta.EdgeBatch.make(insert=[(0, 1), (1, 2), (2, 0)])
    _assert_batch_equal(port.apply_batch(_batch(b)), ref.apply_batch(b))


def test_empty_batch_is_free():
    eng = StreamingKCoreEngine(gen.barabasi_albert(100, 3, seed=0), device="cpu")
    res = eng.apply_batch(EdgeBatch.make())
    assert res.total_messages == 0 and res.rounds == 0 and res.flag_reads == 0
    np.testing.assert_array_equal(res.core, eng.init_result.core)


@pytest.mark.parametrize("mode", MODES)
def test_state_dict_round_trip_continues_in_lockstep(mode):
    g = gen.snap_analogue("EEN", 0.05, seed=0)
    a = StreamingKCoreEngine(g, StreamingConfig(frontier=mode), device="cpu")
    rng = np.random.default_rng(1)
    a.apply_batch(random_churn_batch(a.graph, 10, 10, rng))
    b = StreamingKCoreEngine.from_state_dict(a.state_dict(), StreamingConfig(frontier=mode),
                                             device="cpu")
    assert b.init_result is None and b.batches_applied == a.batches_applied == 1
    for _ in range(3):
        batch = random_churn_batch(a.graph, 10, 10, rng)
        ra, rb = a.apply_batch(batch), b.apply_batch(batch)
        _assert_batch_equal(rb, ra)
        for k in SLOTS:
            np.testing.assert_array_equal(getattr(a.csr, k), getattr(b.csr, k))
    assert a.state_dict()["n_iters_hwm"] == b.state_dict()["n_iters_hwm"]


@pytest.mark.parametrize("frontier", ["sharded", "fused"])
def test_sharded_modes_equal_the_reference_engine(frontier):
    """``sharded`` with no mesh (a one-shard mesh) and ``fused`` on a mesh
    (``fused_sharded``), built and restored through ``from_state_dict``:
    every ``BatchResult`` field and the state equal the reference's on its
    one-device mesh."""
    from repro.distribution.compat import make_mesh as jax_make_mesh
    from repro_torch.distribution.compat import make_mesh

    g = GRAPHS["ba"](jax_gen)
    mesh = None if frontier == "sharded" else make_mesh((3,), ("data",), device="cpu")
    port = StreamingKCoreEngine(from_reference(g), StreamingConfig(frontier=frontier), mesh=mesh,
                                device="cpu")
    ref = jax_engine.StreamingKCoreEngine(g, jax_engine.StreamingConfig(frontier=frontier),
                                          mesh=jax_make_mesh((1,), ("data",)))
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = jax_delta.random_churn_batch(ref.graph, 10, 10, rng)
        want = ref.apply_batch(batch)
        got = port.apply_batch(_batch(batch))
        assert got.mode == want.mode == ("sharded" if frontier == "sharded" else "fused_sharded")
        _assert_batch_equal(got, want)
        if i == 0:
            port = StreamingKCoreEngine.from_state_dict(
                port.state_dict(), StreamingConfig(frontier=frontier), mesh=mesh, device="cpu")
    state, ref_state = port.state_dict(), ref.state_dict()
    # the arc block's floor is the shard geometry's: equal on equal shard counts
    same = ("shard_A_floor",) if port.mesh.size == 1 else ()
    for k in ("arc_pad_hwm", "n_iters_hwm", "batches_applied", "core", *same):
        np.testing.assert_array_equal(state[k], ref_state[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown frontier"):
        StreamingKCoreEngine(from_reference(g), StreamingConfig(frontier="nope"), device="cpu")


@pytest.fixture
def recorders():
    for f in (flight, jax_flight):
        f.enable()
        f.reset()
    yield
    for f in (flight, jax_flight):
        f.disable()
        f.reset()


@pytest.mark.parametrize("mode", ["dense", "fused"])
def test_streaming_flight_series_equal_reference(recorders, mode):
    g_port, g_ref = gen.barabasi_albert(200, 3, seed=2), jax_gen.barabasi_albert(200, 3, seed=2)
    port = StreamingKCoreEngine(g_port, StreamingConfig(frontier=mode), device="cpu")
    ref = jax_engine.StreamingKCoreEngine(g_ref, jax_engine.StreamingConfig(frontier=mode))
    rng = np.random.default_rng(7)
    for _ in range(3):
        b = jax_delta.random_churn_batch(ref.graph, 10, 10, rng)
        port.apply_batch(_batch(b))
        ref.apply_batch(b)

    def series(records):
        return [(r.engine, r.mode, r.batch, r.round, r.frontier, r.messages, r.changed,
                 r.est_rises, r.drop_hist, r.est_sum) for r in records if r.engine == "streaming"]

    got, want = series(flight.records()), series(jax_flight.records())
    assert len(got) >= 3 and got == want


def test_batch_spans_match_the_reference():
    trace.enable()
    trace.reset()
    try:
        eng = StreamingKCoreEngine(gen.barabasi_albert(120, 3, seed=1), device="cpu")
        eng.apply_batch(random_churn_batch(eng.graph, 8, 8, np.random.default_rng(0)))
        names = {e["name"] for e in trace.events()}
    finally:
        trace.disable()
        trace.reset()
    assert {"batch", "csr-patch", "seed", "converge", "host-reconstruct", "kcore.round"} <= names


# ------------------------------ the gate ---------------------------------- #

BASELINE = json.loads((ROOT / "benchmarks" / "streaming_baseline.json").read_text())
GATE = BASELINE["settings"]


@pytest.mark.parametrize("churn", GATE["churn_rates"])
@pytest.mark.parametrize("abbrev", GATE["graphs"])
def test_streaming_gate_ratio_reproduces(abbrev, churn):
    """``benchmarks/streaming_maintenance.py``'s loop at the committed
    baseline's settings, on the port's dense engine: the mean
    incremental-over-scratch message ratio equals the baseline's."""
    scale = GATE["target_n"] / gen.SNAP_BY_ABBREV[abbrev].n
    eng = StreamingKCoreEngine(gen.snap_analogue(abbrev, scale=scale, seed=0), device="cpu")
    rng = np.random.default_rng(1)
    ratios = []
    for _ in range(GATE["batches"]):
        g_before = eng.graph
        b = max(2, int(churn * g_before.m))
        res = eng.apply_batch(random_churn_batch(g_before, b // 2, b - b // 2, rng))
        scratch = kcore_decompose(eng.graph, device="cpu")
        np.testing.assert_array_equal(res.core, bz_core_numbers(eng.graph))
        ratios.append(round(res.total_messages / max(scratch.stats.total_messages, 1), 4))
    assert round(float(np.mean(ratios)), 4) == BASELINE["mean_ratio"][f"{abbrev}/{churn}"]


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingKCoreEngine(gen.chain(5))
