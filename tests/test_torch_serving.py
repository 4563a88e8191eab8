"""The port's query server and its snapshot-isolated front end
(``repro_torch.streaming.{server,concurrent}``) against the reference.

The same seeded graphs, event logs, churn batches and requests go through
``repro.streaming`` and ``repro_torch.streaming`` (on the CPU): every
``Response`` (payload, error, ok), the ``stats()`` counters and the metrics
schema must be equal; checkpoints cross between the packages both ways and
continue in lockstep; the serving gate's ``mixed`` ratio reproduces. Reader
threads only collect ``(request, response)`` pairs: every check runs after
they have joined, so no assertion depends on a thread's timing.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro import streaming as jax_streaming
from repro import temporal as jax_temporal
from repro.distribution.compat import make_mesh as jax_make_mesh
from repro.graph import generators as jax_gen
from repro_torch import checkpoint as ckpt
from repro_torch import streaming
from repro_torch import temporal
from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import kcore_decompose
from repro_torch.distribution.compat import make_mesh
from repro_torch.graph import generators as gen
from repro_torch.obs import flight
from repro_torch.streaming import (ConcurrentKCoreServer, KCoreServer, Request, SnapshotBox,
                                   StreamingConfig, random_churn_batch)
from repro_torch.streaming.concurrent import CoreSnapshot

PKG = {"port": (streaming, temporal, gen, ckpt), "reference": (jax_streaming, jax_temporal,
                                                                jax_gen, jax_ckpt)}
WALLS = ("query_wall_s", "update_wall_s")


def _static(pkg, n=200, seed=2, frontier="dense"):
    st, _, g, _ = PKG[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    return st.KCoreServer(g.barabasi_albert(n, 3, seed=seed),
                          st.StreamingConfig(frontier=frontier), **kw)


def _windowed(pkg, n=250, seed=1, ticks=8, frontier="dense"):
    st, tm, _, _ = PKG[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    log = tm.temporal_barabasi_albert(n, 3, seed=seed, remove_frac=0.1)
    stride = max(len(log) // (ticks + 2), 1)
    weng = tm.WindowedKCoreEngine(log, 3 * stride, stride, by="count",
                                  config=st.StreamingConfig(frontier=frontier), **kw)
    return st.KCoreServer(windowed=weng, asof_capacity=ticks + 2)


def _requests(pkg, n, batch, t):
    """Every op, then malformed requests, as one package's Requests."""
    st = PKG[pkg][0]
    R = st.Request
    ids = np.random.default_rng(5).integers(0, n, 16)
    b = None if batch is None else st.EdgeBatch.make(insert=batch.insert, delete=batch.delete)
    return [
        R(op="core", vertices=ids), R(op="in_kcore", vertices=ids, k=2), R(op="members", k=2),
        R(op="max_k"), R(op="core_asof", t=t, vertices=ids[:4]), R(op="core_asof", t=t),
        R(op="update", batch=b), R(op="core", vertices=ids), R(op="members", k=3),
        R(op="core", vertices=[[0, 1], [2, 3]]),
        # malformed: each comes back as a structured error
        R(op="nope"), R(op="core"), R(op="core", vertices=[n]), R(op="core", vertices=[-1]),
        R(op="in_kcore", vertices=[0]), R(op="members"), R(op="core_asof", vertices=[0]),
        R(op="core_asof", t=-1e9, vertices=[0]), R(op="update"),
        R(op="in_kcore", vertices=[0], k="x"), R(op="core", vertices="abc"),
        R(op="core_asof", t=t, vertices=[n + 5]),
    ]


def _same_payload(a, b):
    if isinstance(a, tuple):
        return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b) and a.dtype == b.dtype
    if hasattr(a, "total_messages"):            # an update's BatchResult
        return (np.array_equal(a.core, b.core) and a.total_messages == b.total_messages
                and a.rounds == b.rounds and a.region_size == b.region_size)
    return a == b and type(a) is type(b)


def _same_responses(got, want):
    assert [(r.op, r.ok, r.error, r.version) for r in got] == \
        [(r.op, r.ok, r.error, r.version) for r in want]
    for g, w in zip(got, want):
        assert _same_payload(g.payload, w.payload), g.op


def _counters(stats):
    out = {k: v for k, v in stats.items() if k not in WALLS and k != "latency"}
    out["latency_counts"] = {op: s["count"] for op, s in stats["latency"].items()}
    return out


@pytest.mark.parametrize("mode", ["static", "windowed"])
def test_serve_responses_and_stats_equal_the_reference(mode):
    if mode == "static":
        port, ref = _static("port"), _static("reference")
        batch = jax_streaming.random_churn_batch(ref.engine.graph, 12, 12,
                                                 np.random.default_rng(3))
        t = 1.0
    else:
        port, ref = _windowed("port"), _windowed("reference")
        for _ in range(3):
            wp, wr = port.advance_window(), ref.advance_window()
            assert np.array_equal(wp.core, wr.core) and wp.m == wr.m
        batch = jax_streaming.EdgeBatch.make(insert=[(0, 1)])
        t = float(ref.asof_boundaries()[1])
    _same_responses(port.serve(_requests("port", ref.engine.n, batch, t)),
                    ref.serve(_requests("reference", ref.engine.n, batch, t)))
    assert _counters(port.stats()) == _counters(ref.stats())
    assert np.array_equal(port.asof_boundaries(), ref.asof_boundaries())
    assert port.errors_returned == ref.errors_returned >= 12


def test_metrics_schema_with_zero_request_ops_equals_the_reference():
    port, ref = _static("port", n=60), _static("reference", n=60)

    def schema(srv):
        return {name: sorted((tuple(sorted(e["labels"].items())), e.get("value"),
                              e.get("count")) for e in entries)
                for name, entries in srv.metrics.to_json().items()}

    assert schema(port) == schema(ref)
    lat = port.latency()
    assert set(lat) == set(KCoreServer.OPS)
    assert all(s["count"] == 0 and s["p50"] is None for s in lat.values())
    text = port.metrics.to_prometheus()
    for op in KCoreServer.OPS:
        assert f'server_requests_total{{op="{op}"}} 0.0' in text
    assert 'server_errors_total{op="unknown"} 0.0' in text
    port.serve([Request(op="max_k"), Request(op="nope")])
    assert port.latency()["max_k"]["count"] == 1
    assert port.metrics.counter("server_errors_total", op="unknown").value == 1


def test_server_modes_and_refusals():
    g = gen.barabasi_albert(80, 3, seed=0)
    log = temporal.temporal_barabasi_albert(80, 3, seed=0)
    weng = temporal.WindowedKCoreEngine(log, 60, 20, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        KCoreServer(g, windowed=weng)
    with pytest.raises(ValueError, match="exactly one"):
        KCoreServer()
    for kw in ({"config": StreamingConfig(frontier="compact")}, {"device": "cpu"},
               {"mesh": object()}, {"axis_names": ("model",)}):
        with pytest.raises(ValueError, match="belong to the WindowedKCoreEngine"):
            KCoreServer(windowed=weng, **kw)
    # a mesh runs the static server's engine mesh-native, as the reference's does
    meshed = KCoreServer(g, StreamingConfig(frontier="sharded"),
                         mesh=make_mesh((2,), ("data",), device="cpu"))
    ref = jax_streaming.KCoreServer(jax_gen.barabasi_albert(80, 3, seed=0),
                                    jax_streaming.StreamingConfig(frontier="sharded"),
                                    mesh=jax_make_mesh((1,), ("data",)))
    assert meshed.engine.mesh.size == 2 and meshed.engine.device.type == "cpu"
    assert np.array_equal(meshed.engine.core, ref.engine.core) and meshed.max_k() == ref.max_k()
    srv = KCoreServer(g, device="cpu")
    assert srv.engine.device.type == "cpu"
    assert KCoreServer(windowed=weng).engine is weng.engine
    with pytest.raises(ValueError, match="not constructed over a WindowedKCoreEngine"):
        srv.advance_window()
    with pytest.raises(IndexError):
        srv.core_number([80])


def test_advance_window_request_is_a_structured_error():
    """A mismatch kept on purpose (ROADMAP.md Queue C): the reference's
    ``serve`` sends ``Request(op="advance_window")`` down its update branch,
    which raises ``AttributeError`` through the loop on a static server; the
    port answers a structured error in both modes."""
    port, ref = _static("port", n=40), _static("reference", n=40)
    with pytest.raises(AttributeError):
        ref.serve([jax_streaming.Request(op="advance_window")])
    for srv in (port, _windowed("port", n=60)):
        [resp] = srv.serve([Request(op="advance_window")])
        assert not resp.ok and "advance_window()" in resp.error
        assert srv.metrics.counter("server_errors_total", op="advance_window").value == 1


def test_windowed_server_replay_and_asof_queries():
    log = temporal.temporal_snap_analogue("FC", scale=0.03, seed=0, remove_frac=0.2)
    weng = temporal.WindowedKCoreEngine(log, window=300, stride=120, device="cpu")
    srv = KCoreServer(windowed=weng, asof_capacity=4)
    snaps = []
    for _ in range(5):
        ws = srv.advance_window()
        snaps.append((ws.t_hi, ws.result.core.copy()))
    assert (srv.core == bz_core_numbers(weng.window_graph())).all()
    assert len(srv.asof_ring) == 4
    for t, core in snaps[1:]:
        bt, got = srv.core_asof(t)
        assert bt == t and (got == core).all()
    t_mid = 0.5 * (snaps[2][0] + snaps[3][0])
    bt, got = srv.core_asof(t_mid, vertices=[0, 1, 2])
    assert bt == snaps[2][0] and (got == snaps[2][1][:3]).all()
    with pytest.raises(KeyError):
        srv.core_asof(snaps[0][0])
    with pytest.raises(ValueError, match="advance_window"):
        srv.update(streaming.EdgeBatch.make(insert=[(0, 1)]))
    assert srv.stats()["asof_boundaries"] == 4


# ---------------------------------------------------------------------- #
# seqlock / snapshot isolation
# ---------------------------------------------------------------------- #

class _SlowBox(SnapshotBox):
    """A SnapshotBox whose publication is held open: the version goes odd,
    the swap waits, then the version goes even. A reader entering during the
    window must spin; returning would hand it a torn flip."""

    hold_s = 0.02

    def publish(self, snap):
        with self._write_lock:
            self._version += 1
            time.sleep(self.hold_s)
            self._snap = snap
            time.sleep(self.hold_s)
            self._version += 1
            self.flips += 1


def test_seqlock_readers_never_see_mid_flip_state():
    box = _SlowBox()
    core0 = np.arange(5, dtype=np.int32)
    snaps = [CoreSnapshot(version=i, core=core0 + i, n=5, m=0, max_k=0, asof=None,
                          batches_applied=i, t_hi=None, published_at=time.perf_counter())
             for i in range(1, 4)]
    with pytest.raises(RuntimeError, match="no snapshot published"):
        box.read()
    box.publish(snaps[0])
    stop = threading.Event()
    seen = [[] for _ in range(4)]

    def reader(out):
        while True:
            s = box.read()
            out.append((s.version, s.core.copy()))
            if stop.is_set():
                return

    threads = [threading.Thread(target=reader, args=(seen[i],), daemon=True) for i in range(4)]
    for th in threads:
        th.start()
    for s in snaps[1:]:
        box.publish(s)
    stop.set()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    pairs = [p for out in seen for p in out]
    # every read is one complete snapshot: core == core0 + version
    assert pairs and all((core == core0 + v).all() for v, core in pairs)
    assert {v for v, _ in pairs} <= {1, 2, 3}
    # each reader read once more after the last flip: the newest version
    assert all(out[-1][0] == 3 for out in seen)


def _front(n=200, seed=2, workers=4, **kw):
    return ConcurrentKCoreServer(KCoreServer(gen.barabasi_albert(n, 3, seed=seed), device="cpu"),
                                 read_workers=workers, **kw)


def _verify(pairs, registry) -> int:
    """Each response bit-equal to the registered fixpoint of its version."""
    for req, resp in pairs:
        assert resp.ok, resp.error
        snap = registry[resp.version]
        v = np.asarray(req.vertices) if req.vertices is not None else None
        if req.op == "core":
            assert np.array_equal(resp.payload, snap.core[v])
        elif req.op == "in_kcore":
            assert np.array_equal(resp.payload, snap.core[v] >= req.k)
        elif req.op == "members":
            assert np.array_equal(resp.payload, np.flatnonzero(snap.core >= req.k))
        else:
            assert resp.payload == snap.max_k
    return len(pairs)


def test_reads_during_updates_are_bit_equal_to_their_versions_fixpoint():
    """The reference's hammer test without its race: readers only collect
    (request, response) pairs, and the versions are checked after the join.
    More readers than cores and a short switch interval; the shared read
    counters must lose no update."""
    front = _front(n=300, seed=2)
    registry = {front.snapshot.version: front.snapshot}
    stop = threading.Event()
    outs = [[] for _ in range(12)]

    def reader(seed, out):
        r = np.random.default_rng(seed)
        while True:
            v = r.integers(0, 300, size=16)
            op = ("core", "in_kcore", "members", "max_k")[len(out) % 4]
            req = Request(op=op, vertices=v if op in ("core", "in_kcore") else None,
                          k=2 if op in ("in_kcore", "members") else None)
            out.append((req, front.read(req)))
            if stop.is_set():
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=reader, args=(10 + i, outs[i]), daemon=True)
               for i in range(len(outs))]
    try:
        for th in threads:
            th.start()
        rng = np.random.default_rng(0)
        for _ in range(6):
            front.update(random_churn_batch(front.server.engine.graph, 10, 10, rng))
            snap = front.snapshot
            registry[snap.version] = snap
            assert (snap.core == bz_core_numbers(front.server.engine.graph)).all()
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    pairs = [p for out in outs for p in out]
    assert _verify(pairs, registry) >= len(outs)
    assert front.box.flips == 7 and sorted(registry) == list(range(1, 8))
    st = front.stats()
    assert st["reads_total"] == len(pairs) and st["reads_inflight"] == 0
    for op in ("core", "in_kcore", "members", "max_k"):
        assert st["latency"][op]["count"] == sum(req.op == op for req, _ in pairs)


def test_snapshot_is_a_read_only_host_copy_that_survives_engine_churn():
    front = _front(n=150, seed=3)
    snap = front.snapshot
    before = snap.core.copy()
    eng = front.server.engine
    assert type(snap.core) is np.ndarray and not isinstance(snap.core, torch.Tensor)
    assert snap.core.base is None and not snap.core.flags.writeable
    assert not np.shares_memory(snap.core, eng.core)
    rng = np.random.default_rng(1)
    for _ in range(3):
        front.update(random_churn_batch(front.server.engine.graph, 15, 15, rng))
        assert not np.shares_memory(front.snapshot.core, front.server.engine.core)
    assert (snap.core == before).all()
    assert front.snapshot.version == snap.version + 3
    with pytest.raises(ValueError):
        snap.core[0] = 1


def test_reads_touch_only_the_snapshot_and_engine_n(monkeypatch):
    """A read path that reached the engine's state, torch or the card would
    fail here: the engine is swapped for an object with nothing but ``n``,
    and torch's tensor constructors raise."""
    log = temporal.temporal_barabasi_albert(120, 3, seed=0)
    srv = KCoreServer(windowed=temporal.WindowedKCoreEngine(log, 90, 30, device="cpu"))
    front = ConcurrentKCoreServer(srv, read_workers=2)
    front.advance_window()
    front.advance_window()
    snap = front.snapshot
    t = float(snap.asof.times[0])

    class OnlyN:
        n = srv.engine.n

        def __getattr__(self, name):
            raise AssertionError(f"a read touched engine.{name}")

    def no_torch(*a, **kw):
        raise AssertionError("a read called into torch")

    srv.engine = OnlyN()
    for name in ("as_tensor", "tensor", "from_numpy", "empty", "zeros"):
        monkeypatch.setattr(torch, name, no_torch)
    reqs = [Request(op="core", vertices=[0, 5]), Request(op="in_kcore", vertices=[1], k=1),
            Request(op="members", k=1), Request(op="max_k"),
            Request(op="core_asof", t=t, vertices=[3]), Request(op="core_asof", t=t),
            Request(op="core", vertices=[10 ** 6])]
    out = front.serve_concurrent(reqs) + [front.read(r) for r in reqs]
    assert [r.ok for r in out] == [True] * 6 + [False] + [True] * 6 + [False]
    assert all(r.version == snap.version for r in out if r.ok)
    assert front.handle_query("core", vertices=[0])["payload"] == [int(snap.core[0])]


def test_front_end_leaves_the_switch_interval_alone():
    """The writer holds the interpreter lock through its host patch; the port
    adds no knob for it (reader latency under load is measured on the card)."""
    old = sys.getswitchinterval()
    front = _front(n=80, seed=1, workers=2)
    front.update(random_churn_batch(front.server.engine.graph, 5, 5, np.random.default_rng(0)))
    front.serve_concurrent([Request(op="max_k")] * 4)
    front.drain(save=False)
    assert sys.getswitchinterval() == old


def test_without_a_card_the_servers_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = gen.barabasi_albert(40, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KCoreServer(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConcurrentKCoreServer(KCoreServer(g))
    log = temporal.temporal_barabasi_albert(40, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KCoreServer(windowed=temporal.WindowedKCoreEngine(log, 30, 10))
    assert KCoreServer(g, device="cpu").engine.device.type == "cpu"


# ---------------------------------------------------------------------- #
# structured errors and drain through the worker pool
# ---------------------------------------------------------------------- #

def test_pool_reads_return_structured_errors_equal_to_the_reference():
    def run(st, front):
        R = st.Request
        return front.serve_concurrent([
            R(op="core", vertices=[0, 1]), R(op="core", vertices=[999]),
            R(op="in_kcore", vertices=[0]), R(op="nope"), R(op="update"),
            R(op="core_asof", t=1.0), R(op="core", vertices=[2])])

    port = ConcurrentKCoreServer(_static("port", n=50, seed=4), read_workers=2)
    ref = jax_streaming.ConcurrentKCoreServer(_static("reference", n=50, seed=4), read_workers=2)
    got, want = run(streaming, port), run(jax_streaming, ref)
    _same_responses(got, want)
    assert got[0].ok and got[6].ok and not any(r.ok for r in got[1:6])
    # rejected before a snapshot is acquired: no version; an as-of miss
    # happens after it, so it carries the snapshot's version
    assert "not a read" in got[4].error and all(r.version is None for r in got[1:5])
    assert got[5].version == port.snapshot.version
    assert port.server.metrics.counter("server_errors_total", op="unknown").value == 1


def test_drain_refuses_new_reads_and_is_idempotent(tmp_path):
    front = _front(n=60, seed=5, checkpoint_dir=str(tmp_path / "ck"))
    assert front.read(Request(op="max_k")).ok
    path = front.drain(save=True, step=7)
    assert path and path.endswith("step_000000007") and front.draining
    with pytest.raises(RuntimeError, match="draining"):
        front.submit_read(Request(op="max_k"))
    assert front.handle_query("max_k") == {"op": "max_k", "ok": False,
                                           "error": "server is draining"}
    assert front.drain(save=True, step=7) == path
    assert front.drain(save=False) is None
    st = front.stats()
    assert st["snapshot_version"] == st["snapshot_flips"] == 1 and st["reads_total"] == 1


# ---------------------------------------------------------------------- #
# checkpoints: layout, warm restart, both packages
# ---------------------------------------------------------------------- #

def _layout(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _layout(v, f"{prefix}{k}/")
        else:
            a = np.asarray(v)
            out.append((prefix + k, a.shape, str(a.dtype)))
    return out


@pytest.mark.parametrize("mode", ["static", "windowed"])
def test_state_dict_has_the_reference_layout(mode):
    make = _static if mode == "static" else _windowed
    port, ref = make("port"), make("reference")
    if mode == "windowed":
        for srv in (port, ref):
            srv.advance_window()
            srv.advance_window()
    assert _layout(port.state_dict()) == _layout(ref.state_dict())


def _advance_bills(server, ticks):
    rows = []
    for _ in range(ticks):
        ws = server.advance_window()
        r = ws.result
        rows.append((ws.m, int(r.total_messages), int(r.rounds), r.core.tobytes(),
                     r.stats.messages_per_round.tolist()))
    return rows


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "reference"),
                                           ("reference", "port")])
def test_windowed_drain_checkpoint_resumes_in_lockstep(tmp_path, writer, reader):
    """3 advances under concurrent reads, drain to a checkpoint, restore
    into a fresh server of the other package (no decomposition), 3 more:
    equal to an uninterrupted run of each package in cores and bills."""
    want = _advance_bills(_windowed(reader), 6)
    assert want == _advance_bills(_windowed(writer), 6)
    st = PKG[writer][0]
    a = _windowed(writer)
    front = st.ConcurrentKCoreServer(a, read_workers=2, checkpoint_dir=str(tmp_path))
    first = []
    for _ in range(3):
        ws = front.advance_window()
        out = front.serve_concurrent([st.Request(op="max_k"),
                                      st.Request(op="core", vertices=[0, 1, 2])])
        assert all(r.ok for r in out)
        r = ws.result
        first.append((ws.m, int(r.total_messages), int(r.rounds), r.core.tobytes(),
                      r.stats.messages_per_round.tolist()))
    assert front.drain(save=True, step=3)
    b = _windowed(reader)
    state, step = PKG[reader][3].restore_checkpoint(tmp_path, like=b.state_dict())
    b.load_state_dict(state)
    assert step == 3 and (b.core == a.core).all()
    times = a.asof_boundaries()
    if reader == "reference":
        # the reference's restore hands its leaves to jax without 64-bit
        # mode: float64 times come back as float32 (ROADMAP.md Queue C)
        times = times.astype(np.float32)
    assert np.array_equal(b.asof_boundaries(), times)
    assert first + _advance_bills(b, 3) == want


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_static_checkpoint_crosses_the_packages(tmp_path, writer, reader):
    a = _static(writer, n=120, seed=6, frontier="compact")
    st = PKG[writer][0]
    a.update(st.random_churn_batch(a.engine.graph, 20, 10, np.random.default_rng(7)))
    a.asof_ring.push(1.0, a.core)
    a.asof_ring.push(2.0, a.core)
    PKG[writer][3].save_checkpoint(tmp_path, 1, a.state_dict())
    b = _static(reader, n=120, seed=6, frontier="compact")
    state, _ = PKG[reader][3].restore_checkpoint(tmp_path, like=b.state_dict())
    b.load_state_dict(state)
    assert (b.core == a.core).all() and b.asof_ring.times.tolist() == [1.0, 2.0]
    bt, core = b.core_asof(1.5)
    assert bt == 1.0 and (core == a.core).all()
    batch = jax_streaming.random_churn_batch(jax_gen.barabasi_albert(120, 3, seed=6), 10, 10,
                                             np.random.default_rng(8))
    ra = a.update(st.EdgeBatch.make(insert=batch.insert, delete=batch.delete))
    rb = b.update(PKG[reader][0].EdgeBatch.make(insert=batch.insert, delete=batch.delete))
    assert (ra.core == rb.core).all() and ra.total_messages == rb.total_messages
    assert ra.stats.messages_per_round.tolist() == rb.stats.messages_per_round.tolist()


def test_mode_mismatch_checkpoints_are_rejected():
    static, windowed = _static("port", n=40), _windowed("port")
    with pytest.raises(ValueError, match="taken from a windowed server; this one is static"):
        static.load_state_dict(windowed.state_dict())
    with pytest.raises(ValueError, match="taken from a static server; this one is windowed"):
        windowed.load_state_dict(static.state_dict())
    with pytest.raises(ValueError, match="this one is static"):
        static.load_state_dict(_windowed("reference").state_dict())


# ---------------------------------------------------------------------- #
# flight recorder: snapshot flips, checkpoint saves, watchlist timelines
# ---------------------------------------------------------------------- #

@pytest.fixture
def recorder():
    flight.enable()
    flight.reset()
    yield flight.get_recorder()
    flight.disable()
    flight.reset()
    flight.get_recorder().watch([])
    # watch([]) and reset() keep the old vertices' (emptied) timelines, which a
    # later test in the same process would read back as a watchlist
    flight.get_recorder()._timelines.clear()


def test_flight_records_snapshot_flip_and_checkpoint_events(recorder, tmp_path):
    front = _front(n=80, seed=11, checkpoint_dir=str(tmp_path))
    front.update(random_churn_batch(front.server.engine.graph, 5, 5, np.random.default_rng(3)))
    flips = [e for e in recorder.events() if e["kind"] == "snapshot_flip"]
    assert [e["version"] for e in flips] == [1, 2]
    assert flips[-1]["max_k"] == front.snapshot.max_k and flips[-1]["batch"] == 1
    path = front.drain(step=4)
    ev = recorder.events()[-1]
    assert ev["kind"] == "checkpoint_save" and ev["step"] == 4 and ev["path"] == path
    payload = flight.to_json()
    assert [e["kind"] for e in payload["events"]] == ["snapshot_flip"] * 2 + ["checkpoint_save"]
    assert len(flight.to_json(last=1)["events"]) == 1
    dumped = flight.dump(str(tmp_path / "f.json"))
    assert dumped.endswith("f.json")


def test_watchlist_timelines_equal_the_reference(recorder):
    from repro.obs import flight as jax_flight
    from repro.core import kcore_decompose as jax_decompose

    jax_flight.enable()
    jax_flight.reset()
    try:
        flight.watch([0, 7, 150, 10 ** 6])
        jax_flight.watch([0, 7, 150, 10 ** 6])
        kcore_decompose(gen.barabasi_albert(200, 3, seed=5), device="cpu")
        jax_decompose(jax_gen.barabasi_albert(200, 3, seed=5))
        port, ref = _static("port", n=200, seed=5), _static("reference", n=200, seed=5)
        batch = jax_streaming.random_churn_batch(ref.engine.graph, 15, 15,
                                                 np.random.default_rng(1))
        port.update(streaming.EdgeBatch.make(insert=batch.insert, delete=batch.delete))
        ref.update(batch)
        got, want = flight.get_recorder().timelines(), jax_flight.get_recorder().timelines()
        assert got == want and set(got) == {0, 7, 150, 10 ** 6} and got[10 ** 6] == []
        assert flight.get_recorder().watchlist.tolist() == [0, 7, 150, 10 ** 6]
        assert recorder.trajectory(7) == got[7] and len(got[7]) > 3
        assert flight.to_json()["watch"] == {v: tl for v, tl in got.items()}
    finally:
        jax_flight.get_recorder().watch([])
        jax_flight.get_recorder()._timelines.clear()
        jax_flight.disable()
        jax_flight.reset()


def test_empty_watchlist_samples_nothing(recorder):
    kcore_decompose(gen.barabasi_albert(100, 3, seed=0), device="cpu")
    assert recorder.watchlist.size == 0 and recorder.rounds_recorded > 2
    assert not any(recorder.timelines().values())
    assert flight.to_json()["events"] == []


# ---------------------------------------------------------------------- #
# the serving gate (benchmarks/serving_baseline.json) on the CPU
# ---------------------------------------------------------------------- #

def _gate_reader(front, seed, stop, busy, out, ids_per_read):
    """``benchmarks/serving_mixed.py::_reader``: sampled reads against the
    published snapshot, at least one, until stopped. Here the readers pause
    1 ms between reads: readers that spin hold the interpreter lock so much
    that each of the writer's short torch calls waits for it, and the gate
    took 15-260 s instead of under one on a shared 8-core CPU. ``chip_smoke.py``
    runs the benchmark's spinning readers on the card."""
    rng = np.random.default_rng(seed)
    n = front.server.engine.n
    while True:
        p = rng.random()
        v = rng.integers(0, n, size=ids_per_read)
        snap = front.snapshot
        if p < 0.55:
            req = Request(op="core", vertices=v)
        elif p < 0.75:
            req = Request(op="in_kcore", vertices=v, k=max(snap.max_k - 1, 1))
        elif p < 0.9 and len(snap.asof):
            req = Request(op="core_asof", t=float(rng.choice(snap.asof.times)), vertices=v)
        else:
            req = Request(op="members", k=max(snap.max_k, 1))
        resp = front.read(req)
        out.append((req, resp, busy.is_set()))
        if stop.wait(1e-3):
            return


def test_serving_gate_mixed_ratio_reproduces_on_the_cpu():
    import json
    import pathlib

    base = json.loads((pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
                       / "serving_baseline.json").read_text())
    cfg = base["settings"]
    n0 = gen.SNAP_BY_ABBREV[cfg["trace"]].n
    log = temporal.temporal_snap_analogue(cfg["trace"], scale=cfg["target_n"] / n0, seed=0,
                                          remove_frac=cfg["snap_remove_frac"])
    stride = max(len(log) // (cfg["ticks"] + 2), 1)
    weng = temporal.WindowedKCoreEngine(log, cfg["window_strides"] * stride, stride, by="count",
                                        config=StreamingConfig(frontier=cfg["frontier"]),
                                        device="cpu")
    front = ConcurrentKCoreServer(KCoreServer(windowed=weng, asof_capacity=cfg["ticks"] + 2),
                                  read_workers=cfg["readers"])
    registry = {front.snapshot.version: front.snapshot}
    stop, busy = threading.Event(), threading.Event()
    outs = [[] for _ in range(cfg["readers"])]
    threads = [threading.Thread(target=_gate_reader, daemon=True,
                                args=(front, 1000 + i, stop, busy, outs[i], cfg["ids_per_read"]))
               for i in range(cfg["readers"])]
    ratios, tick = [], 0
    try:
        for th in threads:
            th.start()
        while not weng.done and tick < cfg["ticks"]:
            busy.set()
            ws = front.advance_window()
            busy.clear()
            snap = front.snapshot
            registry[snap.version] = snap
            scratch = kcore_decompose(weng.window_graph(), device="cpu")
            ratios.append(round(ws.result.total_messages
                                / max(scratch.stats.total_messages, 1), 4))
            if tick % cfg["verify_every"] == 0:
                assert (snap.core == bz_core_numbers(weng.window_graph())).all()
            tick += 1
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert round(float(np.mean(ratios)), 4) == base["mean_ratio"]["mixed"] == 1.2018
    checked = 0
    for req, resp, _ in (x for out in outs for x in out):
        if not resp.ok:
            assert req.op == "core_asof", resp.error    # a boundary aged out of the ring
            continue
        snap = registry[resp.version]
        if req.op == "core_asof":
            bt, core = snap.asof.asof(req.t)
            assert resp.payload[0] == bt and np.array_equal(resp.payload[1], core[req.vertices])
        else:
            _verify([(req, resp)], registry)
        checked += 1
    assert checked >= cfg["readers"]
