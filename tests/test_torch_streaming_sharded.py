"""The port's mesh-native streaming (``sharded``, ``fused_sharded`` and
``auto`` on a mesh) against ``repro.streaming``.

Every ``BatchResult`` accounting field of insert-only, delete-only and
mixed batches equals the reference dense engine's (which the reference
holds its sharded modes equal to) on 1-, 4- and 2x2-shard meshes; the
reference's own sharded and fused engines on forced 4-device meshes run
once, in one subprocess for the whole file, and the port's bills and
``state_dict`` high-water marks equal theirs. A sharded engine's checkpoint
crosses the packages both ways; the sliding window, ``replay`` and
``KCoreServer`` take a mesh as the reference's do.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro import checkpoint as jax_ckpt
from repro import streaming as jax_streaming
from repro import temporal as jax_temporal
from repro.core import bz_core_numbers as jax_bz
from repro.distribution.compat import make_mesh as jax_make_mesh
from repro.graph import generators as jax_gen
from repro_torch import checkpoint as ckpt
from repro_torch import temporal
from repro_torch.distribution.compat import make_mesh
from repro_torch.graph import from_reference
from repro_torch.streaming import (EdgeBatch, KCoreServer, Request, StreamingConfig,
                                   StreamingKCoreEngine)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS = ("messages_per_round", "active_per_round", "changed_per_round")
# walls and kernel builds are not accounting; ``mode`` names where the batch ran
EXEMPT = {"patch_s", "seed_s", "converge_s", "reconstruct_s", "recompiles", "compile_s",
          "stage_s", "mode"}
MESHES = {"1": ((1,), ("data",)), "4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model"))}
SCALARS = ("batches_applied", "arc_pad_hwm", "n_iters_hwm", "shard_A_floor")


def _assert_batch_equal(port, ref, mode):
    assert port.mode == mode
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


def _batches(g, rng):
    """One insert-only, one delete-only and one mixed batch (the reference
    suite's), as reference ``EdgeBatch``es."""
    edges = jax_streaming.canonical_edges(g)
    return {
        "insert": jax_streaming.EdgeBatch.make(insert=rng.integers(0, g.n, size=(15, 2))),
        "delete": jax_streaming.EdgeBatch.make(
            delete=edges[rng.choice(edges.shape[0], 15, replace=False)]),
        "mixed": jax_streaming.random_churn_batch(g, 12, 12, rng),
    }


def _port(b):
    return EdgeBatch.make(insert=b.insert, delete=b.delete)


@pytest.fixture(scope="module")
def dense_reference():
    """The reference dense engine's initial decomposition and its result for
    each kind of batch, over ``barabasi_albert(250, 4, seed=5)``."""
    g = jax_gen.barabasi_albert(250, 4, seed=5)
    out = {}
    for kind, batch in _batches(g, np.random.default_rng(6)).items():
        eng = jax_streaming.StreamingKCoreEngine(g)
        out[kind] = (batch, eng.apply_batch(batch), jax_bz(eng.graph))
    return g, eng.init_result, out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("frontier", ["sharded", "fused", "auto"])
@pytest.mark.parametrize("kind", ["insert", "delete", "mixed"])
def test_mesh_batches_equal_the_reference_dense_engine(dense_reference, kind, frontier,
                                                       mesh_name):
    g, init, results = dense_reference
    shape, axes = MESHES[mesh_name]
    eng = StreamingKCoreEngine(from_reference(g), StreamingConfig(frontier=frontier),
                               mesh=make_mesh(shape, axes, device="cpu"), axis_names=axes)
    assert eng.init_result.stats.total_messages == init.stats.total_messages
    np.testing.assert_array_equal(eng.core, init.core)
    batch, want, bz = results[kind]
    got = eng.apply_batch(_port(batch))
    mode = {"sharded": "sharded", "fused": "fused_sharded"}.get(frontier, got.mode)
    assert mode in ("sharded", "fused_sharded", "compact")
    _assert_batch_equal(got, want, mode)
    np.testing.assert_array_equal(got.core, bz)


def test_auto_picks_compact_and_fused_sharded_as_the_reference_does():
    g = jax_gen.barabasi_albert(300, 4, seed=8)
    ref = jax_streaming.StreamingKCoreEngine(
        g, jax_streaming.StreamingConfig(frontier="auto", compact_threshold=0.02),
        mesh=jax_make_mesh((1,), ("data",)))
    port = StreamingKCoreEngine(from_reference(g),
                                StreamingConfig(frontier="auto", compact_threshold=0.02),
                                mesh=make_mesh((4,), ("data",), device="cpu"))
    rng = np.random.default_rng(9)
    modes = []
    for batch in (jax_streaming.EdgeBatch.make(delete=jax_streaming.canonical_edges(g)[:1]),
                  jax_streaming.random_churn_batch(g, 60, 60, rng)):
        want = ref.apply_batch(batch)
        got = port.apply_batch(_port(batch))
        _assert_batch_equal(got, want, want.mode)
        modes.append(got.mode)
    assert modes == ["compact", "fused_sharded"]


_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import numpy as np
from repro.distribution.compat import make_mesh
from repro.graph import generators as gen
from repro.streaming import (EdgeBatch, StreamingConfig, StreamingKCoreEngine,
                             canonical_edges, random_churn_batch)

g = gen.barabasi_albert(400, 4, seed=2)
rng = np.random.default_rng(0)
edges = canonical_edges(g)
batches = [EdgeBatch.make(insert=rng.integers(0, g.n, size=(15, 2))),
           EdgeBatch.make(delete=edges[rng.choice(edges.shape[0], 15, replace=False)]),
           random_churn_batch(g, 12, 12, rng)]
out = {"batches": [[b.insert.tolist(), b.delete.tolist()] for b in batches]}
for name, shape, axes in [("4", (4,), ("data",)), ("2x2", (2, 2), ("data", "model"))]:
    mesh = make_mesh(shape, axes)
    for frontier in ("sharded", "fused"):
        eng = StreamingKCoreEngine(g, StreamingConfig(frontier=frontier), mesh=mesh,
                                   axis_names=axes)
        rows = []
        for b in batches:
            r = eng.apply_batch(b)
            rows.append({"mode": r.mode, "rounds": r.rounds, "core": r.core.tolist(),
                         **{k: getattr(r.stats, k).tolist() for k in %r}})
        state = eng.state_dict()
        out[f"{name}/{frontier}"] = {"rows": rows, **{k: int(state[k]) for k in %r}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference's sharded and fused engines on forced 4-device meshes,
    three batches each: one subprocess."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT % (STATS, SCALARS)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("frontier", ["sharded", "fused"])
@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
def test_bills_and_high_water_marks_equal_the_reference_sharded_engine(ref_sharded, mesh_name,
                                                                       frontier):
    shape, axes = MESHES[mesh_name]
    eng = StreamingKCoreEngine(gen_ba400(), StreamingConfig(frontier=frontier),
                               mesh=make_mesh(shape, axes, device="cpu"), axis_names=axes)
    want = ref_sharded[f"{mesh_name}/{frontier}"]
    for (ins, dele), row in zip(ref_sharded["batches"], want["rows"]):
        got = eng.apply_batch(EdgeBatch.make(insert=np.asarray(ins, np.int64).reshape(-1, 2),
                                             delete=np.asarray(dele, np.int64).reshape(-1, 2)))
        assert (got.mode, got.rounds) == (row["mode"], row["rounds"])
        np.testing.assert_array_equal(got.core, row["core"])
        for k in STATS:
            np.testing.assert_array_equal(getattr(got.stats, k), row[k], err_msg=k)
    state = eng.state_dict()
    assert {k: int(state[k]) for k in SCALARS} == {k: want[k] for k in SCALARS}
    assert want["shard_A_floor"] > 0


def gen_ba400():
    return from_reference(jax_gen.barabasi_albert(400, 4, seed=2))


def _flat(state, prefix=""):
    out = {}
    for k, v in state.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("frontier", ["sharded", "fused"])
def test_sharded_checkpoint_crosses_the_packages(tmp_path, frontier, writer):
    """After the same batches a sharded engine's ``state_dict`` has the
    reference's leaves and values (``shard_A_floor`` among them); written by
    either package it restores in the other, and both continue in lockstep."""
    g = jax_gen.barabasi_albert(200, 3, seed=1)
    cfg, jcfg = StreamingConfig(frontier=frontier), jax_streaming.StreamingConfig(frontier=frontier)
    jmesh, mesh = jax_make_mesh((1,), ("data",)), make_mesh((1,), ("data",), device="cpu")
    ref = jax_streaming.StreamingKCoreEngine(g, jcfg, mesh=jmesh)
    port = StreamingKCoreEngine(from_reference(g), cfg, mesh=mesh)
    rng = np.random.default_rng(3)
    for _ in range(2):
        batch = jax_streaming.random_churn_batch(ref.graph, 8, 8, rng)
        ref.apply_batch(batch)
        port.apply_batch(_port(batch))
    want, got = _flat(ref.state_dict()), _flat(port.state_dict())
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert int(got["shard_A_floor"]) > 0
    if writer == "reference":
        jax_ckpt.save_checkpoint(tmp_path, 2, ref.state_dict())
        state, _ = ckpt.restore_checkpoint(tmp_path, port.state_dict())
        ref2, port2 = ref, StreamingKCoreEngine.from_state_dict(
            state, cfg, mesh=make_mesh((4,), ("data",), device="cpu"))
    else:
        ckpt.save_checkpoint(tmp_path, 2, port.state_dict())
        state, _ = jax_ckpt.restore_checkpoint(tmp_path, ref.state_dict())
        ref2 = jax_streaming.StreamingKCoreEngine.from_state_dict(
            {"csr": {k: np.asarray(v) for k, v in state["csr"].items()},
             **{k: np.asarray(v) for k, v in state.items() if k != "csr"}}, jcfg, mesh=jmesh)
        port2 = port
    for _ in range(2):
        batch = jax_streaming.random_churn_batch(ref2.graph, 8, 8, rng)
        want_r = ref2.apply_batch(batch)
        _assert_batch_equal(port2.apply_batch(_port(batch)), want_r, want_r.mode)


def _logs():
    port = temporal.temporal_barabasi_albert(300, 3, seed=0, remove_frac=0.1)
    ref = jax_temporal.temporal_barabasi_albert(300, 3, seed=0, remove_frac=0.1)
    return port, ref


@pytest.mark.parametrize("frontier", ["sharded", "fused"])
def test_window_and_replay_on_a_mesh_equal_the_reference(frontier):
    log, rlog = _logs()
    axes = ("data", "model")
    port = temporal.WindowedKCoreEngine(log, 240, 60, config=StreamingConfig(frontier=frontier),
                                        mesh=make_mesh((2, 2), axes, device="cpu"),
                                        axis_names=axes)
    ref = jax_temporal.WindowedKCoreEngine(
        rlog, 240, 60, config=jax_streaming.StreamingConfig(frontier=frontier),
        mesh=jax_make_mesh((1,), ("data",)))
    for k in (1, 2, 1, 1):
        got, want = port.advance(k), ref.advance(k)
        assert (got.step, got.lo, got.hi, got.m) == (want.step, want.lo, want.hi, want.m)
        _assert_batch_equal(got.result, want.result, want.result.mode)
    assert port.engine.mesh.size == 4 and port.engine.axis_names == axes
    # a window checkpoint restores onto the same mesh
    restored = temporal.WindowedKCoreEngine(log, 240, 60,
                                            config=StreamingConfig(frontier=frontier),
                                            mesh=port.engine.mesh, axis_names=axes)
    restored.load_state_dict(port.state_dict())
    assert restored.engine.mesh is port.engine.mesh
    got, want = restored.advance(), ref.advance()
    _assert_batch_equal(got.result, want.result, want.result.mode)
    traj = temporal.replay(log, 240, 60, config=StreamingConfig(frontier=frontier),
                           mesh=make_mesh((4,), ("data",), device="cpu"), oracle_every=2,
                           max_steps=4)
    rtraj = jax_temporal.replay(rlog, 240, 60,
                                config=jax_streaming.StreamingConfig(frontier=frontier),
                                mesh=jax_make_mesh((1,), ("data",)), oracle_every=2,
                                max_steps=4)
    assert [(r.step, r.messages, r.rounds, r.mode) for r in traj.records] == \
        [(r.step, r.messages, r.rounds, r.mode) for r in rtraj.records]


def test_server_on_a_mesh_equals_the_reference():
    g = jax_gen.barabasi_albert(200, 3, seed=2)
    port = KCoreServer(from_reference(g), StreamingConfig(frontier="sharded"),
                       mesh=make_mesh((4,), ("data",), device="cpu"))
    ref = jax_streaming.KCoreServer(g, jax_streaming.StreamingConfig(frontier="sharded"),
                                    mesh=jax_make_mesh((1,), ("data",)))
    batch = jax_streaming.random_churn_batch(g, 12, 12, np.random.default_rng(3))
    ids = np.random.default_rng(5).integers(0, g.n, 16)
    got = port.serve([Request(op="update", batch=_port(batch)), Request(op="core", vertices=ids),
                      Request(op="members", k=3), Request(op="max_k")])
    want = ref.serve([jax_streaming.Request(op="update", batch=batch),
                      jax_streaming.Request(op="core", vertices=ids),
                      jax_streaming.Request(op="members", k=3),
                      jax_streaming.Request(op="max_k")])
    _assert_batch_equal(got[0].payload, want[0].payload, "sharded")
    for a, b in zip(got[1:], want[1:]):
        assert (a.op, a.ok, a.error) == (b.op, b.ok, b.error)
        np.testing.assert_array_equal(np.asarray(a.payload), np.asarray(b.payload))
    # a restore keeps the server on its mesh
    port.load_state_dict(port.state_dict())
    assert port.engine.mesh.size == 4 and port.engine.config.frontier == "sharded"
    log, rlog = _logs()
    for srv, weng in ((KCoreServer, temporal.WindowedKCoreEngine(log, 60, 20, device="cpu")),
                      (jax_streaming.KCoreServer,
                       jax_temporal.WindowedKCoreEngine(rlog, 60, 20))):
        with pytest.raises(ValueError, match="belong to the WindowedKCoreEngine"):
            srv(windowed=weng, axis_names=("model",))


def test_engine_takes_the_meshs_device_and_builds_a_one_shard_mesh():
    g = from_reference(jax_gen.barabasi_albert(60, 3, seed=0))
    eng = StreamingKCoreEngine(g, StreamingConfig(frontier="sharded"), device="cpu")
    assert eng.mesh.size == 1 and eng.axis_names == ("data",) and eng.device.type == "cpu"
    mesh = make_mesh((2,), ("data",), device="cpu")
    assert StreamingKCoreEngine(g, mesh=mesh).device.type == "cpu"
    with pytest.raises(ValueError, match="every axis"):
        StreamingKCoreEngine(g, StreamingConfig(frontier="sharded"), mesh=mesh,
                             axis_names=("model",))
    with pytest.raises(ValueError, match="unknown frontier"):
        StreamingKCoreEngine.from_state_dict(eng.state_dict(), StreamingConfig(frontier="x"),
                                             device="cpu")
