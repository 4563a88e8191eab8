"""The PyTorch port stands alone: ``repro_torch`` and each of its modules
import with ``jax`` and ``repro`` blocked, importing builds no kernel, and
its entry points refuse to fall back to the CPU when no card is present."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Blocker())
import repro_torch
names = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.temporal", "repro_torch.temporal.events", "repro_torch.temporal.window",
             "repro_torch.temporal.replay", "repro_torch.checkpoint", "repro_torch.obs.health",
             "repro_torch.obs.metrics", "repro_torch.streaming.server",
             "repro_torch.streaming.concurrent", "repro_torch.obs.http",
             "repro_torch.launch.kcore_serve", "repro_torch.graph.blockstore",
             "repro_torch.core.outofcore", "repro_torch.core.termination",
             "repro_torch.graph.io", "repro_torch.core.ktruss", "repro_torch.distribution",
             "repro_torch.distribution.compat", "repro_torch.launch.mesh",
             "repro_torch.configs.schnet", "repro_torch.configs.egnn", "repro_torch.configs.mace",
             "repro_torch.configs.graphcast", "repro_torch.graph.sampler",
             "repro_torch.models.gnn.schnet", "repro_torch.models.gnn.egnn",
             "repro_torch.models.gnn.graphcast", "repro_torch.models.gnn.mace",
             "repro_torch.models.gnn.steps", "repro_torch.models.gnn.convert",
             "repro_torch.launch.graphcast_weather", "repro_torch.data",
             "repro_torch.data.pipeline", "repro_torch.runtime", "repro_torch.runtime.driver",
             "repro_torch.models.transformer.steps", "repro_torch.models.autodiff",
             "repro_torch.launch.train", "repro_torch.launch.train_lm_e2e"):
    assert name in names, name
leaked = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
from repro_torch.kernels import _build
assert _build.build_count() == 0
print(len(names))
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def test_import_every_module_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20   # every module of the package was imported


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=script.parent, env=_env(CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.distribution import compat
    from repro_torch.graph import generators
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.platform import resolve_device
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine
    from repro_torch.temporal import WindowedKCoreEngine, replay, temporal_barabasi_albert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = generators.fig1_example()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kcore_decompose(g)
    # a mesh is built for the card unless the CPU is asked for
    for build in (lambda: compat.make_mesh((2,), ("data",)), make_debug_mesh,
                  lambda: compat.global_mesh("shard"),
                  lambda: StreamingKCoreEngine(g, StreamingConfig(frontier="sharded"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    log = temporal_barabasi_albert(20, 2, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowedKCoreEngine(log, 10, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay(log, 10, 5)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    res = kcore_decompose(g, device="cpu")
    assert res.dispatch == "torch"
    np.testing.assert_array_equal(res.core, [3, 3, 1, 1, 3, 3, 2, 2])


def test_dispatch_plan_follows_the_device():
    from repro_torch.core.dispatch import resolve_plan

    plan = resolve_plan("cpu")
    assert plan.kind == "torch" and plan.device.type == "cpu"


def test_sharded_combinations_equal_the_reference():
    """What the port refused before the sharded paths were ported (the
    ``sharded`` frontier with no mesh, ``fused`` on a mesh) runs for the
    engine, the window and ``replay``, equal to the reference given the
    same arguments on its one-device mesh."""
    from repro import streaming as jax_streaming
    from repro import temporal as jax_temporal
    from repro.distribution.compat import make_mesh as jax_make_mesh
    from repro.graph import generators as jax_gen
    from repro_torch.distribution.compat import make_mesh
    from repro_torch.graph import from_reference
    from repro_torch.streaming import EdgeBatch, StreamingConfig, StreamingKCoreEngine
    from repro_torch.temporal import WindowedKCoreEngine, replay, temporal_barabasi_albert

    jg = jax_gen.chain(10)
    log = temporal_barabasi_albert(20, 2, seed=0)
    rlog = jax_temporal.temporal_barabasi_albert(20, 2, seed=0)
    for frontier, shards in (("sharded", None), ("fused", 2)):
        mesh = None if shards is None else make_mesh((shards,), ("data",), device="cpu")
        jmesh = None if shards is None else jax_make_mesh((1,), ("data",))
        cfg = StreamingConfig(frontier=frontier)
        jcfg = jax_streaming.StreamingConfig(frontier=frontier)
        eng = StreamingKCoreEngine(from_reference(jg), cfg, mesh=mesh, device="cpu")
        ref = jax_streaming.StreamingKCoreEngine(jg, jcfg, mesh=jmesh)
        got = eng.apply_batch(EdgeBatch.make(insert=[(0, 5), (2, 7)]))
        want = ref.apply_batch(jax_streaming.EdgeBatch.make(insert=[(0, 5), (2, 7)]))
        np.testing.assert_array_equal(got.core, want.core)
        assert (got.mode, got.rounds, got.total_messages) == \
            (want.mode, want.rounds, want.total_messages)
        w, rw = (WindowedKCoreEngine(log, 10, 5, config=cfg, mesh=mesh, device="cpu"),
                 jax_temporal.WindowedKCoreEngine(rlog, 10, 5, config=jcfg, mesh=jmesh))
        for _ in range(2):
            a, b = w.advance(), rw.advance()
            np.testing.assert_array_equal(a.core, b.core)
            assert a.result.total_messages == b.result.total_messages
        traj = replay(log, 10, 5, config=cfg, mesh=mesh, device="cpu")
        rtraj = jax_temporal.replay(rlog, 10, 5, config=jcfg, mesh=jmesh)
        assert [(r.messages, r.mode) for r in traj.records] == \
            [(r.messages, r.mode) for r in rtraj.records]


def test_training_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """Without a card and without ``--device cpu`` the training launchers
    fail; with ``--device cpu`` the data, driver and train step run there."""
    from repro_torch.launch import train, train_lm_e2e

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in [(train.main, ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"]),
                       (train_lm_e2e.main, ["--steps", "2"])]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([*argv, "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
    with pytest.raises(SystemExit, match="no loss was logged"):
        train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1", "--batch", "2",
                    "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert (tmp_path / "ck" / "step_000000001").is_dir()
