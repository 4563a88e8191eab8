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
             "repro_torch.graph.io", "repro_torch.core.ktruss"):
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
    from repro_torch.graph import generators
    from repro_torch.platform import resolve_device
    from repro_torch.temporal import WindowedKCoreEngine, replay, temporal_barabasi_albert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = generators.fig1_example()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kcore_decompose(g)
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


def test_not_ported_combinations_name_their_roadmap_item():
    from repro_torch.graph import generators
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine
    from repro_torch.temporal import WindowedKCoreEngine, replay, temporal_barabasi_albert

    g = generators.chain(10)
    log = temporal_barabasi_albert(20, 2, seed=0)
    for config, mesh in ((StreamingConfig(frontier="sharded"), None),
                         (StreamingConfig(frontier="fused"), object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 10"):
            StreamingKCoreEngine(g, config, mesh=mesh, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 10"):
            WindowedKCoreEngine(log, 10, 5, config=config, mesh=mesh, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 10"):
            replay(log, 10, 5, config=config, mesh=mesh, device="cpu")
