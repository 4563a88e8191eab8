"""The port's sharded static engine (``repro_torch.core.kcore``'s
``kcore_decompose_sharded``, the single-process meshes of
``repro_torch.distribution.compat``) against ``repro.core``.

Cores, rounds, ``converged`` and every per-round bill must equal the
reference's exactly, host loop and fused, on 1-, 2- and 3-axis meshes. The
reference's own sharded engine needs forced host devices before its first
jax import, so it runs once, in one subprocess for the whole file
(``ref_sharded``); every other case compares against the reference's
single-device engine in process, which the reference holds its sharded
bills equal to.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import bz_core_numbers as jax_bz
from repro.core import kcore_decompose as jax_decompose
from repro.graph import generators as jax_gen
from repro.graph import partition as jax_part
from repro.graph.structs import Graph as JaxGraph
from repro.launch import mesh as jax_mesh
from repro_torch.core import dispatch
from repro_torch.core.kcore import (_bs_iters, kcore_decompose, kcore_decompose_sharded,
                                    make_sharded_superstep)
from repro_torch.distribution import compat
from repro_torch.graph import from_reference, partition
from repro_torch.launch import mesh as port_mesh
from repro_torch.obs import metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS = ("messages_per_round", "active_per_round", "changed_per_round")
MESHES = {"4": ((4,), ("data",)), "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _isolated_graph():
    """97 vertices with edges among the first 90 only (7 isolated), so n is
    no multiple of the shard counts and padding shards hold real and
    isolated vertices."""
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 90, size=(260, 2))
    return JaxGraph.from_edges(edges, n=97)


GRAPHS = {"ba": lambda: jax_gen.barabasi_albert(400, 4, seed=2), "isolated": _isolated_graph}


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.core, ref.core)
    assert (port.rounds, port.converged) == (ref.rounds, ref.converged)
    for k in STATS:
        np.testing.assert_array_equal(getattr(port.stats, k), getattr(ref.stats, k), err_msg=k)


_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
from repro.core import kcore_decompose_sharded
from repro.distribution.compat import make_mesh
from repro.graph import generators as gen
from repro.obs import metrics

g = gen.barabasi_albert(400, 4, seed=2)
out = {}
for name, shape, axes in %s:
    mesh = make_mesh(shape, axes)
    for fused in (False, True):
        res = kcore_decompose_sharded(g, mesh, axes, fused=fused)
        out[f"{name}/{fused}"] = {
            "core": res.core.tolist(), "rounds": res.rounds, "converged": res.converged,
            "imbalance": metrics.gauge("kcore_shard_imbalance").value,
            **{k: getattr(res.stats, k).tolist() for k in %r}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference sharded engine on the three meshes, host loop and
    fused, over ``barabasi_albert(400, 4, seed=2)``: one subprocess."""
    meshes = [(name, shape, axes) for name, (shape, axes) in MESHES.items()]
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT % (meshes, STATS)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_equals_the_reference_sharded_engine(ref_sharded, mesh_name, fused):
    shape, axes = MESHES[mesh_name]
    g = from_reference(GRAPHS["ba"]())
    res = kcore_decompose_sharded(g, compat.make_mesh(shape, axes, device="cpu"), axes,
                                  fused=fused)
    want = ref_sharded[f"{mesh_name}/{fused}"]
    np.testing.assert_array_equal(res.core, want["core"])
    assert (res.rounds, res.converged) == (want["rounds"], want["converged"])
    for k in STATS:
        np.testing.assert_array_equal(getattr(res.stats, k), want[k], err_msg=k)
    assert metrics.gauge("kcore_shard_imbalance").value == want["imbalance"]
    assert res.dispatch == "torch"
    assert set(res.phase_s) == ({"stage", "device-converge", "host-reconstruct"} if fused
                                else {"stage", "converge"})


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("mesh_name", [*MESHES, "1", "3"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_sharded_equals_the_single_device_reference_and_bz(graph, mesh_name, fused):
    shape, axes = MESHES[mesh_name] if mesh_name in MESHES else ((int(mesh_name),), ("data",))
    jg = GRAPHS[graph]()
    ref = jax_decompose(jg)
    res = kcore_decompose_sharded(from_reference(jg), compat.make_mesh(shape, axes, device="cpu"),
                                  axes, fused=fused)
    _assert_same(res, ref)
    np.testing.assert_array_equal(res.core, jax_bz(jg))


def test_max_rounds_caps_the_sharded_loops():
    jg = GRAPHS["ba"]()
    mesh = compat.make_mesh((4,), ("data",), device="cpu")
    full = jax_decompose(jg)
    for fused in (False, True):
        res = kcore_decompose_sharded(from_reference(jg), mesh, ("data",), max_rounds=3,
                                      fused=fused)
        assert res.rounds == 3 and not res.converged
        np.testing.assert_array_equal(res.stats.messages_per_round,
                                      full.stats.messages_per_round[:4])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_layout_and_staging_equal_the_reference_partition(graph, n_shards):
    """``shard_graph`` equals the reference's array for array, and the
    staged stack is that layout: local rows offset by l * V, dst global, the
    CSR row pointer of the stacked local sources."""
    jg = GRAPHS[graph]()
    ref = jax_part.shard_graph(jg, n_shards)
    sg = partition.shard_graph(from_reference(jg), n_shards)
    for k in ("src", "dst", "arc_mask", "deg", "vert_mask"):
        np.testing.assert_array_equal(getattr(sg, k), getattr(ref, k), err_msg=k)
    assert (sg.verts_per_shard, sg.arcs_per_shard) == (ref.verts_per_shard, ref.arcs_per_shard)
    assert partition.balance_report(sg) == jax_part.balance_report(ref)
    mesh = compat.make_mesh((n_shards,), ("data",), device="cpu")
    st = dispatch.stage_shards(sg, mesh, ("data",))
    V = ref.verts_per_shard
    rows = (ref.src + np.arange(n_shards)[:, None] * V).reshape(-1)
    np.testing.assert_array_equal(st.src.numpy(), rows)
    np.testing.assert_array_equal(st.dst.numpy(), ref.dst.reshape(-1))
    np.testing.assert_array_equal(st.arc_mask.numpy(), ref.arc_mask.reshape(-1))
    np.testing.assert_array_equal(st.deg.numpy(), ref.deg.reshape(-1))
    np.testing.assert_array_equal(st.row_ptr.numpy(),
                                  np.searchsorted(rows, np.arange(n_shards * V + 1)))


def test_shard_imbalance_gauge_is_the_reference_balance_report():
    jg = GRAPHS["ba"]()
    for n_shards in (2, 4):
        kcore_decompose_sharded(from_reference(jg),
                                compat.make_mesh((n_shards,), ("data",), device="cpu"),
                                ("data",))
        want = jax_part.balance_report(jax_part.shard_graph(jg, n_shards))["imbalance"]
        assert metrics.gauge("kcore_shard_imbalance").value == want


def test_plain_and_masked_supersteps_take_the_first_round():
    """One plain and one masked superstep from the degree seed bill what
    the reference's first round bills."""
    jg = GRAPHS["ba"]()
    g, ref = from_reference(jg), jax_decompose(jg)
    mesh = compat.make_mesh((4,), ("data",), device="cpu")
    sg = partition.shard_graph(g, 4)
    n_iters = _bs_iters(g.max_deg)
    est = compat.stage_to_mesh(sg.deg, mesh).reshape(-1)
    plain, _ = make_sharded_superstep(sg, mesh, ("data",), n_iters)
    new, msgs, any_changed = plain(est)
    masked, st = make_sharded_superstep(sg, mesh, ("data",), n_iters, masked=True)
    new_m, changed, recv, msgs_m = masked(est, torch.ones_like(est, dtype=torch.bool))
    assert torch.equal(new, new_m) and bool(any_changed)
    assert int(msgs) == int(msgs_m) == ref.stats.messages_per_round[1]
    assert int(changed.sum()) == ref.stats.changed_per_round[1]
    assert int(recv.sum()) == ref.stats.active_per_round[2]
    # an empty frontier changes nothing
    none = torch.zeros_like(est, dtype=torch.bool)
    same, changed, recv, msgs = masked(est, none)
    assert torch.equal(same, est) and not changed.any() and not recv.any() and int(msgs) == 0
    assert st.mesh is mesh and st.V == sg.verts_per_shard


def test_compat_helpers_on_one_process():
    mesh = compat.make_mesh((2, 3), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert (mesh.local_shards, mesh.shard_offset, mesh.device.type) == (6, 0, "cpu")
    assert not compat.is_multiprocess() and not compat.is_multiprocess_mesh(mesh)
    assert compat.shard_count(mesh, ("model", "data")) == 6
    with pytest.raises(ValueError, match="every axis"):
        compat.shard_count(mesh, ("data",))
    arr = np.arange(18, dtype=np.int32).reshape(6, 3)
    staged = compat.stage_to_mesh(arr, mesh)
    assert staged.device.type == "cpu" and staged.dtype == torch.int32
    np.testing.assert_array_equal(compat.fetch_replicated(staged, mesh), arr)
    assert compat.all_gather(staged, mesh) is staged and compat.psum(staged, mesh) is staged
    with pytest.raises(ValueError, match="leading dimension"):
        compat.stage_to_mesh(arr[:5], mesh)
    g1 = compat.global_mesh("shard", device="cpu")
    assert (g1.axis_names, g1.size, g1.group) == (("shard",), 1, None)
    assert compat.global_mesh("shard", local_shards=4, device="cpu").size == 4
    for shape, names in (((2,), ("a", "b")), ((0,), ("a",)), ((), ())):
        with pytest.raises(ValueError):
            compat.make_mesh(shape, names, device="cpu")
    with pytest.raises(ValueError, match="cannot be split"):
        compat.Mesh((3,), ("a",), torch.device("cpu"), world=2)


def test_debug_mesh_helpers_equal_the_reference():
    ref = jax_mesh.make_debug_mesh()
    port = port_mesh.make_debug_mesh(device="cpu")
    assert port_mesh.flat_axes(port) == jax_mesh.flat_axes(ref) == ("data", "model")
    assert port_mesh.n_devices(port) == jax_mesh.n_devices(ref) == 1
    assert port_mesh.n_devices(port_mesh.make_debug_mesh(2, 4, device="cpu")) == 8


def test_the_sharded_engine_runs_on_the_meshs_device_and_refuses_a_wrong_count():
    g = from_reference(GRAPHS["isolated"]())
    mesh = compat.make_mesh((4,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="every axis"):
        kcore_decompose_sharded(g, mesh, ("model",))
    sg = partition.shard_graph(g, 3)
    with pytest.raises(ValueError, match="3 shards"):
        dispatch.stage_shards(sg, mesh, ("data",))
    res = kcore_decompose_sharded(g, mesh, ("data",), fused=True)
    np.testing.assert_array_equal(res.core, kcore_decompose(g, fused=True, device="cpu").core)
