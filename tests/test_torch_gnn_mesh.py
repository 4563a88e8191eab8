"""GNN message passing on a flat mesh in the port (``models/gnn/common.py``'s
sharded scatter and gather, ``steps.build_train`` on a mesh, ``stage_batch``,
``mesh_layouts``) against the reference's on forced host devices, and one
process of 4 shards against two gloo processes of 2 shards each.

The reference's sharded side needs forced host devices before its first
jax import, so it runs once, in one subprocess for the whole file
(``ref_mesh``): its ``scatter_sum``/``gather_rows_multi`` under
``set_flat_sharding`` on meshes of 2 and 4 devices, its ``build_train``
placements on every assigned shape, and its ``build_train`` step jitted with
its ``in_sh``/``out_sh`` on 4 devices. The gloo ranks are interpreters of
their own that import neither jax nor the reference, rendezvousing on a free
localhost port, with a process-group timeout and a timeout on each
subprocess.

Tolerances, and why:

- the sharded scatter: ``checks.segment_sum_excess`` of the float64 sum at
  most 0 (two float32 summation orders: the port's D shard partials added in
  shard order, XLA's segment sums and psum_scatter), the reference's held
  the same way; the gather is a take: bit-equal to the reference's;
- the branch each call takes: the reference's (a ``shard_map`` call or
  none), on each side of E = 4096 and of n, E % D;
- one process of 4 shards and two processes of 2 shards: the same bits,
  forward and backward (the same shard partials, added in the same order);
- train steps, with ``COMPUTE_DTYPE`` float32 on both sides:
  ``tests/test_torch_gnn_train.py``'s tolerances, loss and grad norm rtol
  1e-5, each gradient leaf (AdamW's first moment, 0.1 g) within
  ``1e-5 (|ref| + max|ref|)``, each updated parameter within 2e-6, or within
  ``lr`` where the gradient is within its rounding noise of 0;
- EGNN on molecules: its masked self-arcs (src = dst = 0) make the
  reference's gradient NaN (ROADMAP Queue C caveat 6), and dropping them
  would leave an arc count the 4 shards do not divide; both sides take the
  batch with those arcs turned into masked 0 -> 1 arcs instead.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checks import segment_sum_excess
from repro_torch.configs import ShapeSpec, get_smoke
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.distribution import collectives, compat
from repro_torch.distribution.sharding import NamedSharding, P
from repro_torch.graph.structs import Graph
from repro_torch.models.gnn import common as PC, convert, steps as PS
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["schnet", "egnn", "mace", "graphcast"]
LR = 1e-3

# (n, E, F, D): each side of E = 4096 and of n % D, E % D
CASES = [(1024, 8192, 5, 4), (1024, 4096, 3, 4), (1024, 4092, 5, 4), (1030, 8192, 4, 4),
         (1024, 8190, 4, 4), (1023, 8192, 5, 2), (512, 4094, 7, 2), (2048, 6000, 6, 2)]


def _case_data(n, E, F, seed=0):
    rng = np.random.default_rng(seed + n + E)
    return (rng.integers(0, n, E), rng.integers(0, n, E),
            rng.standard_normal((E, F)).astype(np.float32),
            rng.standard_normal((n, F)).astype(np.float32))


def _full_graph_sm():
    """full_graph_sm's sizes: 2,708 nodes, 5,278 edges (10,556 arcs), 1,433
    features, 7 classes, on a random simple graph."""
    rng = np.random.default_rng(5)
    pairs = set()
    while len(pairs) < 5278:
        a, b = (int(x) for x in rng.integers(0, 2708, 2))
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    g = Graph.from_edges(np.asarray(sorted(pairs)), n=2708)
    assert g.num_arcs == 10556
    return PC.batch_from_graph(g, 1433, 7, seed=1), 1433, 7, \
        next(s for s in GNN_SHAPES if s.name == "full_graph_sm")


def _molecules(arch):
    """64 molecules of 30 atoms and 64 bonds, padded as ``batch_specs`` pads
    them (2,048 nodes, 8,192 arcs); EGNN's masked arcs point 0 -> 1 (the
    module docstring)."""
    b = PS.pad_batch(PC.batch_molecules(64, 30, 64, 4, seed=2))
    if arch == "egnn":
        b["dst"] = np.where(b["edge_mask"], b["dst"], 1).astype(np.int32)
    return b, None, 0, ShapeSpec("molecule", "molecule", {"n_nodes": 30, "n_edges": 64,
                                                          "batch": 64})


STEPS = [(a, k) for a in ARCHS for k in ("full_graph", "molecule")]


def _step_data(arch, kind):
    return _full_graph_sm() if kind == "full_graph" else _molecules(arch)


_REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.distribution.compat as RC
import repro.models.gnn.common as JC
import repro.models.gnn.mace as JM
from repro.configs import get_smoke
from repro.configs.base import ShapeSpec, GNN_SHAPES
from repro.models.gnn import steps as JS
from repro.optim import adamw_init

inp = pickle.load(open(sys.argv[1], "rb"))
calls = []
real = RC.shard_map
def counting(f, mesh, in_specs, out_specs):
    calls.append(f.__code__.co_varnames[0])
    return real(f, mesh, in_specs, out_specs)
RC.shard_map = counting

def mesh_of(d):
    return Mesh(np.asarray(jax.devices()[:d]), ("data",))

out = {"cases": [], "steps": {}, "specs": {}}
for (n, E, F, D), (ids, src, vals, h) in zip(inp["cases"], inp["case_data"]):
    JC.set_flat_sharding(mesh_of(D), ("data",))
    rec = {}
    del calls[:]
    try:
        rec["y"] = np.asarray(JC.scatter_sum(jnp.asarray(vals), jnp.asarray(ids), n))
    except Exception as e:
        rec["y_error"] = type(e).__name__
    rec["scatter_sharded"] = calls.count("v")
    del calls[:]
    a, b = JC.gather_rows_multi(jnp.asarray(h), (jnp.asarray(src), jnp.asarray(ids)))
    rec["a"], rec["b"] = np.asarray(a), np.asarray(b)
    rec["gather_sharded"] = calls.count("h_l")
    out["cases"].append(rec)

JC.COMPUTE_DTYPE = jnp.float32
JM.COMPUTE_DTYPE = jnp.float32
for (arch, kind), (batch, d_in, ncls, sp) in inp["steps"].items():
    cfg = get_smoke(arch)
    shape = ShapeSpec(*sp)
    step, specs, in_sh, out_sh = JS.build_train(cfg, shape, mesh_of(4))
    jp = JS.init_params(cfg, jax.random.key(0), d_in=d_in, n_classes=ncls)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, opt, m = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(jp, adamw_init(jp), jb)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    out["steps"][(arch, kind)] = {"params": np_tree(jp), "new": np_tree(new), "m": np_tree(opt["m"]),
                                  "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}

for arch in ("schnet", "egnn", "mace", "graphcast"):
    for shape in GNN_SHAPES:
        _, specs, in_sh, out_sh = JS.build_train(get_smoke(arch), shape, mesh_of(4))
        p_sh, o_sh, b_sh = in_sh
        out["specs"][(arch, shape.name)] = {
            "batch": {k: tuple(s.spec) for k, s in b_sh.items()},
            "params": [tuple(s.spec) for s in jax.tree.leaves(p_sh)],
            "opt": [tuple(s.spec) for s in jax.tree.leaves(o_sh)],
            "out": [tuple(s.spec) for s in jax.tree.leaves(out_sh)],
            "mesh": tuple(b_sh["src"].mesh.axis_names)}
JC.set_flat_sharding(None, None)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    """The reference on forced host devices: the scatter and gather cases,
    the steps of ``STEPS`` and the placements of every arch and shape; one
    subprocess."""
    d = tmp_path_factory.mktemp("ref_mesh")
    steps = {(a, k): (lambda b, d_in, ncls, s: (b, d_in, ncls, (s.name, s.kind, dict(s.params))))(
        *_step_data(a, k)) for a, k in STEPS}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"cases": CASES, "case_data": [_case_data(*c[:3]) for c in CASES],
                     "steps": steps}, f)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(d / "in.pkl"), str(d / "out.pkl")],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture
def flat_mesh():
    """A 4-shard one-process mesh; the flat context cleared afterwards."""
    yield compat.make_mesh((4,), ("data",), device="cpu")
    PC.set_flat_sharding(None, None)
    PC.reset_branches()


@pytest.fixture
def float32(monkeypatch):
    monkeypatch.setattr(PC, "COMPUTE_DTYPE", torch.float32)


def _np(t):
    return t.detach().float().cpu().numpy()


# ------------------------- scatter and gather ------------------------- #

@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"n{c[0]}-E{c[1]}-D{c[3]}" for c in CASES])
def test_scatter_and_gather_against_the_reference_sharded_ones(ref_mesh, case):
    n, E, F, D = CASES[case]
    ids, src, vals, h = _case_data(n, E, F)
    want = ref_mesh["cases"][case]
    mesh = compat.make_mesh((D,), ("data",), device="cpu")
    PC.set_flat_sharding(mesh, ("data",))
    PC.reset_branches()
    try:
        lay, slay = PC.mesh_layout(ids, n, mesh), PC.mesh_layout(src, n, mesh)
        if "y_error" in want:         # E % D with E >= 4096: the reference's shard_map refuses
            with pytest.raises(ValueError, match="cannot split"):
                PC.scatter_sum(torch.as_tensor(vals), lay)
            assert PC.BRANCHES["scatter"]["sharded"] == 1
        else:
            y = PC.scatter_sum(torch.as_tensor(vals), lay)
            assert PC.BRANCHES["scatter"] == {"sharded": want["scatter_sharded"],
                                              "unsharded": 1 - want["scatter_sharded"]}
            t_ids, t_vals = torch.as_tensor(ids), torch.as_tensor(vals)
            exact = torch.zeros((n, F), dtype=torch.float64).index_add_(0, t_ids, t_vals.double())
            for got in (y, torch.as_tensor(want["y"])):
                excess, _ = segment_sum_excess(t_vals, t_ids, n, got, exact)
                assert excess <= 0, excess
        a, b = PC.gather_rows_multi(torch.as_tensor(h), (slay, lay))
        assert PC.BRANCHES["gather"] == {"sharded": want["gather_sharded"],
                                         "unsharded": 1 - want["gather_sharded"]}
        np.testing.assert_array_equal(a.numpy(), want["a"])
        np.testing.assert_array_equal(b.numpy(), want["b"])
    finally:
        PC.set_flat_sharding(None, None)
        PC.reset_branches()


def test_sharded_scatter_is_d_partials_and_a_reduce_scatter(flat_mesh):
    """One float32 partial a shard, added in shard order and rounded once,
    bit for bit; the collective tally notes the reduce-scatter and the
    gather's all-gather; the backward of each is the other's pattern."""
    from repro_torch.kernels.segment_sum import ops as sk

    n, E, F = 1024, 8192, 5
    ids, src, vals, h = _case_data(n, E, F)
    PC.set_flat_sharding(flat_mesh, ("data",))
    lay = PC.mesh_layout(ids, n, flat_mesh)
    assert len(lay.shards) == 4 and lay.whole is None
    v = torch.as_tensor(vals).to(torch.bfloat16)
    with collectives.collective_bytes() as tally:
        y = PC.scatter_sum(v, lay)
    acc = torch.zeros((n, F))
    for j in range(4):
        acc += sk.segment_sum_float_ref(v[j * 2048:(j + 1) * 2048].float(),
                                        torch.as_tensor(ids[j * 2048:(j + 1) * 2048]), n)
    assert y.dtype == torch.bfloat16 and torch.equal(y, acc.to(torch.bfloat16))
    assert tally["counts"] == {"reduce-scatter": 1}
    assert tally["bytes_by_kind"]["reduce-scatter"] == n * F * 4 * 3 / 4
    with collectives.collective_bytes() as tally:
        (a,) = PC.gather_rows_multi(torch.as_tensor(h), (lay,))
    assert tally["counts"] == {"all-gather": 1} and torch.equal(a, torch.as_tensor(h)[ids])
    # without a layout of the mesh, the mesh refuses
    with pytest.raises(ValueError, match="MeshLayouts"):
        PC.scatter_sum(v, PC.segment_layout(ids, n))
    with pytest.raises(ValueError, match="MeshLayouts"):
        PC.gather_rows(torch.as_tensor(h), torch.as_tensor(ids))


def test_mesh_gradients_through_the_scatter_and_the_gather(flat_mesh):
    """The sharded scatter's backward is the gather of the gradient; the
    sharded gather's backward is the sharded scatter of its gradient (the
    shards' partials of both indexes, added, then the reduce-scatter)."""
    n, E, F = 1024, 8192, 3
    ids, src, vals, h = _case_data(n, E, F)
    PC.set_flat_sharding(flat_mesh, ("data",))
    lay, slay = PC.mesh_layout(ids, n, flat_mesh), PC.mesh_layout(src, n, flat_mesh)
    rng = np.random.default_rng(9)
    gy = torch.as_tensor(rng.standard_normal((n, F)).astype(np.float32))
    ge = torch.as_tensor(rng.standard_normal((E, F)).astype(np.float32))
    v = torch.as_tensor(vals).requires_grad_(True)
    PC.scatter_sum(v, lay).backward(gy)
    assert torch.equal(v.grad, gy[ids])
    hh = torch.as_tensor(h).requires_grad_(True)
    a, b = PC.gather_rows_multi(hh, (slay, lay))
    (a * ge + b * ge * 2).sum().backward()
    want = torch.zeros((n, F))
    for j in range(4):
        sl = slice(j * 2048, (j + 1) * 2048)
        want += PC._seg.segment_sum_float_ref(ge[sl], torch.as_tensor(src[sl]), n) + \
            PC._seg.segment_sum_float_ref(ge[sl] * 2, torch.as_tensor(ids[sl]), n)
    assert torch.equal(hh.grad, want)
    exact = torch.zeros((n, F), dtype=torch.float64).index_add_(
        0, torch.as_tensor(np.concatenate([src, ids])), torch.cat([ge, 2 * ge]).double())
    excess, _ = segment_sum_excess(torch.cat([ge, 2 * ge]), torch.as_tensor(
        np.concatenate([src, ids])), n, hh.grad, exact)
    assert excess <= 0


# ----------------------------- two processes ---------------------------- #

_RANK_SCRIPT = r"""
import json, pickle, sys
import numpy as np
import torch
from repro_torch.distribution import compat
from repro_torch.models.gnn import common as C, steps as S
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves

rank, nproc, port, inp, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
compat.init_multiprocess(f"127.0.0.1:{port}", nproc, rank, timeout_s=120)
mesh = compat.global_mesh("shard", local_shards=4 // nproc, device="cpu")
assert compat.is_multiprocess_mesh(mesh) and mesh.size == 4
C.set_flat_sharding(mesh, ("shard",))
d = pickle.load(open(inp, "rb"))
res = {}
for name, (n, ids, src, vals, h, gy, ge) in d["ops"].items():
    lay, slay = C.mesh_layout(ids, n, mesh), C.mesh_layout(src, n, mesh)
    blocks = lambda a: C.held_as_blocks(a.shape[0], mesh)
    mine = lambda a: C._own_rows(torch.as_tensor(a), mesh) if blocks(a) else torch.as_tensor(a)
    # a gradient of an array held whole is held as shares: rank 0's is all of it
    share = lambda g: mine(g) if blocks(g) or rank == 0 else torch.zeros_like(torch.as_tensor(g))
    v = mine(vals).requires_grad_(True)
    y = C.scatter_sum(v, lay)
    y.backward(share(gy))
    hh = mine(h).requires_grad_(True)
    a, b = C.gather_rows_multi(hh, (slay, lay))
    (a * share(ge) + b * share(ge) * 2).sum().backward()
    res[name] = {k: t.detach().numpy() for k, t in
                 (("y", y), ("vg", v.grad), ("a", a), ("b", b), ("hg", hh.grad))}
C.COMPUTE_DTYPE = torch.float32
for key, (cfg, shape, batch, params) in d["steps"].items():
    step, _, _, _ = S.build_train(cfg, shape, mesh)
    C.reset_branches()
    new, opt, m = step(params, adamw_init(params), S.stage_batch(batch, mesh),
                       **S.mesh_layouts(cfg, shape, batch, mesh))
    res[key] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "new": [t.numpy() for t in leaves(new)], "m": [t.numpy() for t in leaves(opt["m"])],
                "branches": json.loads(json.dumps(C.BRANCHES))}
pickle.dump(res, open(f"{outdir}/rank{rank}.pkl", "wb"))
print("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ops_data():
    """Scatter and gather cases of the layout test: rows and arcs held as
    row blocks (both sharded branches), and arcs held as row blocks with
    1,000 rows held whole (the unsharded scatter, the sharded gather)."""
    out = {}
    for name, (n, E, F) in {"blocks": (2048, 8192, 6), "whole_rows": (1000, 2048, 4)}.items():
        ids, src, vals, h = _case_data(n, E, F, seed=3)
        rng = np.random.default_rng(n)
        out[name] = (n, ids, src, vals, h, rng.standard_normal((n, F)).astype(np.float32),
                     rng.standard_normal((E, F)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def two_ranks(ref_mesh, tmp_path_factory):
    """Two gloo ranks of 2 shards each: the layout cases and the GraphCast
    (full_graph_sm) and MACE (molecule) steps from the reference's weights."""
    d = tmp_path_factory.mktemp("ranks")
    steps = {}
    for arch, kind in (("graphcast", "full_graph"), ("mace", "molecule")):
        batch, _, _, shape = _step_data(arch, kind)
        params = convert.params_from_jax(ref_mesh["steps"][(arch, kind)]["params"],
                                         get_smoke(arch), device="cpu")
        steps[f"{arch}/{kind}"] = (get_smoke(arch), shape, batch, params)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"ops": _ops_data(), "steps": steps}, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), "2", str(port),
                               str(d / "in.pkl"), str(d)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for r in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-2000:] for e in errs)
    out = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("name", ["blocks", "whole_rows"])
def test_two_processes_equal_one_process_bit_for_bit(two_ranks, flat_mesh, name):
    """4 shards in one process and 2 + 2 over two gloo processes: the same
    scatter and gather, forward and backward, bit for bit. Row blocks are
    concatenated in rank order; arrays held whole are held by both."""
    n, ids, src, vals, h, gy, ge = _ops_data()[name]
    PC.set_flat_sharding(flat_mesh, ("data",))
    lay, slay = PC.mesh_layout(ids, n, flat_mesh), PC.mesh_layout(src, n, flat_mesh)
    v = torch.as_tensor(vals).requires_grad_(True)
    y = PC.scatter_sum(v, lay)
    y.backward(torch.as_tensor(gy))
    hh = torch.as_tensor(h).requires_grad_(True)
    a, b = PC.gather_rows_multi(hh, (slay, lay))
    ge_t = torch.as_tensor(ge)
    (a * ge_t + b * ge_t * 2).sum().backward()
    one = {"y": y, "vg": v.grad, "a": a, "b": b, "hg": hh.grad}
    for k, t in one.items():
        parts = [r[name][k] for r in two_ranks]
        rows = t.shape[0]
        if PC.held_as_blocks(rows, compat.Mesh((4,), ("shard",), torch.device("cpu"), world=2)):
            two = np.concatenate(parts)
        elif k == "hg":          # a whole array's gradient: the ranks' shares add up to it
            two = parts[0] + parts[1]
        else:
            np.testing.assert_array_equal(parts[0], parts[1])
            two = parts[0]
        np.testing.assert_array_equal(t.detach().numpy(), two, err_msg=f"{name} {k}")


# ------------------------------ train steps ------------------------------ #

def _hold_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_array_less(np.abs(g - w), 1e-5 * (np.abs(w) + np.abs(w).max()) + 1e-30)


def _hold_updated(got, want, grads, before):
    for p, w, g, p0 in zip(got, want, grads, before):
        p, w, g, p0 = (np.asarray(x, np.float32) for x in (p, w, g, p0))
        noisy = np.abs(g) <= 1e-5 * np.abs(g).max()
        np.testing.assert_allclose(p[~noisy], w[~noisy], rtol=0, atol=2e-6)
        assert (np.abs(p - w)[noisy] <= 1.01 * LR).all()


def _port_step(arch, kind, params, mesh):
    batch, _, _, shape = _step_data(arch, kind)
    cfg = get_smoke(arch)
    step, _, _, _ = PS.build_train(cfg, shape, mesh)
    if mesh is None:
        return step(params, adamw_init(params), PC.batch_to(batch, "cpu"))
    PC.reset_branches()
    out = step(params, adamw_init(params), PS.stage_batch(batch, mesh),
               **PS.mesh_layouts(cfg, shape, batch, mesh))
    return out


@pytest.mark.parametrize("arch,kind", STEPS)
def test_four_shard_step_matches_the_reference_sharded_step(ref_mesh, flat_mesh, float32, arch,
                                                            kind):
    want = ref_mesh["steps"][(arch, kind)]
    cfg = get_smoke(arch)
    params = convert.params_from_jax(want["params"], cfg, device="cpu")
    new, opt, m = _port_step(arch, kind, params, flat_mesh)
    scatters, gathers = PC.BRANCHES["scatter"], PC.BRANCHES["gather"]
    assert scatters["sharded"] > 0 and gathers["sharded"] > 0
    # the molecules' pooling (2,048 nodes into 64 graphs) takes the unsharded branch
    assert scatters["unsharded"] == (kind == "molecule")
    assert float(m["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(want["grad_norm"], rel=1e-5)
    carry = lambda t: leaves(convert.params_from_jax(t, cfg, device="cpu"))
    _hold_grads(leaves(opt["m"]), carry(want["m"]))
    _hold_updated(leaves(new), carry(want["new"]), leaves(opt["m"]), leaves(params))

    # the port's own one-device step from the same weights
    PC.set_flat_sharding(None, None)
    new1, opt1, m1 = _port_step(arch, kind, params, None)
    assert float(m["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    _hold_grads(leaves(opt["m"]), leaves(opt1["m"]))
    _hold_updated(leaves(new), leaves(new1), leaves(opt1["m"]), leaves(params))


@pytest.mark.parametrize("key", ["graphcast/full_graph", "mace/molecule"])
def test_two_process_step_matches_the_reference(ref_mesh, two_ranks, key):
    """Two gloo processes of 2 shards: the same loss, gradients and update
    on both ranks, within the rule of the reference's sharded step."""
    arch, kind = key.split("/")
    want = ref_mesh["steps"][(arch, kind)]
    cfg = get_smoke(arch)
    r0, r1 = (r[key] for r in two_ranks)
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    for a, b in zip(r0["new"], r1["new"]):
        np.testing.assert_array_equal(a, b)
    assert r0["branches"]["scatter"]["sharded"] > 0 and r0["branches"]["gather"]["sharded"] > 0
    assert r0["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert r0["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    params = leaves(convert.params_from_jax(want["params"], cfg, device="cpu"))
    carry = lambda t: leaves(convert.params_from_jax(t, cfg, device="cpu"))
    _hold_grads(r0["m"], carry(want["m"]))
    _hold_updated(r0["new"], carry(want["new"]), r0["m"], params)


# --------------------------------- specs --------------------------------- #

@pytest.mark.parametrize("shape", [s.name for s in GNN_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_placements_equal_the_reference(ref_mesh, flat_mesh, arch, shape):
    spec = next(s for s in GNN_SHAPES if s.name == shape)
    cfg = get_smoke(arch)
    step, specs, in_sh, out_sh = PS.build_train(cfg, spec, flat_mesh)
    assert PC.flat_mesh() is flat_mesh and PS.build_step is PS.build_train and callable(step)
    want = ref_mesh["specs"][(arch, shape)]
    p_sh, o_sh, b_sh = in_sh
    assert all(isinstance(s, NamedSharding) and s.mesh is flat_mesh
               for s in [*leaves(p_sh), *leaves(o_sh), *b_sh.values()])
    assert {k: tuple(s.spec) for k, s in b_sh.items()} == want["batch"]
    assert list(b_sh) == list(specs["batch"])
    # blocks: one dict a layer here, stacked in the reference; every leaf P()
    blocks = leaves(p_sh["blocks"])
    assert len(blocks) == cfg.n_layers * len(leaves(p_sh["blocks"][0]))
    per_layer = len(leaves(p_sh)) - len(blocks) + len(leaves(p_sh["blocks"][0]))
    assert per_layer == len(want["params"])
    assert {tuple(s.spec) for s in leaves(p_sh)} == set(want["params"]) == {()}
    assert {tuple(s.spec) for s in leaves(o_sh)} == set(want["opt"]) == {()}
    assert len(leaves(o_sh)) == 2 * len(leaves(p_sh)) + 1
    assert out_sh[0] == p_sh and out_sh[1] == o_sh and tuple(out_sh[2].spec) == ()
    assert tuple(flat_mesh.axis_names) == want["mesh"]


def test_specs_and_the_flat_context():
    mesh = compat.make_mesh((2, 2), ("data", "model"), device="cpu")
    assert P(("data", "model")) == (("data", "model"),) and P() == () and P(None, "data") == \
        (None, "data")
    assert repr(P("data")) == "P('data',)" and P(("data", "model"), None).axes() == \
        ("data", "model") and P(("data",)) == ("data",)
    with pytest.raises(ValueError, match="not axes"):
        NamedSharding(mesh, P("pod"))
    try:
        with pytest.raises(ValueError, match="name every axis"):
            PC.set_flat_sharding(mesh, ("data",))
        PC.set_flat_sharding(mesh, ("data", "model"))
        assert PC.flat_mesh() is mesh and PC._mesh_size(mesh) == 4
        x = torch.ones(3, 2)
        assert PC.constrain_rows(x) is x
        # a mesh of 2 x 2 lays its rows over 4 shards, as a flat one does
        n, E = 1024, 4096
        ids, src, vals, _ = _case_data(n, E, 2)
        lay = PC.mesh_layout(ids, n, mesh)
        assert len(lay.shards) == 4 and not lay.arcs_local and not lay.rows_local
        PC.scatter_sum(torch.as_tensor(vals), lay)
        assert PC.BRANCHES["scatter"]["sharded"] == 1
        other = compat.make_mesh((4,), ("data",), device="cpu")
        with pytest.raises(ValueError, match="set_flat_sharding"):
            PC.scatter_sum(torch.as_tensor(vals), PC.mesh_layout(ids, n, other))
    finally:
        PC.set_flat_sharding(None, None)
        PC.reset_branches()


def test_stage_batch_and_mace_chunking_under_a_mesh(flat_mesh):
    """``stage_batch`` holds every array whole on one process and refuses
    a sharded array the shards do not divide; under a mesh MACE takes one
    chunk (the reference's ``single_dev`` rule)."""
    from repro_torch.models.gnn import mace as PM

    batch, _, _, shape = _molecules("mace")
    staged = PS.stage_batch(batch, flat_mesh)
    assert all(torch.equal(staged[k], torch.as_tensor(v)) for k, v in batch.items())
    with pytest.raises(ValueError, match="do not divide"):
        PS.stage_batch(dict(batch, src=batch["src"][:-2]), flat_mesh)
    assert PM.n_chunks_for(8_192_000) == 8
    PC.set_flat_sharding(flat_mesh, ("data",))
    assert PM.n_chunks_for(8_192_000) == 1
    lays = PS.mesh_layouts(get_smoke("mace"), shape, batch, flat_mesh)
    assert isinstance(lays["layout"], list) and len(lays["layout"]) == 1
    assert lays["pool"].n == 64 and lays["pool"].E == 2048
