"""The port's GNN family (``repro_torch.models.gnn``) against the JAX
package's, on the CPU, where the segment sum runs its plain version.

The reference's weights (``repro.models.gnn.steps.init_params``,
``graphcast.init_weather_params``) are carried across with
``convert.params_from_jax``; batches come from the port's builders, which
draw the reference's arrays bit for bit.

Tolerances:

- float32 outputs (SchNet, EGNN, GraphCast's weather mode; GraphCast's
  generic mode and MACE with ``COMPUTE_DTYPE`` set to float32 on both
  sides): ``assert_allclose`` rtol 1e-5, atol 1e-5 (observed below 1e-6:
  the two differ in the order of their sums and products and in the last
  float32 place of ``linspace``, ``sqrt(d2 + 1e-12)`` and the Bessel
  envelope);
- bf16 outputs (GraphCast's generic mode and MACE as they run): the port's
  distance from a float64 evaluation of the same weights and batch (the
  port in float64, which the float32 cases hold to the reference's
  algorithm) is no larger than the reference's own distance from it plus
  one bf16 ulp of the largest magnitude (``checks.hold_bf16``). The
  reference's bf16 segment sums accumulate in bf16, the port's in float32.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn.common as JC
import repro.models.gnn.mace as JM
from repro.configs import get_config as jax_config, get_smoke as jax_smoke
from repro.configs.base import ShapeSpec as JShape
from repro.graph import generators as jgen
from repro.graph import sampler as jsampler
from repro.models.gnn import graphcast as JG, steps as JS
from repro_torch.checks import hold_bf16
from repro_torch.configs import ShapeSpec, get_config, get_smoke
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.graph import generators as gen, sampler
from repro_torch.kernels.segment_sum import ops as sk
from repro_torch.models.gnn import common as PC, convert, graphcast as PG, mace as PM
from repro_torch.models.gnn import steps as PS

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["schnet", "egnn", "mace", "graphcast"]
BF16_ARCHS = ("mace", "graphcast")
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().cpu().numpy()


def _f64(tree):
    return PC.params_to(tree, dtype=torch.float64)


def _full_graph():
    g = gen.erdos_renyi(100, 350, seed=0)
    return PC.batch_from_graph(g, 12, 5, seed=1), 12


def _molecules():
    return PC.batch_molecules(6, 10, 20, 4, seed=2), None


def _sampled():
    g = gen.barabasi_albert(500, 4, seed=0)
    sub = sampler.sample_subgraph(g, np.arange(16), (5, 3), seed=1)
    b = PC.batch_from_sampled(g, sub, d_feat=12, n_classes=5)
    return {k: v for k, v in b.items() if k != "n_seeds"}, 12


BATCHES = {"full_graph": _full_graph, "molecule": _molecules, "sampled": _sampled}


def _models(arch, d_in, n_classes=5):
    jp = JS.init_params(jax_smoke(arch), jax.random.key(0), d_in=d_in, n_classes=n_classes)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), get_smoke(arch),
                                       device="cpu")


def _run(fn_j, fn_p, batch):
    jout = fn_j({k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        pout = fn_p(PC.batch_to(batch, "cpu"))
    return jout, pout


def _hold(arch, jout, pout, p64out):
    jout = jax.tree.leaves(jout)
    pout, p64out = [pout] if torch.is_tensor(pout) else list(pout), \
        [p64out] if torch.is_tensor(p64out) else list(p64out)
    for j, p, p64 in zip(jout, pout, p64out):
        assert p.shape == tuple(j.shape)
        if arch in BF16_ARCHS:
            assert p.dtype == torch.bfloat16
            r = hold_bf16(p, torch.as_tensor(np.asarray(j, np.float32)), p64)
            assert r["ok"], r
        else:
            assert p.dtype == torch.float32
            np.testing.assert_allclose(_np(p), np.asarray(j), **F32)
            np.testing.assert_allclose(_np(p), _np(p64), rtol=1e-4, atol=1e-4)


# ------------------------------ builders ---------------------------------- #

def _same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("which", ["graph", "graph no positions", "molecules", "sampled"])
def test_batch_builders_equal_the_reference(which):
    if which.startswith("graph"):
        pos = which == "graph"
        _same(PC.batch_from_graph(gen.erdos_renyi(100, 350, seed=0), 12, 5, seed=1,
                                  with_positions=pos),
              JC.batch_from_graph(jgen.erdos_renyi(100, 350, seed=0), 12, 5, seed=1,
                                  with_positions=pos))
    elif which == "molecules":
        _same(PC.batch_molecules(6, 10, 20, 4, seed=2), JC.batch_molecules(6, 10, 20, 4, seed=2))
    else:
        g, jg = gen.barabasi_albert(500, 4, seed=0), jgen.barabasi_albert(500, 4, seed=0)
        sub = sampler.sample_subgraph(g, np.arange(16), (5, 3), seed=1)
        jsub = jsampler.sample_subgraph(jg, np.arange(16), (5, 3), seed=1)
        for name in ("seeds",):
            np.testing.assert_array_equal(getattr(sub, name), getattr(jsub, name))
        for a, b in zip(sub.layer_nodes + sub.node_mask, jsub.layer_nodes + jsub.node_mask):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sub.blocks, jsub.blocks):
            for f in ("dst_index", "src_index", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        _same(PC.batch_from_sampled(g, sub, 12, 5), JC.batch_from_sampled(jg, jsub, 12, 5))
        feats = np.random.default_rng(4).normal(size=(g.n, 12)).astype(np.float32)
        labels = np.arange(g.n, dtype=np.int32)
        _same(PC.batch_from_sampled(g, sub, 12, 5, feats=feats, labels=labels, seed=3),
              JC.batch_from_sampled(jg, jsub, 12, 5, feats=feats, labels=labels, seed=3))


def test_minibatch_stream_equals_the_reference():
    g, jg = gen.barabasi_albert(300, 3, seed=5), jgen.barabasi_albert(300, 3, seed=5)
    got = list(sampler.minibatch_stream(g, 64, (4, 2), seed=9, epochs=2))
    want = list(jsampler.minibatch_stream(jg, 64, (4, 2), seed=9, epochs=2))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        for x, y in zip(a.layer_nodes, b.layer_nodes):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_weather_graph_equals_the_reference(which):
    jcfg, cfg = (jax_smoke, get_smoke) if which == "smoke" else (jax_config, get_config)
    _same(PG.make_weather_graph(cfg("graphcast"), seed=3),
          JG.make_weather_graph(jcfg("graphcast"), seed=3))


@pytest.mark.parametrize("shape", [s.name for s in GNN_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_configs_equal_the_reference(arch, shape):
    spec = next(s for s in GNN_SHAPES if s.name == shape)
    want = JS.batch_specs(jax_config(arch), JShape(spec.name, spec.kind, dict(spec.params)))
    got = PS.batch_specs(get_config(arch), spec)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k][0] == tuple(w.shape), k
        assert str(got[k][1]).removeprefix("torch.") == str(w.dtype), k
    assert PS.n_classes_for(spec) == JS.n_classes_for(spec)
    for mine, theirs in [(get_config(arch), jax_config(arch)), (get_smoke(arch), jax_smoke(arch))]:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_pad512_and_pad_batch():
    for x in (1, 512, 513, 4_000_000, 4_000_001, 59_697_930):
        assert PS._pad512(x) == JS._pad512(x)
    b = PC.batch_from_graph(gen.erdos_renyi(100, 350, seed=0), 12, 5, seed=1)
    p = PS.pad_batch(b)
    E = b["src"].shape[0]
    assert p["src"].shape == (PS._pad512(E),) and p["feats"].shape == (512, 12)
    assert p["edge_mask"][:E].all() and not p["edge_mask"][E:].any()
    assert not p["node_mask"][100:].any() and not p["feats"][100:].any()
    np.testing.assert_array_equal(p["dst"][:E], b["dst"])
    assert p["labels"].shape == (512,) and p["src"].dtype == np.int32


# --------------------------- substrate ------------------------------------ #

@pytest.mark.parametrize("shape", [(), (7,), (3, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_sum_and_mean_and_gathers_equal_the_reference(dtype, shape):
    rng = np.random.default_rng(len(shape))
    E, n = 600, 41
    ids = rng.integers(0, n - 3, E).astype(np.int32)
    v = rng.standard_normal((E, *shape)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    lay = PC.segment_layout(torch.as_tensor(ids), n)
    vt = torch.as_tensor(v).to(tdt)
    jv = jnp.asarray(v).astype(jdt)
    exact = torch.zeros((n, *shape), dtype=torch.float64).index_add_(
        0, torch.as_tensor(ids, dtype=torch.int64), vt.double())
    got = PC.scatter_sum(vt, lay)
    want = torch.as_tensor(np.array(JC.scatter_sum(jv, jnp.asarray(ids), n).astype(jnp.float32)))
    assert got.shape == (n, *shape) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want.numpy(), rtol=1e-5, atol=1e-5)
    else:
        assert hold_bf16(got, want, exact)["ok"]
    if len(shape) <= 1:
        m = PC.scatter_mean(vt, lay)
        jm = np.asarray(JC.scatter_mean(jv, jnp.asarray(ids), n).astype(jnp.float32))
        np.testing.assert_allclose(_np(m), jm, rtol=1e-5 if dtype == "float32" else 2e-2,
                                   atol=1e-5 if dtype == "float32" else 2e-2)
    h = rng.standard_normal((n, 5)).astype(np.float32)
    idx = (ids, rng.integers(0, n, E).astype(np.int32))
    for a, b in zip(PC.gather_rows_multi(torch.as_tensor(h), tuple(map(torch.as_tensor, idx))),
                    JC.gather_rows_multi(jnp.asarray(h), tuple(map(jnp.asarray, idx)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(PC.gather_rows(torch.as_tensor(h), torch.as_tensor(ids)).numpy(),
                                  np.asarray(JC.gather_rows(jnp.asarray(h), jnp.asarray(ids))))


def test_plain_scatter_route_and_radial_bases():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, 300)
    lay = PC.segment_layout(ids, 9)
    v = torch.as_tensor(rng.standard_normal((300, 4)).astype(np.float32))
    with PC.plain_scatter():
        a = PC.scatter_sum(v, lay)
        a64 = PC.scatter_sum(v.double(), lay)
    assert torch.equal(a, PC.scatter_sum(v, lay))     # the CPU route is the plain version
    assert a64.dtype == torch.float64
    d = np.abs(rng.standard_normal(50)).astype(np.float32) * 4
    for p, j in [(PC.gaussian_rbf(torch.as_tensor(d), 16, 10.0), JC.gaussian_rbf(d, 16, 10.0)),
                 (PC.bessel_rbf(torch.as_tensor(d), 8, 5.0), JC.bessel_rbf(d, 8, 5.0))]:
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    np.testing.assert_allclose(PC.layernorm(torch.as_tensor(x)).numpy(),
                               np.asarray(JC.layernorm(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_no_mesh_yet():
    PC.set_flat_sharding(None, None)
    x = torch.ones(3)
    assert PC.constrain_rows(x) is x
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 12"):
        PC.set_flat_sharding(object(), ("data",))


# ------------------------------ models ------------------------------------ #

@pytest.mark.parametrize("kind", ["full_graph", "molecule"])
@pytest.mark.parametrize("arch", ARCHS)
def test_node_embeddings_match_the_reference(arch, kind):
    batch, d_in = BATCHES[kind]()
    jp, pp = _models(arch, d_in)
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jmod, pmod = JS.model_module(jcfg), PS.model_module(cfg)
    jout, pout = _run(lambda b: jmod.node_embeddings(jp, jcfg, b),
                      lambda b: pmod.node_embeddings(pp, cfg, b), batch)
    with torch.no_grad(), PC.plain_scatter():
        p64 = pmod.node_embeddings(_f64(pp), cfg, PC.batch_to(batch, "cpu"))
    assert p64.dtype == torch.float64
    _hold(arch, jout, pout, p64)


@pytest.mark.parametrize("kind", ["full_graph", "molecule"])
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_models_in_float32_match_the_reference(arch, kind, monkeypatch):
    """The algorithm without bf16 noise: COMPUTE_DTYPE float32 on both sides."""
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PC, "COMPUTE_DTYPE", torch.float32)
    batch, d_in = BATCHES[kind]()
    jp, pp = _models(arch, d_in)
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jout, pout = _run(lambda b: JS.model_module(jcfg).node_embeddings(jp, jcfg, b),
                      lambda b: PS.model_module(cfg).node_embeddings(pp, cfg, b), batch)
    assert pout.dtype == torch.float32
    np.testing.assert_allclose(_np(pout), np.asarray(jout), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_node_logits_on_a_full_graph(arch):
    batch, d_in = _full_graph()
    jp, pp = _models(arch, d_in)
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jout, pout = _run(lambda b: JS.node_logits(jp, jcfg, b),
                      lambda b: PS.node_logits(pp, cfg, b), batch)
    with torch.no_grad(), PC.plain_scatter():
        p64 = PS.node_logits(_f64(pp), cfg, PC.batch_to(batch, "cpu"))
    assert pout.shape == (100, 5)
    _hold(arch, jout, pout, p64)


@pytest.mark.parametrize("arch", ["schnet", "egnn", "mace"])
def test_energy_on_molecules(arch):
    batch, _ = _molecules()
    jp, pp = _models(arch, None, n_classes=0)
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    mod = PS.model_module(cfg)
    jout, pout = _run(lambda b: JS.model_module(jcfg).energy(jp, jcfg, b, 6),
                      lambda b: mod.energy(pp, cfg, b, 6), batch)
    with torch.no_grad(), PC.plain_scatter():
        p64 = mod.energy(_f64(pp), cfg, PC.batch_to(batch, "cpu"), 6)
    assert pout.shape == (6,)
    _hold(arch, jout, pout, p64)
    # layouts built once and passed in give the same result
    b = PC.batch_to(batch, "cpu")
    with torch.no_grad():
        again = mod.energy(pp, cfg, b, 6, layout=PS.edge_layout(cfg, b),
                           pool=PC.graph_layout(b, 6))
    assert torch.equal(again, pout)


def test_egnn_return_pos():
    batch, _ = _molecules()
    jp, pp = _models("egnn", None, n_classes=0)
    jcfg, cfg = jax_smoke("egnn"), get_smoke("egnn")
    (jh, jx), (ph, px) = _run(
        lambda b: JS.model_module(jcfg).node_embeddings(jp, jcfg, b, return_pos=True),
        lambda b: PS.model_module(cfg).node_embeddings(pp, cfg, b, return_pos=True), batch)
    assert px.shape == (60, 3)
    np.testing.assert_allclose(_np(ph), np.asarray(jh), **F32)
    np.testing.assert_allclose(_np(px), np.asarray(jx), **F32)


def test_graphcast_generic_on_a_sampled_batch():
    batch, d_in = _sampled()
    jp, pp = _models("graphcast", d_in)
    jcfg, cfg = jax_smoke("graphcast"), get_smoke("graphcast")
    jout, pout = _run(lambda b: JS.node_logits(jp, jcfg, b),
                      lambda b: PS.node_logits(pp, cfg, b), batch)
    with torch.no_grad(), PC.plain_scatter():
        p64 = PS.node_logits(_f64(pp), cfg, PC.batch_to(batch, "cpu"))
    assert pout.shape == (16 + 80 + 240, 5)
    _hold("graphcast", jout, pout, p64)


@pytest.mark.parametrize("steps", [1, 3])
def test_weather_forward_matches_the_reference(steps):
    jcfg, cfg = jax_smoke("graphcast"), get_smoke("graphcast")
    jp = JG.init_weather_params(jcfg, jax.random.key(0))
    pp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    from repro_torch.launch import graphcast_weather as GW

    graph, layouts = GW.make_graph(cfg, "cpu")
    jgraph = {k: jnp.asarray(v) for k, v in JG.make_weather_graph(jcfg).items()}
    state = GW.initial_state(cfg, "cpu")
    j = jnp.asarray(state.numpy())
    for _ in range(steps):
        j = JG.weather_forward(jp, jcfg, j, jgraph)
    res = GW.rollout(pp, cfg, state, graph, layouts, steps)
    assert res.state.dtype == torch.float32 and len(res.ms_per_step) == steps
    np.testing.assert_allclose(res.state.numpy(), np.asarray(j), **F32)
    with PC.plain_scatter():
        s64 = GW.rollout(_f64(pp), cfg, state.double(), graph, layouts, steps).state
    np.testing.assert_allclose(res.state.numpy(), s64.numpy(), rtol=1e-4, atol=1e-4)


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return q * np.sign(np.diag(r))[None, :]


@pytest.mark.parametrize("arch", ["mace", "egnn", "schnet"])
def test_geometric_invariance(arch):
    """Rotating and translating all positions leaves the port's scalar node
    embeddings unchanged (tests/test_models_semantics.py's contract and
    tolerance)."""
    cfg = get_smoke(arch)
    batch = PC.batch_molecules(4, 8, 14, 4, seed=0)
    params = PS.init_params(cfg, 0, device="cpu")
    mod = PS.model_module(cfg)
    R = _rotation(5)
    moved = dict(batch, positions=(batch["positions"] @ R.T + 1.7).astype(np.float32))
    with torch.no_grad():
        h0 = mod.node_embeddings(params, cfg, PC.batch_to(batch, "cpu"))
        h1 = mod.node_embeddings(params, cfg, PC.batch_to(moved, "cpu"))
    np.testing.assert_allclose(_np(h0), _np(h1), rtol=2e-2, atol=2e-2)


def test_mace_chunks_as_the_reference():
    for E in (0, 2_000_000, 2_000_896, 2_048_000, 59_703_296, 59_697_930):
        lay_count = PM.n_chunks_for(E)
        n_chunks = 1
        while E // n_chunks > 2_000_000:
            n_chunks *= 2
        while n_chunks > 1 and (E % n_chunks or (E // n_chunks) % 512):
            n_chunks //= 2
        assert lay_count == n_chunks
    assert PM.n_chunks_for(59_703_296) == 32 and PM.n_chunks_for(59_697_930) == 1
    b = PC.batch_to(PC.batch_molecules(6, 10, 20, 4, seed=2), "cpu")
    assert len(PM.edge_layouts(b)) == 1


def test_mace_chunked_branch_matches_the_reference(monkeypatch):
    """A batch of 2,048,000 arcs (above 2,000,000, so both sides take two
    512-aligned chunks of 1,024,000) at SMOKE width, float32 on both sides
    (about 7 s and 2 GB)."""
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PC, "COMPUTE_DTYPE", torch.float32)
    batch = PC.batch_molecules(1000, 200, 1024, 4, seed=2)
    b = PC.batch_to(batch, "cpu")
    layouts = PM.edge_layouts(b)
    assert len(layouts) == 2 and all(lay.ids.numel() == 1_024_000 for lay in layouts)
    jp, pp = _models("mace", None, n_classes=0)
    cfg, jcfg = get_smoke("mace"), jax_smoke("mace")
    want = JM.node_embeddings(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = PM.node_embeddings(pp, cfg, b, layout=layouts)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# ------------------------------ weights ----------------------------------- #

@pytest.mark.parametrize("kind", ["model", "weather"])
def test_params_from_jax_round_trip_and_errors(kind):
    cfg, jcfg = get_smoke("graphcast"), jax_smoke("graphcast")
    if kind == "model":
        jp = JS.init_params(jcfg, jax.random.key(0), d_in=12, n_classes=5)
    else:
        jp = JG.init_weather_params(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    pp = convert.params_from_jax(tree, cfg, device="cpu")
    assert isinstance(pp["blocks"], list) and len(pp["blocks"]) == cfg.n_layers
    stacked = jax.tree.map(lambda *x: np.stack(x), *[jax.tree.map(lambda t: t.numpy(), b)
                                                     for b in pp["blocks"]])
    for a, b in zip(jax.tree.leaves(tree["blocks"]), jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(a, b)
    rest = {k: jax.tree.map(lambda t: t.numpy(), v) for k, v in pp.items() if k != "blocks"}
    for a, b in zip(jax.tree.leaves({k: v for k, v in tree.items() if k != "blocks"}),
                    jax.tree.leaves(rest)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax({k: v for k, v in tree.items() if k != "blocks"}, cfg,
                                device="cpu")
    first = "encode" if kind == "model" else "grid_encode"
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(dict(tree, **{first: tree[first][:-1]}), cfg, device="cpu")
    short = jax.tree.map(lambda x: x[:1], tree["blocks"])
    with pytest.raises(ValueError, match=r"\['blocks'\]"):
        convert.params_from_jax(dict(tree, blocks=short), cfg, device="cpu")
    bad = jax.tree.map(lambda x: x, tree)
    bad["blocks"]["node_mlp"][0]["w"] = np.zeros((2, 3, 3), np.float32)
    with pytest.raises(ValueError, match=r"node_mlp'\]\[0\]\['w'\]"):
        convert.params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout_and_is_seeded(arch):
    from repro_torch.tree import leaves

    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    d_in = 12
    jshapes = jax.eval_shape(lambda k: JS.init_params(jcfg, k, d_in=d_in, n_classes=5),
                             jax.random.key(0))
    a = PS.init_params(cfg, 3, d_in=d_in, n_classes=5, device="cpu")
    stacked = dict(a, blocks=jax.tree.map(lambda *x: np.stack(x),
                                          *[jax.tree.map(lambda t: t.numpy(), b)
                                            for b in a["blocks"]]))
    assert [tuple(x.shape) for x in jax.tree.leaves(jshapes)] == \
        [tuple(np.shape(x)) for x in jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy() if torch.is_tensor(t) else t, stacked))]
    b = PS.init_params(cfg, 3, d_in=d_in, n_classes=5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    c = PS.init_params(cfg, 4, d_in=d_in, n_classes=5, device="cpu")
    assert not torch.equal(a["classify"], c["classify"])


# ------------------------------ launcher ---------------------------------- #

def _launch(*args, **env):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.graphcast_weather", *args],
                          capture_output=True, text=True, timeout=300, cwd=ROOT, env=e)


def test_graphcast_weather_cli_on_the_cpu():
    out = _launch("--smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "3-step rollout finite: True shape: (84, 8)"
    assert lines[1].startswith("device: cpu") and "graphcast-smoke" in lines[1]
    assert "ms a step" in lines[1] and "peak device memory not measured" in lines[1]
    bad = _launch("--smoke", "--device", "cpu", "--steps", "0")
    assert bad.returncode == 2


def test_graphcast_weather_cli_without_a_card_fails_unless_cpu_is_asked():
    out = _launch("--smoke", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_float_kernel_counter_moves_only_on_the_card():
    batch, _ = _molecules()
    cfg = get_smoke("schnet")
    before = sk.float_launches
    with torch.no_grad():
        PS.model_module(cfg).energy(PS.init_params(cfg, 0, device="cpu"), cfg,
                                    PC.batch_to(batch, "cpu"), 6)
    assert sk.float_launches == before
