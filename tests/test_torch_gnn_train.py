"""GNN training in the port (``repro_torch.models.gnn.steps.make_train_step``,
the float segment sum's backward, checkpointed blocks, the weather
example's loop) against the JAX package's, on the CPU, where the segment
sum runs its plain version inside the same ``torch.autograd.Function`` the
card runs.

The reference's weights (and its gradients and updated parameters) are
carried across with ``convert.params_from_jax``; batches come from the
port's builders, which draw the reference's arrays bit for bit. GraphCast's
generic mode and MACE run with ``COMPUTE_DTYPE`` set to float32 on both
sides, so every comparison here is float32 against float32.

Tolerances, and why:

- the segment sum's backward is a gather: bit-equal to ``index_select`` and
  to autograd through the plain version (both gather the same values);
  ``gradcheck`` in float64 at its defaults (eps 1e-6, atol 1e-5, rtol 1e-3);
- loss and ``grad_norm``: rtol 1e-5 (two float32 evaluations of the same
  function whose sums and products run in different orders);
- each gradient leaf: ``|port - jax| <= 1e-5 (|jax| + max|jax|)`` per leaf
  (float32 rounding of the forward and of the backward's GEMMs and gathers,
  relative to the leaf's own scale);
- each updated parameter: ``|port - jax| <= 2e-6`` absolute, except where the
  gradient lies within its own rounding noise of 0: the first AdamW step
  moves a parameter by about ``lr * g / |g|``, whose sign rounding noise
  decides there, so those entries are held to the step's size, ``lr``;
- EGNN on molecules: the reference's gradient is NaN in ``phi_e``,
  ``phi_x`` and ``embed_species``. Its ``lax.scan`` differentiates the last
  layer's unused coordinate update, where ``sqrt(d2)`` of a masked self-arc
  (src = dst = 0, so d2 = 0) has an infinite derivative times a zero
  cotangent. Those arcs add nothing to the loss (their message is masked,
  their ``rel`` is 0), so the reference is evaluated on the same batch
  without them, where its gradient is finite, and the port on the batch as
  built (its ``sqrt`` has a zero gradient at 0, so it is finite at any
  depth; ``torch.sqrt``'s would be NaN from the third layer on);
- the weather example's 25 losses: rtol 1e-4 step by step (each step's
  rounding differences move the next step's weights by up to the noise
  above, and 25 steps carry it forward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn.common as JC
import repro.models.gnn.mace as JM
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ShapeSpec as JShape
from repro.models.gnn import graphcast as JG, steps as JS
from repro.optim import AdamWConfig as JAdamW, adamw_init as jax_adamw_init, \
    adamw_update as jax_adamw_update
from repro_torch.configs import ShapeSpec, get_smoke
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.graph import generators as gen, sampler
from repro_torch.kernels.segment_sum import ops as sk
from repro_torch.launch import graphcast_weather as GW
from repro_torch.models.gnn import common as PC, convert, graphcast as PG, mace as PM
from repro_torch.models.gnn import steps as PS
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves, map_tree

ARCHS = ["schnet", "egnn", "mace", "graphcast"]
LR = 1e-3


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture
def float32(monkeypatch):
    """COMPUTE_DTYPE float32 on both sides."""
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(JM, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(PC, "COMPUTE_DTYPE", torch.float32)


# ----------------------- the segment sum's backward ----------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["(E,)", "(E, F)", "empty rows", "E = 0"])
def test_segment_sum_backward_is_the_gather(case, dtype):
    rng = np.random.default_rng(len(case))
    E, n, F = {"(E,)": (500, 40, None), "(E, F)": (700, 30, 9), "empty rows": (300, 200, 5),
               "E = 0": (0, 12, 4)}[case]
    ids = rng.integers(0, n if case != "empty rows" else 50, E)
    lay = sk.segment_layout(ids, n)
    shape = (E,) if F is None else (E, F)
    v = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    g = torch.as_tensor(rng.standard_normal((n,) if F is None else (n, F)).astype(np.float32)) \
        .to(dtype)
    vk = v.clone().requires_grad_(True)
    out = sk.segment_sum_float(vk, lay)
    assert out.requires_grad and out.dtype == dtype
    out.backward(g)
    vp = v.clone().requires_grad_(True)
    sk.segment_sum_float_ref(vp, lay.ids, n).backward(g)
    assert vk.grad.dtype == dtype and vk.grad.shape == shape
    assert torch.equal(vk.grad, g.index_select(0, lay.ids))
    assert torch.equal(vk.grad, vp.grad)


def test_segment_sum_gradcheck_and_no_launch_on_the_cpu():
    rng = np.random.default_rng(0)
    lay = sk.segment_layout(rng.integers(0, 7, 40), 9)
    v = torch.as_tensor(rng.standard_normal((40, 3))).requires_grad_(True)
    before = sk.float_launches
    assert torch.autograd.gradcheck(lambda x: sk.segment_sum_float(x, lay), (v,))
    assert torch.autograd.gradcheck(lambda x: sk.segment_sum_float(x[:, 0], lay), (v,))
    assert sk.float_launches == before
    # through the models' scatter, (E, C, 3) messages flattened and back
    m = torch.as_tensor(rng.standard_normal((40, 2, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: PC.scatter_sum(x, lay), (m,))
    with PC.plain_scatter():
        assert torch.autograd.gradcheck(lambda x: PC.scatter_mean(x, lay), (v,))


# ------------------------------ train steps ------------------------------- #

def _full_graph():
    g = gen.erdos_renyi(100, 350, seed=0)
    return PC.batch_from_graph(g, 12, 5, seed=1), 12, 5, \
        ShapeSpec("full_graph_sm", "full_graph", {"n_nodes": 100, "n_edges": 350, "d_feat": 12,
                                                  "n_classes": 5})


def _molecules():
    return PC.batch_molecules(6, 10, 20, 4, seed=2), None, 0, \
        ShapeSpec("molecule", "molecule", {"n_nodes": 10, "n_edges": 20, "batch": 6})


def _sampled():
    g = gen.barabasi_albert(500, 4, seed=0)
    sub = sampler.sample_subgraph(g, np.arange(16), (5, 3), seed=1)
    b = PC.batch_from_sampled(g, sub, d_feat=12, n_classes=5)
    return {k: v for k, v in b.items() if k != "n_seeds"}, 12, 5, \
        ShapeSpec("minibatch_lg", "minibatch", {"batch_nodes": 16, "fanout": (5, 3), "d_feat": 12,
                                                "n_classes": 5})


BATCHES = {"full_graph": _full_graph, "molecule": _molecules, "minibatch": _sampled}


def _jax_loss(cfg, shape):
    """The reference's loss of ``shape`` (its ``make_train_step``'s)."""
    def loss_fn(params, batch):
        if shape.kind == "molecule":
            return JS._energy_loss(params, cfg, batch, shape.params["batch"])
        mask = batch["node_mask"]
        if shape.kind == "minibatch":
            mask = (jnp.arange(mask.shape[0]) < shape.params["batch_nodes"]) & mask
        return JS._ce_loss(params, cfg, batch, mask)
    return loss_fn


def _port_loss(cfg, shape):
    def loss_fn(params, batch):
        if shape.kind == "molecule":
            return PS._energy_loss(params, cfg, batch, shape.params["batch"])
        mask = batch["node_mask"]
        if shape.kind == "minibatch":
            mask = (torch.arange(mask.shape[0]) < shape.params["batch_nodes"]) & mask
        return PS._ce_loss(params, cfg, batch, mask)
    return loss_fn


def _carry(tree, arch):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), get_smoke(arch), device="cpu")


def _hold_grads(got, want):
    assert len(leaves(got)) == len(leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        w, g = _np(w), _np(g)
        assert g.shape == w.shape
        np.testing.assert_array_less(np.abs(g - w), 1e-5 * (np.abs(w) + np.abs(w).max()) + 1e-30)


def _hold_updated(got, want, grads, before):
    """Updated parameters within 2e-6, or within ``LR`` where the gradient
    is within its rounding noise of 0 (the module docstring)."""
    for p, w, g, p0 in zip(leaves(got), leaves(want), leaves(grads), leaves(before)):
        p, w, g, p0 = _np(p), _np(w), _np(g), _np(p0)
        noisy = np.abs(g) <= 1e-5 * np.abs(g).max()
        np.testing.assert_allclose(p[~noisy], w[~noisy], rtol=0, atol=2e-6)
        assert (np.abs(p - w)[noisy] <= 1.01 * LR).all()
        assert (np.abs(p - p0) <= 1.01 * LR).all()      # AdamW's first step is at most lr


@pytest.mark.parametrize("arch,kind", [(a, k) for a in ARCHS for k in ("full_graph", "molecule")]
                         + [("graphcast", "minibatch")])
def test_train_step_matches_the_reference(arch, kind, float32):
    batch, d_in, n_classes, shape = BATCHES[kind]()
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jp = JS.init_params(jcfg, jax.random.key(0), d_in=d_in, n_classes=n_classes)
    pp = _carry(jp, arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = PC.batch_to(batch, "cpu")
    jshape = JShape(shape.name, shape.kind, dict(shape.params))
    if (arch, kind) == ("egnn", "molecule"):     # the module docstring's EGNN caveat
        jgrads = jax.grad(_jax_loss(jcfg, jshape))(jp, jb)
        assert np.isnan(np.asarray(jgrads["blocks"]["phi_e"][0]["w"])).any()
        keep = batch["edge_mask"]
        assert not keep.all()
        jb = dict(jb, **{k: jnp.asarray(batch[k][keep]) for k in ("src", "dst", "edge_mask")})

    # the gradient of every leaf
    jgrads = jax.grad(_jax_loss(jcfg, jshape))(jp, jb)
    loss, pgrads = PS.value_and_grad(_port_loss(cfg, shape), pp, pb)
    _hold_grads(pgrads, _carry(jgrads, arch))

    # one step of each side's make_train_step
    jnew, jopt, jm = jax.jit(JS.make_train_step(jcfg, jshape))(jp, jax_adamw_init(jp), jb)
    pnew, popt, pm = PS.make_train_step(cfg, shape)(pp, adamw_init(pp), pb)
    assert set(pm) == {"loss", "grad_norm", "lr"} and pm["lr"] == pytest.approx(LR)
    assert float(pm["loss"]) == float(loss)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    assert int(popt["count"]) == 1
    assert all(bool(torch.isfinite(g).all()) for g in leaves(pgrads))
    _hold_updated(pnew, _carry(jnew, arch), pgrads, pp)
    _hold_grads(popt["m"], _carry(jopt["m"], arch))


def test_egnn_molecule_gradient_at_full_depth(float32):
    """EGNN's full config (4 layers, d 64) on molecules with masked
    self-arcs: the port's gradient is finite and is the reference's on the
    batch without those arcs (the module docstring's caveat)."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    batch, _, _, shape = _molecules()
    jcfg, cfg = jax_config("egnn"), get_config("egnn")
    jp = JS.init_params(jcfg, jax.random.key(0))
    pp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    keep = batch["edge_mask"]
    jb = {k: jnp.asarray(v[keep] if k in ("src", "dst", "edge_mask") else v)
          for k, v in batch.items()}
    jshape = JShape(shape.name, shape.kind, dict(shape.params))
    jl, jgrads = jax.value_and_grad(_jax_loss(jcfg, jshape))(jp, jb)
    loss, pgrads = PS.value_and_grad(_port_loss(cfg, shape), pp, PC.batch_to(batch, "cpu"))
    assert all(bool(torch.isfinite(g).all()) for g in leaves(pgrads))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    _hold_grads(pgrads, convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                                device="cpu"))


@pytest.mark.parametrize("arch", ["graphcast", "mace"])
def test_bf16_train_step_is_held_to_float64(arch):
    """As the models run (bf16 activations): the port's loss and grad norm
    against a float64 step of the same weights (plain scatter) are no
    further than the float32 activations' own distance from it plus one bf16
    ulp (``checks.hold_bf16``)."""
    from repro_torch.checks import hold_bf16

    batch, d_in, n_classes, shape = _full_graph()
    cfg = get_smoke(arch)
    pp = PS.init_params(cfg, 0, d_in=d_in, n_classes=n_classes, device="cpu")
    pb = PC.batch_to(batch, "cpu")
    step = PS.make_train_step(cfg, shape)
    _, _, bf = step(pp, adamw_init(pp), pb)
    with PC.plain_scatter():
        _, _, f64 = step(PC.params_to(pp, dtype=torch.float64), adamw_init(
            PC.params_to(pp, dtype=torch.float64)), pb)
    compute, PC.COMPUTE_DTYPE = PC.COMPUTE_DTYPE, torch.float32
    try:
        _, _, f32 = step(pp, adamw_init(pp), pb)
    finally:
        PC.COMPUTE_DTYPE = compute
    for k in ("loss", "grad_norm"):
        r = hold_bf16(bf[k], f32[k], f64[k])
        assert r["ok"], (k, r)


# ----------------------------- checkpointing ------------------------------ #

def _grads(fn, params):
    return PS.value_and_grad(fn, params)[1]


@pytest.mark.parametrize("model", ["graphcast generic", "graphcast weather", "mace"])
def test_checkpointed_gradients_are_bit_equal_to_plain_autograd(model, monkeypatch):
    if model == "graphcast weather":
        cfg = get_smoke("graphcast")
        params = PG.init_weather_params(cfg, 0, device="cpu")
        graph, layouts = GW.make_graph(cfg, "cpu")
        state, target = GW.example_data(cfg, "cpu")

        def loss(p):
            return GW.weather_loss(p, cfg, state, target, graph, layouts)
    else:
        arch = model.split()[0]
        batch, d_in, n_classes, shape = _full_graph()
        cfg = get_smoke(arch)
        params = PS.init_params(cfg, 0, d_in=d_in, n_classes=n_classes, device="cpu")
        pb = PC.batch_to(batch, "cpu")
        step_loss = _port_loss(cfg, shape)

        def loss(p):
            return step_loss(p, pb)

    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    mod = PM if model == "mace" else PG
    monkeypatch.setattr(mod, "checkpoint", counting)
    ckpt = _grads(loss, params)
    assert len(calls) == cfg.n_layers * (1 if model != "mace" else len(PM.edge_layouts(pb)))
    monkeypatch.setattr(mod, "checkpoint", lambda fn, *args, **kw: fn(*args))
    plain = _grads(loss, params)
    for a, b in zip(leaves(ckpt), leaves(plain)):
        assert torch.equal(a, b)
    with torch.no_grad():
        calls.clear()
        monkeypatch.setattr(mod, "checkpoint", counting)
        loss(params)
    assert not calls         # nothing is checkpointed outside autograd


# ------------------------------ weather loop ------------------------------ #

def test_weather_example_losses_match_the_reference():
    """The example's 25 AdamW steps (``examples/graphcast_weather.py``) on
    both sides from the reference's weights."""
    jcfg, cfg = jax_smoke("graphcast"), get_smoke("graphcast")
    jp = JG.init_weather_params(jcfg, jax.random.key(0))
    pp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jgraph = {k: jnp.asarray(v) for k, v in JG.make_weather_graph(jcfg).items()}
    state, target = GW.example_data(cfg, "cpu")
    s, tgt = jnp.asarray(state.numpy()), jnp.asarray(target.numpy())

    def loss_fn(p, s_):
        pred = JG.weather_forward(p, jcfg, s_, jgraph)
        return jnp.mean((pred - (0.9 * s_ + 0.1 * tgt)) ** 2)

    opt_cfg = JAdamW(lr=1e-3, weight_decay=0.0)
    step = jax.jit(lambda p, o, s_: (lambda l, g: jax_adamw_update(p, g, o, opt_cfg) + (l,))(
        *jax.value_and_grad(loss_fn)(p, s_)))
    opt, want = jax_adamw_init(jp), []
    for _ in range(25):
        jp, opt, _, loss = step(jp, opt, s)
        want.append(float(loss))
        s = 0.9 * s + 0.1 * tgt
    graph, layouts = GW.make_graph(cfg, "cpu")
    got = GW.train(pp, cfg, graph, layouts, 25)
    assert len(got.losses) == len(got.ms_per_step) == 25
    np.testing.assert_allclose(got.losses, want, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]
    assert int(got.opt_state["count"]) == 25


# ------------------------------- build_train ------------------------------ #

@pytest.mark.parametrize("shape", [s.name for s in GNN_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_train_without_a_mesh_has_the_reference_specs(arch, shape):
    spec = next(s for s in GNN_SHAPES if s.name == shape)
    cfg = get_smoke(arch)
    step, specs, in_sh, out_sh = PS.build_train(cfg, spec, None)
    assert callable(step) and in_sh is None and out_sh is None and PS.build_step is PS.build_train
    assert specs["batch"] == PS.batch_specs(cfg, spec)
    jstep, jspecs, _, _ = JS.build_train(jax_smoke(arch), JShape(spec.name, spec.kind,
                                                                 dict(spec.params)), None)
    want = [tuple(x.shape) for x in jax.tree.leaves(jspecs["_params"])]
    blocks = specs["_params"]["blocks"]       # one dict per layer; the reference stacks them
    stacked = dict(specs["_params"], blocks=map_tree(lambda s: (cfg.n_layers, *s), blocks[0]))
    assert leaves(stacked) == want
    assert len(specs["_params"]["blocks"]) == cfg.n_layers

