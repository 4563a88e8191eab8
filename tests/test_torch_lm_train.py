"""LM training in the port (``repro_torch.models.transformer.model.
forward_hidden``/``lm_loss``, ``steps.make_train_step``) against the JAX
package's, on the CPU, at the three dense ``SMOKE`` configs:
``qwen1.5-0.5b`` (QKV bias, tied embeddings), ``yi-34b`` (GQA) and
``granite-34b`` (MQA, GELU).

The reference's weights and AdamW state are carried across with
``convert.params_from_jax`` and ``convert.opt_state_from_jax``; batches are
``synth_lm_batch``'s, the same arrays on both sides. Both sides compute in
bf16 (float32 parameters cast at use, scores and logits cast to float32),
and they round at different places: XLA keeps fused intermediates in
float32 where PyTorch rounds each op's output to bf16, and matmuls
accumulate in different orders. Tolerances, and why:

- hidden states and logits: 4 bf16 units in the last place (ulps) of the
  tensor's largest magnitude (observed at most 2; ``test_torch_transformer``
  holds serving logits to 2);
- the loss: 1e-3 absolute (a mean of float32 ``lse - gold`` terms, each from
  bf16 logits whose ulp near the largest logit, about 0.2 at this width, is
  2^-10; observed at most 9e-5);
- each gradient leaf: 8 bf16 ulps of the leaf's largest magnitude. The
  gradient passes back through every layer's bf16 rounding on both sides;
  the bias gradients sum B*S bf16 rows that the two round differently, and
  ``bk``'s exact value is 0 (a key bias shifts all of a query's scores
  alike), so its gradient is the rounding noise of both. Observed at most
  3.5 ulps;
- ``grad_norm``: rtol 1e-3 (a norm over the leaves above; observed 2e-4);
  ``lr``: rtol 1e-6 (the same float32 schedule on both sides);
- after one AdamW step from a carried state (count 1): the moments within
  what the gradient's tolerance allows (m gets 0.1 g, v gets 0.05 g^2); the
  parameters within 2 lr + 2 float32 ulps: the second AdamW step moves an
  entry by at most 1.0003 lr (by Cauchy-Schwarz over the two bias-corrected
  moments), and where a gradient lies within its rounding noise of 0 the
  two sides may move it in opposite directions (observed 1.35 lr);
- 30 training steps: each step's loss within the loss tolerance, 1e-3, of
  JAX's (each step's rounding moves the next step's weights a little;
  observed at most 9e-5).

Checkpointed and plain gradients are compared bit for bit: the recompute
runs the same operations on the same inputs.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data import synth_lm_batch as jax_synth_lm_batch
from repro.models.transformer import model as JM
from repro.models.transformer.steps import make_train_step as jax_make_train_step
from repro.optim import AdamWConfig as JAdamW, adamw_init as jax_adamw_init
from repro_torch import checks
from repro_torch.configs import get_smoke
from repro_torch.configs.registry import shape_by_name
from repro_torch.data import synth_lm_batch
from repro_torch.kernels.segment_sum import ops as sk
from repro_torch.launch import serve
from repro_torch.models.autodiff import value_and_grad
from repro_torch.models.transformer import model as PM, steps as PS
from repro_torch.models.transformer.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import leaves

ARCHS = ["qwen1.5-0.5b", "yi-34b", "granite-34b"]
B, S = 4, 48
LR = 3e-3


def _ulp(x) -> float:
    """A bf16 ulp of x's largest magnitude."""
    return checks.bf16_ulp(float(np.max(np.abs(x))))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _carry(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batch(vocab, b=B, s=S, seed=0, step=0):
    return synth_lm_batch(vocab, b, s, seed=seed, step=step)


def _paths(tree):
    return [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One arch's JAX weights and their port carry, a batch, and JAX's
    hidden states, loss and gradient."""
    arch = request.param
    cfg, pcfg = jax_smoke(arch), get_smoke(arch)
    jp = JM.init_params(cfg, jax.random.key(0))
    t, lab = _batch(cfg.vocab)
    h, _ = JM.forward_hidden(jp, cfg, jnp.asarray(t))
    loss, grads = jax.value_and_grad(
        lambda p: JM.lm_loss(p, cfg, jnp.asarray(t), jnp.asarray(lab)))(jp)
    return {"cfg": cfg, "pcfg": pcfg, "jp": jp, "pp": _carry(jp, pcfg), "tokens": t,
            "labels": lab, "h": np.asarray(h, np.float32), "loss": float(loss), "grads": grads}


def test_forward_hidden_and_loss_match_jax(model):
    pcfg, pp = model["pcfg"], model["pp"]
    t, lab = torch.from_numpy(model["tokens"]), torch.from_numpy(model["labels"])
    h, aux = PM.forward_hidden(pp, pcfg, t)
    assert h.dtype == torch.bfloat16 and h.shape == model["h"].shape
    assert float(aux) == 0.0
    assert np.abs(_np(h) - model["h"]).max() <= 4 * _ulp(model["h"])
    loss = PM.lm_loss(pp, pcfg, t, lab)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - model["loss"]) <= 1e-3


def test_gradient_matches_jax_leaf_by_leaf(model):
    pcfg = model["pcfg"]
    t, lab = torch.from_numpy(model["tokens"]), torch.from_numpy(model["labels"])
    loss, grads = value_and_grad(lambda p: PM.lm_loss(p, pcfg, t, lab), model["pp"])
    assert abs(float(loss) - model["loss"]) <= 1e-3
    want = model["grads"]
    got = leaves(grads)
    assert len(got) == len(jax.tree.leaves(want))
    for path, a, b in zip(_paths(want), jax.tree.leaves(want), got):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        assert np.abs(b.numpy() - a).max() <= 8 * _ulp(a), path


def test_checkpointing_changes_no_bit(model, monkeypatch):
    pcfg, pp = model["pcfg"], model["pp"]
    t, lab = torch.from_numpy(model["tokens"]), torch.from_numpy(model["labels"])
    ck_loss, ck = value_and_grad(lambda p: PM.lm_loss(p, pcfg, t, lab), pp)
    monkeypatch.setattr(PM, "_checkpointed", lambda fn, *args: fn(*args))
    loss, plain = value_and_grad(lambda p: PM.lm_loss(p, pcfg, t, lab), pp)
    assert torch.equal(ck_loss, loss)
    for a, b in zip(leaves(ck), leaves(plain)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_train_step_matches_jax(model, microbatches):
    """One step from the state after a JAX step (AdamW count 1, moments
    non-zero), carried across with ``opt_state_from_jax``."""
    cfg = dataclasses.replace(model["cfg"], train_microbatches=microbatches)
    pcfg = dataclasses.replace(model["pcfg"], train_microbatches=microbatches)
    step = jax.jit(jax_make_train_step(cfg, None, JAdamW(lr=LR), total_steps=30))
    t0, l0 = _batch(cfg.vocab, step=0)
    jp, jo, _ = step(model["jp"], jax_adamw_init(model["jp"]), jnp.asarray(t0), jnp.asarray(l0))
    pp = _carry(jp, pcfg)
    po = opt_state_from_jax(jax.tree.map(np.asarray, jo), pcfg, device="cpu")
    assert po["count"].dtype == torch.int32 and int(po["count"]) == 1
    t1, l1 = _batch(cfg.vocab, step=1)
    jp2, jo2, jm = step(jp, jo, jnp.asarray(t1), jnp.asarray(l1))
    pp2, po2, pm = PS.make_train_step(pcfg, AdamWConfig(lr=LR), total_steps=30)(
        pp, po, torch.from_numpy(t1), torch.from_numpy(l1))

    assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-3
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-3)
    assert float(pm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(po2["count"]) == int(jo2["count"]) == 2
    lr = float(jm["lr"])
    for path, m0, mj, mp, vj, vp, pj, ppt in zip(
            _paths(jp), jax.tree.leaves(jo["m"]), jax.tree.leaves(jo2["m"]), leaves(po2["m"]),
            jax.tree.leaves(jo2["v"]), leaves(po2["v"]), jax.tree.leaves(jp2), leaves(pp2)):
        mj, vj, pj = np.asarray(mj), np.asarray(vj), np.asarray(pj)
        g = (mj - 0.9 * np.asarray(m0)) / 0.1          # JAX's gradient of this step
        gtol = 8 * _ulp(g)
        assert np.abs(mp.numpy() - mj).max() <= 0.1 * gtol * 1.01 + 1e-12, path
        assert np.abs(vp.numpy() - vj).max() <= 0.05 * gtol * (2 * np.abs(g).max() + gtol) * 1.01 \
            + 1e-15, path
        f32_ulp = 2.0 ** (math.floor(math.log2(np.abs(pj).max())) - 23)
        assert np.abs(ppt.numpy() - pj).max() <= 2 * lr + 2 * f32_ulp, path


@pytest.mark.parametrize("arch,S_", [("qwen1.5-0.5b", 1024), ("yi-34b", 600), ("granite-34b", 20)])
def test_attention_and_loss_chunking_match_jax(arch, S_):
    """S 1,024: two query chunks of 512; S 600: not a multiple of 512, one
    chunk; S 20: the loss in 5 chunks (8, 7 and 6 do not divide 20)."""
    cfg, pcfg = jax_smoke(arch), get_smoke(arch)
    jp = JM.init_params(cfg, jax.random.key(1))
    pp = _carry(jp, pcfg)
    t, lab = _batch(cfg.vocab, b=1, s=S_, seed=1)
    jl, jg = jax.value_and_grad(
        lambda p: JM.lm_loss(p, cfg, jnp.asarray(t), jnp.asarray(lab)))(jp)
    pl, pg = value_and_grad(
        lambda p: PM.lm_loss(p, pcfg, torch.from_numpy(t), torch.from_numpy(lab)), pp)
    assert abs(float(pl) - float(jl)) <= 1e-3
    for path, a, b in zip(_paths(jg), jax.tree.leaves(jg), leaves(pg)):
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 8 * _ulp(a), path


@pytest.mark.parametrize("S_,q_chunk", [(48, 16), (40, 16), (48, 48)])
def test_train_attention_chunks_match_jax(S_, q_chunk):
    """The chunked attention alone, at a small ``q_chunk``: 3 chunks, the
    one-chunk fallback (40 is not a multiple of 16), and one exact chunk."""
    cfg, pcfg = jax_smoke("yi-34b"), get_smoke("yi-34b")
    jp = JM.init_params(cfg, jax.random.key(2))
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = JM.attention(xj, lp, cfg, jnp.arange(S_), None, q_chunk=q_chunk)
    want = np.asarray(want, np.float32)
    got = PM.train_attention(torch.from_numpy(x).bfloat16(), params_from_jax(
        jax.tree.map(np.asarray, lp), device="cpu"), pcfg, torch.arange(S_), q_chunk=q_chunk)
    assert got.dtype == torch.bfloat16
    assert np.abs(_np(got) - want).max() <= 4 * _ulp(want)


def test_embedding_backward_is_the_scatter_on_the_segment_sum():
    """The gather's backward (``_EmbedGather``) through the float segment
    sum equals the plain scatter-add (``index_add_``, which adds in token
    order on the CPU as the kernel does) bit for bit, and autograd through
    ``F.embedding`` to float32 rounding; Zipf tokens put one row many
    times."""
    rng = np.random.default_rng(0)
    V, d = 512, 24
    tokens, _ = synth_lm_batch(V, 8, 64, seed=0, step=0)
    tokens = torch.from_numpy(tokens)
    counts = np.bincount(tokens.flatten().numpy(), minlength=V)
    assert counts.max() > 0.04 * tokens.numel()       # a hot row
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((8, 64, d)).astype(np.float32))
    before = sk.float_launches
    PM._EmbedGather.apply(table, tokens).backward(g)
    assert sk.float_launches == before                # the plain version on the CPU
    want = torch.zeros(V, d).index_add_(0, tokens.flatten().long(), g.reshape(-1, d))
    assert torch.equal(table.grad, want)
    ref = table.detach().clone().requires_grad_(True)
    torch.nn.functional.embedding(tokens, ref).backward(g)
    torch.testing.assert_close(table.grad, ref.grad, rtol=1e-6, atol=1e-5)


def test_loss_drops_and_follows_jax_for_30_steps():
    """The port of ``tests/test_models_semantics.py::
    test_lm_loss_decreases_with_training``, from JAX's weights, every step's
    loss beside JAX's."""
    cfg, pcfg = jax_smoke("qwen1.5-0.5b"), get_smoke("qwen1.5-0.5b")
    jp = JM.init_params(cfg, jax.random.key(0))
    params = _carry(jp, pcfg)
    opt = adamw_init(params)
    jopt = jax_adamw_init(jp)
    jstep = jax.jit(jax_make_train_step(cfg, None, JAdamW(lr=3e-3, weight_decay=0.0),
                                        total_steps=30))
    step = PS.make_train_step(pcfg, AdamWConfig(lr=3e-3, weight_decay=0.0), total_steps=30)
    losses, jlosses = [], []
    for i in range(30):
        t, lab = _batch(cfg.vocab, b=8, s=64, step=i)
        tj, lj = jax_synth_lm_batch(cfg.vocab, 8, 64, seed=0, step=i)
        jp, jopt, jm = jstep(jp, jopt, jnp.asarray(tj), jnp.asarray(lj))
        params, opt, m = step(params, opt, torch.from_numpy(t), torch.from_numpy(lab))
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert np.abs(np.array(losses) - np.array(jlosses)).max() <= 1e-3


def test_trained_weights_serve_through_prefill_like_forward_hidden():
    """Weights after 5 steps, served by ``launch.serve``'s prefill on the
    flash kernel's plain version: the last position's logits against
    ``forward_hidden``'s (the reference route, on the chunked attention), by
    the bf16 rule against a float32 evaluation of the same weights."""
    cfg = get_smoke("qwen1.5-0.5b")
    params = PM.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    step = PS.make_train_step(cfg, AdamWConfig(lr=3e-3, weight_decay=0.0), total_steps=5)
    for i in range(5):
        t, lab = _batch(cfg.vocab, step=i)
        params, opt, _ = step(params, opt, torch.from_numpy(t), torch.from_numpy(lab))
    prompts = torch.from_numpy(_batch(cfg.vocab, b=2, s=40, step=99)[0]).long()
    served = serve.generate(params, cfg, prompts, 1).prefill_logits
    with torch.no_grad():
        h, _ = PM.forward_hidden(params, cfg, prompts)
        ref = PM.logits_from_hidden(params, cfg, h[:, -1:])[:, 0].float()
        h32, _ = PM.forward_hidden(params, cfg, prompts, dtype=torch.float32)
        f32 = PM.logits_from_hidden(params, cfg, h32[:, -1:])[:, 0]
    r = checks.hold_bf16(served, ref, f32)
    assert r["ok"], r
    assert r["err"] <= 4 * r["ulp"]


def test_refusals():
    cfg = get_smoke("qwen1.5-0.5b")
    pp = PM.init_params(cfg, 0, device="cpu")
    t = torch.zeros((1, 8), dtype=torch.int32)
    for policy in ("dots", "all_dots"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 13"):
            PM.forward_hidden(pp, dataclasses.replace(cfg, remat_policy=policy), t)
    with pytest.raises(ValueError, match="remat_policy"):
        PM.lm_loss(pp, dataclasses.replace(cfg, remat_policy="none"), t, t)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 12"):
            PS.build_step(cfg, shape_by_name("qwen1.5-0.5b", shape), mesh=object())


def test_build_step_specs_follow_the_shapes():
    cfg = get_smoke("qwen1.5-0.5b")
    step, specs, in_sh, out_sh = PS.build_step(cfg, shape_by_name("qwen1.5-0.5b", "train_4k"), None)
    assert specs == {"tokens": ((256, 4096), torch.int32), "labels": ((256, 4096), torch.int32)}
    assert in_sh is None and out_sh is None and callable(step)
    _, specs, _, _ = PS.build_step(cfg, shape_by_name("qwen1.5-0.5b", "decode_32k"))
    assert specs["cache"]["k"] == ((cfg.n_layers, 128, cfg.n_kv_heads, 32768, cfg.d_head),
                                   torch.bfloat16)
    assert specs["token"] == ((128, 1), torch.int32) and specs["pos"] == ((), torch.int32)
    prefill, specs, _, _ = PS.build_step(cfg, shape_by_name("qwen1.5-0.5b", "prefill_32k"))
    assert specs == {"tokens": ((32, 32768), torch.int32)}
    logits, cache = prefill(PM.init_params(cfg, 0, device="cpu"), torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, cfg.vocab) and cache["k"].shape[3] == 4
