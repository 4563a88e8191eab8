"""MoE in the port (``repro_torch.models.transformer.model.moe_block`` and
the blocks, passes and train step that carry it) against the JAX package's,
on the CPU, at the two MoE ``SMOKE`` configs: ``qwen2-moe-a2.7b`` (8 experts
padded to 10, top 4, 2 shared experts, QKV bias) and ``mixtral-8x22b`` (4
experts top 2, each split into 2 virtual halves, a window of 32).

The reference's weights are carried across with ``convert.params_from_jax``
and inputs are drawn with numpy from a seed, the same arrays on both sides.
The reference dispatches and combines through one-hot einsums; the port
gathers token rows into slots and sums each token's products. What must
agree, and how closely:

- the routing (the top-k expert indices, each selection's slot in its
  expert, and which selections capacity keeps) and the dispatch buffer: bit
  for bit. The router is float32 on both sides and the buffer holds copies
  of the input rows;
- the block's output: two bf16 units in the last place (ulps) of its
  largest magnitude (``test_torch_transformer._tol``). The expert products
  are bf16 matmuls whose float32 sums run in different orders, and the
  combine rounds once after a float32 sum, as the reference's bf16 einsum
  does (observed at most 0.75 ulp);
- the aux loss: float32 rounding (rtol 1e-6; a mean of router
  probabilities summed in another order);
- layers, hidden states and logits: 4 ulps, as ``test_torch_lm_train``
  holds the dense ones; the loss 1e-3 (same reasons);
- a train step: loss, grad norm and the updated parameters by the bf16 rule
  (``checks.hold_bf16``): the port no farther from a float32 evaluation of
  the same weights (the port's ``dtype=torch.float32`` route) than the
  reference is, plus one bf16 ulp.

The prefill and decode passes are held as ``test_torch_transformer`` holds
the dense ones: the JAX cache grows by one slot a step, so it never holds a
slot past ``pos`` (ROADMAP.md Queue C caveat 4); Mixtral's prompt and steps
stay inside its window here (``test_torch_swa.py`` takes it past the roll).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models.transformer import model as JM
from repro.models.transformer.steps import make_train_step as jax_make_train_step
from repro.optim import AdamWConfig as JAdamW, adamw_init as jax_adamw_init
from repro_torch import checks
from repro_torch.configs import get_smoke
from repro_torch.data import synth_lm_batch
from repro_torch.kernels.segment_sum import ops as sk
from repro_torch.launch import serve, train
from repro_torch.models.autodiff import value_and_grad
from repro_torch.models.transformer import model as PM, steps as PS
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_warmup
from repro_torch.tree import leaves

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]
B, S = 2, 48


def _tol(x) -> float:
    """Two bf16 ulps of x's largest magnitude."""
    return 2 * checks.bf16_ulp(float(np.max(np.abs(x))))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _cfgs(arch, capacity_factor=None):
    cfg, pcfg = jax_smoke(arch), get_smoke(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=capacity_factor))
    return cfg, pcfg


def _carry(tree, cfg=None):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _jax_dispatch(x, p, cfg):
    """The reference ``moe_block``'s routing and dispatch buffer
    (``src/repro/models/transformer/model.py:300-338``, line for line):
    ``gate_i`` (B, S, K), ``pos_sel`` and ``keep`` (B, S*K), ``buf`` (B,
    E_eff, C, d)."""
    moe = cfg.moe
    B_, S_, d = x.shape
    E, K = moe.e_pad, moe.top_k
    C = max(int(math.ceil(S_ * K / moe.n_experts * moe.capacity_factor)), 1)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"].astype(jnp.float32))
    if E > moe.n_experts:
        logits = jnp.where(jnp.arange(E) >= moe.n_experts, -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_i = jax.lax.top_k(probs, K)
    sel = jax.nn.one_hot(gate_i.reshape(B_, S_ * K), E, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(sel, axis=1) - sel
    pos_sel = jnp.take_along_axis(pos_in_e, gate_i.reshape(B_, S_ * K, 1), axis=2)[..., 0]
    keep = pos_sel < C
    oh_e = jax.nn.one_hot(gate_i, E, dtype=x.dtype)
    if moe.virtual_split > 1:
        oh_e = jnp.repeat(oh_e, moe.virtual_split, axis=-1)
    oh_c = jax.nn.one_hot(jnp.where(keep, pos_sel, C).reshape(B_, S_, K), C, dtype=x.dtype)
    dispatch = jnp.einsum("bske,bskc->bsec", oh_e, oh_c)
    buf = jnp.einsum("bsec,bsd->becd", dispatch, x)
    return (np.asarray(gate_i), np.asarray(pos_sel), np.asarray(keep),
            np.asarray(buf.astype(jnp.float32)), C)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One arch's JAX weights and their carry."""
    cfg, pcfg = _cfgs(request.param)
    jp = JM.init_params(cfg, jax.random.key(0))
    return {"arch": request.param, "cfg": cfg, "pcfg": pcfg, "jp": jp, "pp": _carry(jp, pcfg)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_block_routes_dispatches_and_combines_like_jax(arch, capacity_factor):
    """The reference's capacity factor (1.25), and 0.5, which drops
    selections: routing and the dispatch buffer bit-equal, the output within
    two bf16 ulps, aux within float32 rounding."""
    cfg, pcfg = _cfgs(arch, capacity_factor)
    jp = JM.init_params(cfg, jax.random.key(0))
    lp = _layer0(jp["layers"]["moe"])
    plp = _carry(lp)
    x = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xp = torch.from_numpy(x).bfloat16()
    gate_i, pos_sel, keep, buf, C = _jax_dispatch(xj, lp, cfg)

    moe = pcfg.moe
    assert PM.moe_capacity(S, moe) == C
    _, _, p_gate_i, p_pos = PM.moe_route(xp, plp["router"], moe)
    np.testing.assert_array_equal(p_gate_i.numpy(), gate_i)
    np.testing.assert_array_equal(p_pos.reshape(B, -1).numpy(), pos_sel)
    p_buf, _, p_keep = PM.moe_dispatch(xp, p_gate_i, p_pos, moe, C)
    np.testing.assert_array_equal(p_keep.reshape(B, -1).numpy(), keep)
    if capacity_factor is not None:
        assert (~keep).sum() > 0                         # selections were dropped
    er = moe.n_experts * moe.virtual_split
    assert np.abs(buf[:, er:]).max(initial=0.0) == 0.0   # the pad experts' slots stay empty
    np.testing.assert_array_equal(_np(p_buf.view(er, B, C, -1).transpose(0, 1)), buf[:, :er])

    out, aux = JM.moe_block(xj, lp, cfg, None)
    p_out, p_aux = PM.moe_block(xp, plp, pcfg)
    out = np.asarray(out, np.float32)
    assert p_out.dtype == torch.bfloat16
    assert np.abs(_np(p_out) - out).max() <= _tol(out)
    assert float(p_aux) == pytest.approx(float(aux), rel=1e-6)


def test_moe_routes_record_each_call():
    cfg = get_smoke("mixtral-8x22b")
    params = PM.cast_params(PM.init_params(cfg, 0, device="cpu"))
    trace = []
    PM.prefill(params, cfg, torch.zeros((1, 20), dtype=torch.long), routes=trace)
    assert len(trace) == cfg.n_layers
    assert trace[0]["gate_i"].shape == (1, 20, 2) and trace[0]["keep"].dtype == torch.bool
    assert trace[0]["C"] == PM.moe_capacity(20, cfg.moe)
    # generate records n_layers calls a pass and forces them back in the same order
    prompts = serve.make_prompts(cfg, 1, 20, torch.device("cpu"))
    run, again = [], []
    first = serve.generate(params, cfg, prompts, 3, keep_logits=True, routes=run)
    second = serve.generate(params, cfg, prompts, 3, keep_logits=True, routes=again,
                            forced_routes=run)
    assert len(run) == 3 * cfg.n_layers and torch.equal(first.tokens, second.tokens)
    assert all(torch.equal(a["gate_i"], b["gate_i"]) for a, b in zip(run, again))


def test_forced_routes_reproduce_a_run_and_move_another():
    """``forced``: a run forced to its own routes' experts gives its own
    bits; a run of other weights forced to them takes those experts, its
    gates its own probabilities there."""
    cfg = get_smoke("qwen2-moe-a2.7b")
    t = torch.from_numpy(synth_lm_batch(cfg.vocab, 2, 24, seed=0, step=0)[0]).long()
    a, b = (PM.cast_params(PM.init_params(cfg, s, device="cpu")) for s in (0, 1))
    trace, again_trace, moved = [], [], []
    want, _ = PM.prefill(a, cfg, t, routes=trace)
    again, _ = PM.prefill(a, cfg, t, routes=again_trace, forced=trace)
    assert torch.equal(again, want) and len(again_trace) == len(trace)
    PM.prefill(b, cfg, t, routes=moved, forced=trace)
    for r, m in zip(trace, moved):
        assert torch.equal(m["gate_i"], r["gate_i"])
        gv = m["probs"].gather(-1, r["gate_i"])
        torch.testing.assert_close(m["gate_v"], gv / gv.sum(-1, keepdim=True), rtol=0, atol=0)
    assert any(not torch.equal(torch.topk(m["probs"], 4).indices, r["gate_i"])
               for r, m in zip(trace, moved))


def test_dispatch_backward_is_the_scatter_on_the_segment_sum():
    """The dispatch gather's backward adds each token's slot rows on the float
    segment sum (its plain version on the CPU): bit-equal to autograd through
    plain indexing, which adds in the same order on the CPU, with dropped
    selections and a virtual split."""
    cfg = dataclasses.replace(get_smoke("mixtral-8x22b"), moe=dataclasses.replace(
        get_smoke("mixtral-8x22b").moe, capacity_factor=0.5))
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((2, 40, cfg.d_model)).astype(np.float32))
    router = torch.from_numpy(r.standard_normal((cfg.d_model, cfg.moe.e_pad)).astype(np.float32))
    _, _, gate_i, pos = PM.moe_route(x, router, cfg.moe)
    C = PM.moe_capacity(40, cfg.moe)
    g = torch.from_numpy(r.standard_normal((cfg.moe.e_eff * 2 * C, cfg.d_model))
                         .astype(np.float32))
    a = x.clone().requires_grad_(True)
    before = sk.float_launches
    buf, slots, keep = PM.moe_dispatch(a, gate_i, pos, cfg.moe, C)
    assert not keep.all()
    buf.reshape(-1, cfg.d_model).backward(g[:buf.numel() // cfg.d_model])
    assert sk.float_launches == before                   # the plain version on the CPU
    b = x.clone().requires_grad_(True)
    rows = buf.numel() // cfg.d_model
    src = torch.arange(2 * 40).repeat_interleave(cfg.moe.top_k * cfg.moe.virtual_split)
    plain = torch.zeros(rows + 1, cfg.d_model).index_put(
        (slots,), b.reshape(-1, cfg.d_model)[src], accumulate=False)
    plain[:rows].backward(g[:rows])
    assert torch.equal(a.grad, b.grad)


def test_layer_fn_matches_jax(model):
    cfg, pcfg = model["cfg"], model["pcfg"]
    lp = _layer0(model["jp"]["layers"])
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want, _, aux = JM.layer_fn(jnp.asarray(x).astype(jnp.bfloat16), lp, cfg, jnp.arange(S), None)
    got, _, p_aux = PM.layer_fn(torch.from_numpy(x).bfloat16(), PM.cast_params(_carry(lp)), pcfg,
                                torch.arange(S))
    want = np.asarray(want, np.float32)
    assert np.abs(_np(got) - want).max() <= 2 * _tol(want)
    assert float(p_aux) == pytest.approx(float(aux), rel=1e-6)
    train_x, train_aux = PM.train_layer(torch.from_numpy(x).bfloat16(), _carry(lp), pcfg,
                                        torch.arange(S))
    assert np.abs(_np(train_x) - want).max() <= 2 * _tol(want)
    assert float(train_aux) == pytest.approx(float(aux), rel=1e-6)


def test_forward_hidden_and_loss_with_aux_match_jax(model):
    cfg, pcfg, jp, pp = model["cfg"], model["pcfg"], model["jp"], model["pp"]
    t, lab = synth_lm_batch(cfg.vocab, B, S, seed=0, step=0)
    h, aux = JM.forward_hidden(jp, cfg, jnp.asarray(t))
    loss = JM.lm_loss(jp, cfg, jnp.asarray(t), jnp.asarray(lab))
    ph, p_aux = PM.forward_hidden(pp, pcfg, torch.from_numpy(t))
    h = np.asarray(h, np.float32)
    assert ph.dtype == torch.bfloat16
    assert np.abs(_np(ph) - h).max() <= 2 * _tol(h)
    assert float(aux) > 0 and float(p_aux) == pytest.approx(float(aux), rel=1e-5)
    p_loss = PM.lm_loss(pp, pcfg, torch.from_numpy(t), torch.from_numpy(lab))
    assert abs(float(p_loss) - float(loss)) <= 1e-3
    head = pp["embed"] if pcfg.tie_embeddings else pp["lm_head"]
    ce = float(PM._chunk_loss(ph, torch.from_numpy(lab), head)) / (B * S)
    assert float(p_loss) == pytest.approx(ce + 0.01 * float(p_aux), abs=1e-5)


def test_prefill_and_teacher_forced_decode_match_jax(model):
    cfg, pcfg, jp = model["cfg"], model["pcfg"], model["jp"]
    pp = PM.cast_params(model["pp"])
    P, steps = 24, 8                                     # P + steps <= Mixtral's window of 32
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    j_logits, j_cache = JM.prefill(jp, cfg, jnp.asarray(prompts))
    p_cache = PM.init_kv_cache(pcfg, B, P + steps, device="cpu")
    p_logits, _ = PM.prefill(pp, pcfg, torch.from_numpy(prompts).long(), cache=p_cache)
    j_logits = np.asarray(j_logits)
    assert np.abs(_np(p_logits) - j_logits).max() <= _tol(j_logits)
    for k in ("k", "v"):
        want = np.asarray(j_cache[k].astype(jnp.float32))
        assert np.abs(_np(p_cache[k][:, :, :, :P]) - want).max() <= _tol(want)
    tok = jnp.argmax(j_logits, axis=-1)[:, None].astype(jnp.int32)
    cache = j_cache
    for i in range(steps):
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, 1), (0, 0))) for k, v in cache.items()}
        j_step, cache = JM.decode_step(jp, cfg, tok, cache, jnp.int32(P + i))
        p_step, p_cache = PM.decode_step(pp, pcfg, torch.from_numpy(np.array(tok)).long(),
                                         p_cache, P + i)
        j_step = np.asarray(j_step)
        assert np.abs(_np(p_step) - j_step).max() <= _tol(j_step), i
        tok = jnp.argmax(j_step, axis=-1)[:, None].astype(jnp.int32)


def test_train_step_holds_to_jax_by_the_bf16_rule(model):
    """One AdamW step from the initial weights: the port's loss, grad norm
    and updated parameters no farther from a float32 evaluation of the step
    (the port at ``dtype=torch.float32``) than JAX's are, plus one bf16
    ulp; the step's loss includes 0.01 x aux."""
    cfg, pcfg, jp, pp = model["cfg"], model["pcfg"], model["jp"], model["pp"]
    t, lab = synth_lm_batch(cfg.vocab, B, S, seed=0, step=0)
    jstep = jax.jit(jax_make_train_step(cfg, None, JAdamW(lr=3e-3), total_steps=10))
    jnew, _, jm = jstep(jp, jax_adamw_init(jp), jnp.asarray(t), jnp.asarray(lab))
    tt, ll = torch.from_numpy(t), torch.from_numpy(lab)
    new, opt, m = PS.make_train_step(pcfg, AdamWConfig(lr=3e-3), total_steps=10)(
        pp, adamw_init(pp), tt, ll)
    assert int(opt["count"]) == 1
    loss32, g32 = value_and_grad(lambda p: PM.lm_loss(p, pcfg, tt, ll, dtype=torch.float32), pp)
    opt32 = adamw_init(pp)
    new32, _, m32 = adamw_update(pp, g32, opt32, AdamWConfig(lr=3e-3),
                                 cosine_warmup(opt32["count"], warmup=100, total=10))
    ref = [torch.tensor(float(jm["loss"])), torch.tensor(float(jm["grad_norm"]))]
    for name, got, want, exact in [("loss", m["loss"], ref[0], loss32),
                                   ("grad norm", m["grad_norm"], ref[1], m32["grad_norm"])]:
        r = checks.hold_bf16(got, want, exact)
        assert r["ok"], (name, r)
    jleaves = [torch.from_numpy(np.asarray(a)) for a in jax.tree.leaves(jnew)]
    r = checks.hold_bf16(leaves(new), jleaves, leaves(new32))
    assert r["ok"], r


def test_train_launcher_takes_both_moe_ids(tmp_path):
    for arch in ARCHS:
        args = train.parse_args(["--arch", arch, "--smoke", "--device", "cpu"])
        assert args.cfg.moe is not None
    train.main(["--arch", "mixtral-8x22b", "--smoke", "--steps", "10", "--batch", "2", "--seq",
                "80", "--ckpt-dir", str(tmp_path), "--device", "cpu"])


def test_make_params_draws_a_large_model_where_it_lives(monkeypatch):
    """Under the host limit the weights are the CPU draw, cast; over it (the
    limit lowered to 0 here) ``init_params(on_device=True)``'s bf16 draw,
    the router and the norms float32."""
    cfg = get_smoke("qwen2-moe-a2.7b")
    cpu = torch.device("cpu")
    small = serve.make_params(cfg, 0, cpu)
    want = PM.cast_params(PM.init_params(cfg, 0, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(leaves(small), leaves(want)))
    monkeypatch.setattr(serve, "HOST_DRAW_BYTES", 0)
    large = serve.make_params(cfg, 0, cpu)
    drawn = PM.init_params(cfg, 0, dtype=torch.bfloat16, device=cpu, on_device=True)
    pairs = list(zip(leaves(large), leaves(drawn)))
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in pairs)
    assert large["layers"]["moe"]["router"].dtype == torch.float32
    assert large["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert PM.param_numel(cfg) == sum(t.numel() for t in leaves(small))


def test_param_spec_has_the_reference_moe_layout():
    for arch in ARCHS:
        cfg = jax_smoke(arch)
        want = jax.eval_shape(lambda k: JM.init_params(cfg, k), jax.random.key(0))
        spec = PM.param_spec(get_smoke(arch))
        assert "mlp" not in spec["layers"]
        assert [tuple(s[0]) for s in leaves(spec)] == [tuple(a.shape)
                                                      for a in jax.tree.leaves(want)]
        p = PM.init_params(get_smoke(arch), 0, device="cpu")
        assert [tuple(a.shape) for a in leaves(p)] == [tuple(a.shape)
                                                       for a in jax.tree.leaves(want)]
        cast = PM.cast_params(p)
        assert cast["layers"]["moe"]["router"].dtype == torch.float32
        assert cast["layers"]["moe"]["w_up"].dtype == torch.bfloat16
