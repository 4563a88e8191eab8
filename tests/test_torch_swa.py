"""Sliding-window attention in the port against the JAX package's, on the
CPU, at ``mixtral-8x22b``'s ``SMOKE`` config (window 32) and at its dense
variant (``dataclasses.replace(SMOKE, moe=None)``, where no capacity drop
can hide an attention fault).

- Training: with S > 2 x window each query chunk attends only to the keys
  its window reaches (the reference's key slicing); held to the reference's
  attention and gradient at 4 bf16 ulps of the largest magnitude, as
  ``test_torch_lm_train`` holds the dense ones.
- The rolling decode cache: T capped at the window, position p at slot p %
  T, a slot that holds no position yet masked. Past the roll at P % w == 0,
  where the reference's prefill placement is right, the port's cache and
  teacher-forced decode steps are held to the reference's at two bf16 ulps
  (``test_torch_transformer._tol``).
- The reference's placement fault (ROADMAP.md Queue C caveat 8): its
  ``launch/serve.py`` puts prefill's last window at slot offset (P - T) % T,
  which its ``dynamic_update_slice`` clamps to 0 when P > w, so slot i holds
  position P - w + i while decode reads slot s as the position p with p % T
  == s. At every P % w the port's decode steps after a prefill of P > w
  tokens equal a prefill over the same tokens within two bf16 ulps, as the
  reference's first step does with the window placed at slot p % T; at P %
  w != 0 the reference's own placement puts it more than four ulps off
  (observed 4.3-5.8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models.transformer import model as JM
from repro_torch import checks
from repro_torch.configs import get_smoke
from repro_torch.configs.registry import shape_by_name
from repro_torch.data import synth_lm_batch
from repro_torch.models.autodiff import value_and_grad
from repro_torch.models.transformer import model as PM, steps as PS
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.tree import leaves

ARCH = "mixtral-8x22b"
W = 32                                                  # SMOKE's window


def _tol(x) -> float:
    return 2 * checks.bf16_ulp(float(np.max(np.abs(x))))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _cfgs(moe: bool):
    cfg, pcfg = jax_smoke(ARCH), get_smoke(ARCH)
    if not moe:
        cfg, pcfg = dataclasses.replace(cfg, moe=None), dataclasses.replace(pcfg, moe=None)
    return cfg, pcfg


@pytest.fixture(scope="module", params=[True, False], ids=["moe", "dense"])
def model(request):
    cfg, pcfg = _cfgs(request.param)
    jp = JM.init_params(cfg, jax.random.key(0))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    return {"cfg": cfg, "pcfg": pcfg, "jp": jp, "pp": pp}


def test_the_config_has_a_window():
    assert get_smoke(ARCH).swa_window == W and get_smoke(ARCH).moe.virtual_split == 2


@pytest.mark.parametrize("S,q_chunk", [(80, 16), (96, 32), (100, 16), (64, 16)])
def test_training_attention_slices_keys_like_jax(S, q_chunk):
    """S 80 and 96 slice the keys (S > 2w, qc + w < S); S 100 is not a
    multiple of 16 (one chunk, no slice); S 64 = 2w, no slice."""
    cfg, pcfg = _cfgs(False)
    jp = JM.init_params(cfg, jax.random.key(2))
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want, _ = JM.attention(jnp.asarray(x).astype(jnp.bfloat16), lp, cfg, jnp.arange(S), None,
                           q_chunk=q_chunk)
    want = np.asarray(want, np.float32)
    got = PM.train_attention(torch.from_numpy(x).bfloat16(), params_from_jax(
        jax.tree.map(np.asarray, lp), device="cpu"), pcfg, torch.arange(S), q_chunk=q_chunk)
    assert np.abs(_np(got) - want).max() <= 2 * _tol(want)
    qc = q_chunk if S % q_chunk == 0 else S              # train_attention's one-chunk fallback
    sliced = [PM._key_window(c, qc, S, W) for c in range(S // qc)]
    if S in (80, 96):
        assert all(s is not None and s.stop - s.start == q_chunk + W for s in sliced)
        assert sliced[0].start == 0 and sliced[-1].stop == S
    else:
        assert all(s is None for s in sliced)


def test_windowed_loss_and_gradient_match_jax(model):
    """``lm_loss`` and its gradient at S = 1,024, where the training
    attention slices its keys (two chunks of 512 queries, each against 544
    keys), leaf by leaf at 8 bf16 ulps as ``test_torch_lm_train`` holds the
    dense gradient."""
    cfg, pcfg, jp, pp = model["cfg"], model["pcfg"], model["jp"], model["pp"]
    t, lab = synth_lm_batch(cfg.vocab, 1, 1024, seed=3, step=0)
    jl, jg = jax.value_and_grad(lambda p: JM.lm_loss(p, cfg, jnp.asarray(t), jnp.asarray(lab)))(jp)
    pl, pg = value_and_grad(lambda p: PM.lm_loss(p, pcfg, torch.from_numpy(t),
                                                 torch.from_numpy(lab)), pp)
    assert PM._key_window(1, 512, 1024, W) == slice(480, 1024)
    assert abs(float(pl) - float(jl)) <= 1e-3
    for a, b in zip(jax.tree.leaves(jg), leaves(pg)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 8 * checks.bf16_ulp(float(np.abs(a).max()))


def test_cache_is_capped_at_the_window_and_unwritten_slots_are_masked():
    cfg = get_smoke(ARCH)
    assert PM.init_kv_cache(cfg, 2, 100, device="cpu")["k"].shape[3] == W
    assert PM.init_kv_cache(cfg, 2, 20, device="cpu")["k"].shape[3] == 20
    _, specs, _, _ = PS.build_step(cfg, shape_by_name(ARCH, "decode_32k"))
    assert specs["cache"]["k"][0] == (cfg.n_layers, 128, cfg.n_kv_heads, W, cfg.d_head)
    # T = 8 after positions 0..3: slots 4-7 hold nothing yet and get pos + 1, which the causal
    # mask excludes (the reference gives them -1, which passes it: caveat 4)
    assert PM.cache_positions(8, 3, 32, "cpu").tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    # past the roll: slot s holds the newest p <= pos with p % 8 == s
    assert PM.cache_positions(8, 21, 32, "cpu").tolist() == [16, 17, 18, 19, 20, 21, 14, 15]
    assert PM.cache_positions(8, 3, None, "cpu").tolist() == list(range(8))


def test_prefill_refuses_a_dense_cache_shorter_than_the_prompt():
    cfg = dataclasses.replace(get_smoke(ARCH), swa_window=None, moe=None)
    params = PM.cast_params(PM.init_params(cfg, 0, device="cpu"))
    with pytest.raises(ValueError, match="cannot hold a prompt of 20"):
        PM.prefill(params, cfg, torch.zeros((1, 20), dtype=torch.long),
                   cache=PM.init_kv_cache(cfg, 1, 12, device="cpu"))


def test_rolling_decode_past_the_roll_matches_jax(model):
    """P = 64 = 2w: the reference's prefill cache (the last window, in
    order) is its serving cache, slot s holding position 32 + s = p with p %
    32 == s, so the reference is right here; 8 teacher-forced steps then
    roll through slots 0-7."""
    cfg, pcfg, jp = model["cfg"], model["pcfg"], model["jp"]
    pp = PM.cast_params(model["pp"])
    P, steps = 64, 8
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, P)).astype(np.int32)
    j_logits, cache = JM.prefill(jp, cfg, jnp.asarray(prompts))
    p_cache = PM.init_kv_cache(pcfg, 2, P + steps, device="cpu")
    p_logits, _ = PM.prefill(pp, pcfg, torch.from_numpy(prompts).long(), cache=p_cache)
    j_logits = np.asarray(j_logits)
    assert cache["k"].shape[3] == p_cache["k"].shape[3] == W
    assert np.abs(_np(p_logits) - j_logits).max() <= _tol(j_logits)
    for k in ("k", "v"):     # projections of the hidden states: 4 ulps, as those are held
        want = np.asarray(cache[k].astype(jnp.float32))
        assert np.abs(_np(p_cache[k]) - want).max() <= 2 * _tol(want)
    tok = jnp.argmax(j_logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(steps):
        j_step, cache = JM.decode_step(jp, cfg, tok, cache, jnp.int32(P + i))
        p_step, p_cache = PM.decode_step(pp, pcfg, torch.from_numpy(np.array(tok)).long(),
                                         p_cache, P + i)
        j_step = np.asarray(j_step)
        assert np.abs(_np(p_step) - j_step).max() <= _tol(j_step), i
        tok = jnp.argmax(j_step, axis=-1)[:, None].astype(jnp.int32)


@pytest.mark.parametrize("P", [33, 40, 50, 63, 64, 95, 96])
def test_decode_after_a_long_prompt_equals_a_full_recompute(P):
    """The dense variant: 4 decode steps after a prefill of P > w tokens,
    each against a prefill over the same P + i + 1 tokens, for P % w in
    {1, 8, 18, 31, 0, 31, 0}; and the reference's first step against its
    own recompute, with its own placement (``launch/serve.py:45-53``) and
    with the window at slot p % T."""
    cfg, pcfg = _cfgs(False)
    jp = JM.init_params(cfg, jax.random.key(0))
    pp = PM.cast_params(params_from_jax(jax.tree.map(np.asarray, jp), pcfg, device="cpu"))
    toks = np.random.default_rng(P).integers(0, cfg.vocab, (2, P + 4)).astype(np.int32)
    t = torch.from_numpy(toks).long()
    cache = PM.init_kv_cache(pcfg, 2, P + 4, device="cpu")
    PM.prefill(pp, pcfg, t[:, :P], cache=cache)
    for i in range(4):
        step, cache = PM.decode_step(pp, pcfg, t[:, P + i:P + i + 1], cache, P + i)
        full, _ = PM.prefill(pp, pcfg, t[:, :P + i + 1])
        full = _np(full)
        assert np.abs(_np(step) - full).max() <= _tol(full), (P, i)

    j_logits, pc = JM.prefill(jp, cfg, jnp.asarray(toks[:, :P]))
    j_full, _ = JM.prefill(jp, cfg, jnp.asarray(toks[:, :P + 1]))
    j_full = np.asarray(j_full)
    errs = {}
    serving = JM.init_kv_cache(cfg, 2, P + 4)
    T, Tp = serving["k"].shape[3], pc["k"].shape[3]
    placed = {"reference's": {k: jax.lax.dynamic_update_slice(serving[k], pc[k],
                                                              (0, 0, 0, (P - Tp) % T, 0))
                              for k in serving},
              # the same window at slot p % T: position P - w + i is at slot i of pc
              "p % T": {k: jnp.roll(pc[k], P % T, axis=3) for k in serving}}
    for name, c in placed.items():
        j_step, _ = JM.decode_step(jp, cfg, jnp.asarray(toks[:, P:P + 1]), c, jnp.int32(P))
        errs[name] = float(np.abs(np.asarray(j_step) - j_full).max())
    assert errs["p % T"] <= _tol(j_full)
    if P % W == 0:
        assert errs["reference's"] <= _tol(j_full)
    else:
        assert errs["reference's"] > 2 * _tol(j_full), errs
