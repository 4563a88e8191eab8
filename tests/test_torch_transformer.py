"""The port's transformer serving passes against the JAX model.

The JAX parameters of each ``SMOKE`` config (``qwen1.5-0.5b``; ``yi-34b``,
GQA; ``granite-34b``, MQA with a GELU MLP) are carried across with
``params_from_jax``; the same numpy-drawn prompts go through JAX ``prefill``
and the port's; then 8 decode steps, the port fed the tokens JAX chose.

Both sides compute in bf16, and the results are bf16 numbers (logits are
cast to float32 after a bf16 product). They round at different places: the
port's prefill attention keeps scores in float32 (the flash kernel's plain
version) where the reference rounds them to bf16 first, and matmuls and
fused elementwise ops accumulate in different orders. The tolerance is two
units in the last place of a bf16 number at the compared tensor's largest
magnitude (``_tol``): 1.6e-2 for logits in [1, 2). Observed: at most 1.1 of
those units. Greedy tokens are compared only where JAX's top-1 margin
exceeds twice that tolerance, since a smaller margin can flip by rounding.

The reference's decode attends to the zero-filled cache slots past ``pos``
(it gives them position -1, which passes its causal test); the port masks
them (ROADMAP.md Queue C). So the JAX side decodes with a cache grown by one
slot a step, which holds no unwritten slot and where the two agree.
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
from repro_torch.configs import MoEConfig, get_config, get_smoke
from repro_torch.launch import serve
from repro_torch.models.transformer import model as PM
from repro_torch.models.transformer.convert import params_from_jax

ARCHS = ["qwen1.5-0.5b", "yi-34b", "granite-34b"]
B, P, STEPS = 2, 24, 8


def _tol(x) -> float:
    top = float(np.max(np.abs(x)))
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """One arch's JAX and port runs: prefill, then STEPS teacher-forced decodes."""
    arch = request.param
    cfg = jax_smoke(arch)
    jp = JM.init_params(cfg, jax.random.key(0))
    pcfg = get_smoke(arch)
    pp = PM.cast_params(params_from_jax(jax.tree.map(np.asarray, jp), pcfg, device="cpu"))
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (B, P)).astype(np.int32)

    j_logits, j_cache = JM.prefill(jp, cfg, jnp.asarray(prompts))
    p_cache = PM.init_kv_cache(pcfg, B, P + STEPS, device="cpu")
    p_logits, _ = PM.prefill(pp, pcfg, torch.from_numpy(prompts).long(), cache=p_cache)
    out = {"cfg": pcfg, "params": pp, "prompts": prompts,
           "prefill": (np.asarray(j_logits), _np(p_logits)),
           "cache": ({k: np.asarray(v.astype(jnp.float32)) for k, v in j_cache.items()},
                     {k: _np(v[:, :, :, :P]) for k, v in p_cache.items()}),
           "steps": [], "tokens": []}

    tok = jnp.argmax(j_logits, axis=-1)[:, None].astype(jnp.int32)
    cache = j_cache
    for i in range(STEPS):
        cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, 1), (0, 0))) for k, v in cache.items()}
        j_step, cache = JM.decode_step(jp, cfg, tok, cache, jnp.int32(P + i))
        p_step, p_cache = PM.decode_step(pp, pcfg, torch.from_numpy(np.array(tok)).long(), p_cache,
                                         P + i)
        out["steps"].append((np.asarray(j_step), _np(p_step)))
        out["tokens"].append(np.array(tok[:, 0]))
        tok = jnp.argmax(j_step, axis=-1)[:, None].astype(jnp.int32)
    out["tokens"].append(np.array(tok[:, 0]))
    return out


def test_prefill_logits_and_cache_match_jax(run):
    want, got = run["prefill"]
    assert got.shape == want.shape == (B, run["cfg"].vocab) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= _tol(want)
    for name in ("k", "v"):
        want_c, got_c = run["cache"][0][name], run["cache"][1][name]
        assert got_c.shape == want_c.shape
        assert np.abs(got_c - want_c).max() <= _tol(want_c), name


def test_teacher_forced_decode_matches_jax(run):
    for i, (want, got) in enumerate(run["steps"]):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= _tol(want), f"step {i}"


def test_greedy_tokens_match_where_the_margin_is_clear(run):
    compared = 0
    for want, got in [run["prefill"]] + run["steps"]:
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * _tol(want)
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
        compared += int(clear.sum())
    assert compared > 0


def test_serve_loop_reproduces_the_model_calls(run):
    """``serve.generate`` with the JAX tokens forced gives the same logits as
    the model calls above, and greedy decoding follows its own argmax."""
    cfg, pp = run["cfg"], run["params"]
    prompts = torch.from_numpy(run["prompts"]).long()
    forced = torch.from_numpy(np.stack(run["tokens"][:STEPS], axis=1)).long()
    res = serve.generate(pp, cfg, prompts, STEPS, forced=forced, keep_logits=True)
    np.testing.assert_array_equal(_np(res.prefill_logits), run["prefill"][1])
    for (_, want), got in zip(run["steps"][:STEPS - 1], res.step_logits):
        np.testing.assert_array_equal(_np(got), want)
    greedy = serve.generate(pp, cfg, prompts, 4)
    assert greedy.tokens.shape == (B, 4)
    np.testing.assert_array_equal(greedy.tokens[:, 0].numpy(), run["prefill"][1].argmax(-1))


def test_unwritten_cache_slots_do_not_change_decode():
    """The port masks the slots past ``pos``: a cache with 16 spare slots
    decodes as one that ends at ``pos``."""
    cfg = get_smoke("yi-34b")
    pp = PM.cast_params(PM.init_params(cfg, 3, device="cpu"))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))).long()
    logits, small = PM.prefill(pp, cfg, prompts)
    big = PM.init_kv_cache(cfg, 2, 12 + 17, device="cpu")
    big["k"][:, :, :, :12], big["v"][:, :, :, :12] = small["k"], small["v"]
    small = {k: torch.cat([v, torch.zeros_like(v[:, :, :, :1])], dim=3) for k, v in small.items()}
    tok = logits.argmax(-1, keepdim=True)
    a, _ = PM.decode_step(pp, cfg, tok, small, 12)
    b, _ = PM.decode_step(pp, cfg, tok, big, 12)
    assert np.abs(_np(a) - _np(b)).max() <= _tol(_np(a)) / 2


def test_init_params_has_the_reference_layout_and_is_seeded():
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    for arch in ARCHS:
        want = shapes(JM.init_params(jax_smoke(arch), jax.random.key(0)))
        assert shapes(PM.init_params(get_smoke(arch), 0, device="cpu")) == want
    cfg = get_smoke("qwen1.5-0.5b")
    a, b = PM.init_params(cfg, 5, device="cpu"), PM.init_params(cfg, 5, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert a["layers"]["attn"]["wq"].dtype == torch.float32
    assert float(a["layers"]["attn"]["wq"].std()) == pytest.approx(0.02, rel=0.1)
    assert not torch.equal(a["embed"], PM.init_params(cfg, 6, device="cpu")["embed"])


def test_params_from_jax_checks_keys_and_shapes():
    cfg = get_smoke("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray, JM.init_params(jax_smoke("qwen1.5-0.5b"), jax.random.key(0)))
    params_from_jax(tree, cfg, device="cpu")
    bad = dict(tree, norm_f=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="norm_f"):
        params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({k: v for k, v in tree.items() if k != "embed"}, cfg, device="cpu")


def test_moe_and_sliding_window_are_not_ported_yet():
    base = get_smoke("qwen1.5-0.5b")
    moe = dataclasses.replace(base, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    swa = dataclasses.replace(base, swa_window=8)
    for cfg, item in [(moe, "item 17"), (swa, "item 18")]:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A {item}"):
            PM.init_params(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A {item}"):
            PM.prefill({}, cfg, torch.zeros(1, 4, dtype=torch.long))
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A {item}"):
            PM.init_kv_cache(cfg, 1, 8, device="cpu")
    for arch, item in [("mixtral-8x22b", "items 17 and 18"), ("qwen2-moe-a2.7b", "item 17"),
                       ("schnet", "item 12")]:
        if arch == "schnet":    # ported with item 12's GNN forward paths
            from repro.configs import get_config as jax_config

            assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
            continue
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A {item}"):
            get_config(arch)
