"""The port's DIN against the JAX package's.

The reference's parameters (``repro.models.recsys.din.init_params``) are
carried across with ``params_from_jax``, and the same ``synth_batch`` arrays
(which the port draws equal to the reference's) go through the reference's
steps and the port's, on the CPU, where the embedding-bag kernel's plain
version runs.

Tolerances, all float32 (both sides compute in float32; they differ in the
order of their sums and products):

- logits and probabilities: rtol 1e-5, atol 1e-7 (observed about 3e-9 on
  logits of magnitude 0.02-0.2);
- retrieval scores: the same; top-k allowing for ties (``check_topk`` with
  tol 1e-6);
- three AdamW train steps at SMOKE: loss and grad norm rtol 1e-5; parameters
  atol 2e-6 (observed 6e-7: the attention MLP's last bias has a true
  gradient of 0, since the softmax does not see a shift, so its gradient is
  rounding noise, which Adam scales up to steps of lr x noise / (|noise| +
  eps)); moments within 1e-4 of each leaf's largest entry (observed 2e-5),
  but for that bias, whose moments are rounding noise on both sides (below
  1e-6 of the largest moment of the tree).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config, get_smoke as jax_smoke
from repro.configs.base import ShapeSpec as JShape
from repro.models.recsys import din as JD, steps as JS
from repro.optim import AdamWConfig as JAdamW, adamw_init as jax_adamw_init
from repro.optim.schedules import cosine_warmup as jax_cosine_warmup
from repro_torch.checks import check_topk, hold, tolerance
from repro_torch.configs import ShapeSpec, get_config, get_smoke
from repro_torch.kernels.embedding_bag import ops as bag
from repro_torch.models.recsys import din as PD, steps as PS
from repro_torch.models.recsys.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, cosine_warmup
from repro_torch.tree import leaves

SHAPES = [("train", {"batch": 64}), ("serve", {"batch": 64}),
          ("retrieval", {"batch": 1, "n_candidates": 5000})]


def _np(t):
    return t.detach().cpu().numpy()


def _carry(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def smoke():
    jp = JD.init_params(jax_smoke("din"), jax.random.key(0))
    return jp, _carry(jp, get_smoke("din"))


@pytest.fixture(scope="module")
def full():
    jp = JD.init_params(jax_config("din"), jax.random.key(0))
    return jp, _carry(jp, get_config("din"))


@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
@pytest.mark.parametrize("kind,params", SHAPES, ids=[s[0] for s in SHAPES])
def test_synth_batch_equals_the_reference(arch_cfg, kind, params):
    jcfg, cfg = ((jax_smoke, get_smoke) if arch_cfg == "smoke" else (jax_config, get_config))
    want = JS.synth_batch(jcfg("din"), JShape("x", kind, params), seed=11)
    got = PS.synth_batch(cfg("din"), ShapeSpec("x", kind, params), seed=11)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    specs = PS.batch_specs(cfg("din"), ShapeSpec("x", kind, params))
    assert list(specs) == list(want)
    assert all(specs[k] == (want[k].shape, torch.int32) for k in want)


def test_retrieval_pads_candidates_to_a_multiple_of_512():
    spec = PS.batch_specs(get_config("din"), ShapeSpec("r", "retrieval",
                                                       {"batch": 1, "n_candidates": 1_000_000}))
    assert spec["cand_items"][0] == (1_000_448,)


def test_params_from_jax_checks_keys_shapes_and_list_leaves(smoke):
    jp, pp = smoke
    cfg = get_smoke("din")
    tree = jax.tree.map(np.asarray, jp)
    assert isinstance(pp["attn"], list) and len(pp["attn"]) == len(cfg.attn_mlp) + 1
    for a, b in zip(jax.tree.leaves(tree), leaves(pp)):
        np.testing.assert_array_equal(a, _np(b))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({k: v for k, v in tree.items() if k != "mlp"}, cfg, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(dict(tree, attn=tree["attn"][:-1]), cfg, device="cpu")
    bad = dict(tree, mlp=[dict(tree["mlp"][0], w=np.zeros((3, 3), np.float32))] + tree["mlp"][1:])
    with pytest.raises(ValueError, match=r"\['mlp'\]\[0\]\['w'\]"):
        params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="item_emb"):
        params_from_jax(dict(tree, item_emb=np.zeros((5, 8), np.float32)), cfg, device="cpu")


def test_init_params_has_the_reference_layout_and_is_seeded():
    for jcfg, cfg in [(jax_smoke("din"), get_smoke("din")), (jax_config("din"), get_config("din"))]:
        want = [tuple(x.shape) for x in jax.tree.leaves(jax.eval_shape(
            lambda k: JD.init_params(jcfg, k), jax.random.key(0)))]
        assert leaves(PD.param_spec(cfg)) == want
    cfg = get_smoke("din")
    a, b = PD.init_params(cfg, 5, device="cpu"), PD.init_params(cfg, 5, device="cpu")
    assert [tuple(t.shape) for t in leaves(a)] == leaves(PD.param_spec(cfg))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["item_emb"], PD.init_params(cfg, 6, device="cpu")["item_emb"])
    assert float(a["item_emb"].std()) == pytest.approx(0.01, rel=0.1)
    assert float(a["attn"][0]["w"].std()) == pytest.approx(1 / np.sqrt(8 * cfg.embed_dim),
                                                           rel=0.1)
    assert not any(layer["b"].any() for layer in a["mlp"])


# ------------------------------ serving ----------------------------------- #

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_serve_matches_the_reference(which, smoke, full):
    jp, pp = smoke if which == "smoke" else full
    jcfg, cfg = (jax_smoke("din"), get_smoke("din")) if which == "smoke" else \
        (jax_config("din"), get_config("din"))
    batch = JS.synth_batch(jcfg, JShape("s", "serve", {"batch": 64}), seed=99)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_lg = np.asarray(JD.logits(jp, jcfg, jb))
    want_p = np.asarray(JS.make_serve_step(jcfg)(jp, jb))
    with torch.no_grad():
        got_lg = _np(PD.logits(pp, cfg, PS.batch_to(batch, "cpu")))
    got_p = _np(PS.make_serve_step(cfg)(pp, PS.batch_to(batch, "cpu")))
    assert got_lg.shape == (64,) and np.isfinite(got_lg).all()
    np.testing.assert_allclose(got_lg, want_lg, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-7)


def test_a_history_of_padding_only_pools_uniformly(smoke):
    """The finite -1e30 fill: a user whose history is all padding gets uniform
    weights over zero embeddings (a zero user vector), not NaN."""
    jp, pp = smoke
    jcfg, cfg = jax_smoke("din"), get_smoke("din")
    batch = JS.synth_batch(jcfg, JShape("s", "serve", {"batch": 8}), seed=1)
    batch["hist_items"][:3] = -1
    args = [batch[k] for k in ("hist_items", "hist_cates", "target_item", "target_cate")]
    ju, jt = JD.user_vector(jp, jcfg, *map(jnp.asarray, args))
    pu, pt = PD.user_vector(pp, cfg, *(torch.from_numpy(a) for a in args))
    assert torch.isfinite(pu).all() and not pu[:3].any()
    np.testing.assert_allclose(_np(pu), np.asarray(ju), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(_np(pt), np.asarray(jt))


def test_logits_call_the_bag_once_and_launch_nothing_on_the_cpu(smoke, monkeypatch):
    """One call of the kernel's wrapper a forward (the reference's two bags,
    sum and mean, come from one), and on the CPU no launch."""
    _, pp = smoke
    cfg = get_smoke("din")
    calls = []
    wrapped = bag.embedding_bag_sum
    monkeypatch.setattr(bag, "embedding_bag_sum",
                        lambda t, i: calls.append(i.shape) or wrapped(t, i))
    before = bag.launches
    batch = PS.batch_to(PS.synth_batch(cfg, ShapeSpec("t", "train", {"batch": 32}), seed=2), "cpu")
    with torch.no_grad():
        PD.logits(pp, cfg, batch)
    PS.make_train_step(cfg)(pp, adamw_init(pp), batch)
    PS.make_retrieval_step(cfg, 10)(pp, PS.batch_to(PS.synth_batch(
        cfg, ShapeSpec("r", "retrieval", {"batch": 1, "n_candidates": 600}), seed=3), "cpu"))
    assert calls == [(32, 16), (32, 16)]
    assert bag.launches == before == 0


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_retrieval_matches_the_reference_allowing_for_ties(which, smoke, full):
    jp, pp = smoke if which == "smoke" else full
    jcfg, cfg = (jax_smoke("din"), get_smoke("din")) if which == "smoke" else \
        (jax_config("din"), get_config("din"))
    batch = JS.synth_batch(jcfg, JShape("r", "retrieval", {"batch": 1, "n_candidates": 4096}),
                           seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(JD.retrieval_scores(jp, jcfg, jb))
    jvals, jidx = JS.make_retrieval_step(jcfg)(jp, jb)
    with torch.no_grad():
        got = _np(PD.retrieval_scores(pp, cfg, PS.batch_to(batch, "cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    vals, idx = PS.make_retrieval_step(cfg)(pp, PS.batch_to(batch, "cpu"))
    assert vals.shape == idx.shape == (100,)
    res = check_topk(vals, idx, torch.tensor(want), 1e-6)
    assert res["ok"], res
    assert res["sure"] > 0
    # the reference's own top-k passes the same test, and its values are the port's
    assert check_topk(torch.tensor(np.asarray(jvals)), torch.tensor(np.asarray(jidx)),
                      torch.from_numpy(got), 1e-6)["ok"]
    if which == "smoke":       # 1,000 items and 50 categories: many exact ties
        assert len(np.unique(want)) < len(want)


def test_check_topk_catches_wrong_answers():
    scores = torch.tensor([5.0, 4.0, 4.0, 3.0, 1.0])
    assert check_topk(torch.tensor([5.0, 4.0]), torch.tensor([0, 2]), scores, 1e-6)["ok"]
    assert check_topk(torch.tensor([5.0, 4.0]), torch.tensor([0, 1]), scores, 1e-6)["ok"]
    assert not check_topk(torch.tensor([5.0, 4.0]), torch.tensor([0, 3]), scores, 1e-6)["ok"]
    assert not check_topk(torch.tensor([4.0, 4.0]), torch.tensor([1, 2]), scores, 1e-6)["ok"]
    assert not check_topk(torch.tensor([5.0, 5.0]), torch.tensor([0, 0]), scores, 1e-6)["ok"]


def test_hold_uses_twice_the_cpu_noise_floored_at_four_ulps():
    f64 = torch.tensor([1.0, -3.0], dtype=torch.float64)     # largest magnitude in [2, 4)
    ulp = 2.0 ** -22
    cpu = (f64 + torch.tensor([0.0, 10 * ulp], dtype=torch.float64)).float()
    assert tolerance(cpu, f64) == (20 * ulp, ulp)
    assert tolerance(f64.float(), f64) == (4 * ulp, ulp)      # the floor
    assert hold(cpu.double() + 5 * ulp, cpu, f64)["ok"]      # 5 from the CPU, 15 from f64
    r = hold(cpu.double() + 21 * ulp, cpu, f64)               # 21 > 20 from the CPU
    assert not r["ok"] and r["err"] == 21 * ulp and r["noise"] == 10 * ulp
    r = hold(cpu.double() + 15 * ulp, cpu, f64)               # 25 > 20 from float64
    assert not r["ok"] and r["err"] == 15 * ulp and r["err64"] == 25 * ulp
    # a list (a parameter tree's leaves) is held as one quantity
    assert hold([cpu, cpu], [cpu, cpu], [f64, f64])["ok"]
    assert not hold([cpu, cpu + 1], [cpu, cpu], [f64, f64])["ok"]


# ------------------------------ training ---------------------------------- #

def test_three_train_steps_match_the_reference(smoke):
    jp, pp = smoke
    jcfg, cfg = jax_smoke("din"), get_smoke("din")
    opt = dict(lr=1e-3, weight_decay=0.01)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamW(**opt)))
    pstep = PS.make_train_step(cfg, AdamWConfig(**opt))
    jo, po = jax_adamw_init(jp), adamw_init(pp)
    for i in range(3):
        batch = JS.synth_batch(jcfg, JShape("t", "train", {"batch": 64}), seed=i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        pp, po, pm = pstep(pp, po, PS.batch_to(batch, "cpu"))
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert pm["lr"] == pytest.approx(float(jm["lr"]))
    assert int(po["count"]) == int(jo["count"]) == 3
    for a, b in zip(jax.tree.leaves(jp), leaves(pp)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=2e-6)
    noise_leaf = 4      # attn[-1]["b"], in leaves order: attn first, its layers' b before w
    assert leaves(po["m"])[noise_leaf].shape == (1,) and len(pp["attn"]) == 3
    for name in ("m", "v"):
        want, got = [np.asarray(a) for a in jax.tree.leaves(jo[name])], \
            [_np(b) for b in leaves(po[name])]
        top = max(np.abs(a).max() for a in want)
        for i, (a, b) in enumerate(zip(want, got)):
            if i == noise_leaf:      # a moment of rounding noise on both sides
                assert max(np.abs(a).max(), np.abs(b).max()) <= 1e-6 * top
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max())


def test_the_loss_is_the_reference_stable_form():
    lg = torch.tensor([-80.0, -3.0, -1e-3, 0.0, 2.5, 90.0])
    y = torch.tensor([1, 0, 1, 0, 1, 0], dtype=torch.int32)
    want = float(torch.nn.functional.binary_cross_entropy_with_logits(lg, y.float()))
    assert float(PS.bce_with_logits(lg, y)) == pytest.approx(want, rel=1e-6)


def test_cosine_warmup_matches_the_reference():
    for step in (0, 3, 9, 10, 55, 99, 150):
        got = float(cosine_warmup(step, warmup=10, total=100))
        want = float(jax_cosine_warmup(jnp.int32(step), warmup=10, total=100))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_recsys_config_is_a_copy():
    for jcfg, cfg in [(jax_config("din"), get_config("din")), (jax_smoke("din"), get_smoke("din"))]:
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
