"""The port's accounting of work: kernel-build telemetry
(``core.jit_telemetry``), each kernel's cost function and its booking
(``kernels/cost.py``), ``launch.step_cost`` against the reference's
``launch.jaxpr_cost``, the ``"dots"``/``"all_dots"`` remat policies, and the
dry-run's count of every cell on ``meta``.

The reference's side runs in one subprocess (``JAX_PLATFORMS=cpu``; its
dry-run module sets ``XLA_FLAGS`` on import, which must not reach this
process): its ``dryrun.build_cell`` on a one-device debug mesh and
``jaxpr_cost.step_cost`` at full size, small functions per op kind, and the
remat policies at the smoke width. FLOPs are held exactly where both sides
run the same products; where the port books a kernel in place of the
reference's XLA products, the difference is held against the count computed
from the shapes here.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.step_cost import StepCounter, step_cost

ROOT = pathlib.Path(__file__).resolve().parents[1]

FULL = [("din", "serve_bulk"), ("din", "train_batch"), ("graphcast", "full_graph_sm"),
        ("schnet", "molecule"), ("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "prefill_32k")]

_REFERENCE = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp
from repro.launch import dryrun, jaxpr_cost
from repro.launch.mesh import make_debug_mesh
from repro.configs.registry import get_smoke
from repro.models.transformer import model as M

out = {"full": {}, "kinds": {}, "remat": {}}
for arch, shape in json.loads(sys.argv[1]):
    step, args, _, _ = dryrun.build_cell(arch, shape, make_debug_mesh())
    out["full"][f"{arch}/{shape}"] = [float(v) for v in jaxpr_cost.step_cost(step, *args)]

S = jax.ShapeDtypeStruct
f32, i32 = jnp.float32, jnp.int32
kinds = {
    "matmul": (lambda a, b: a @ b, (S((8, 16), f32), S((16, 4), f32))),
    "gather": (lambda x, i: jnp.take(x, i, axis=0), (S((10, 4), f32), S((6,), i32))),
    "scatter": (lambda v, i: jax.ops.segment_sum(v, i, num_segments=10),
                (S((6, 4), f32), S((6,), i32))),
    "reduce_sum": (lambda x: jnp.sum(x, axis=0), (S((10, 4), f32),)),
    "cumsum": (lambda x: jnp.cumsum(x, axis=0), (S((10,), f32),)),
}
for k, (fn, a) in kinds.items():
    out["kinds"][k] = [float(v) for v in jaxpr_cost.step_cost(fn, *a)]

cfg = get_smoke("qwen1.5-0.5b")
params = jax.eval_shape(lambda k: M.init_params(cfg, k), jax.random.key(0))
t = S((2, 64), i32)
for pol in ("full", "dots", "all_dots"):
    c = dataclasses.replace(cfg, remat_policy=pol)
    f = lambda p, a, b: jax.value_and_grad(lambda q: M.lm_loss(q, c, a, b))(p)
    out["remat"][pol] = float(jaxpr_cost.step_cost(f, params, t, t)[0])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(FULL)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------- #
# Build telemetry
# ---------------------------------------------------------------------- #

class _FakeNvcc:
    """Stands in for ``subprocess.Popen`` of nvcc: writes the output file."""

    def __init__(self, cmd, **kwargs):
        self.out = pathlib.Path(cmd[cmd.index("-o") + 1])
        self.returncode = 0

    def communicate(self):
        self.out.write_bytes(b"")
        return "ptxas info    : Compiling entry function for 'sm_90a'", None


@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    return _build


def test_compile_counters_are_the_build_counters(stub_build):
    from repro_torch.core import jit_telemetry as jt

    c0, s0 = jt.compile_count(), jt.compile_seconds()
    assert (c0, s0) == (stub_build.build_count(), stub_build.build_seconds())
    secs = stub_build.build_all(["kcore_hindex", "segment_sum"])
    assert jt.compile_count() - c0 == 2 == stub_build.build_count() - c0
    assert jt.compile_seconds() - s0 == pytest.approx(sum(secs.values()))
    # every library exists now: no build, no count
    stub_build.build_all(["kcore_hindex", "segment_sum"])
    assert jt.compile_count() - c0 == 2
    assert jt.compile_seconds() == stub_build.build_seconds()


def test_a_build_under_tracing_is_one_kernel_build_span(stub_build, monkeypatch):
    from repro_torch.obs import trace

    trace.reset()
    trace.enable()
    try:
        with trace.span("outer"):
            stub_build.build_all(["flash_attention", "embedding_bag"])
        stub_build.build_all(["flash_attention"])           # built already: no span
        events = trace.events()
    finally:
        trace.disable()
        trace.reset()
    builds = [e for e in events if e["name"] == "kernel.build"]
    assert len(builds) == 1
    assert builds[0]["args"]["kernels"] == "flash_attention,embedding_bag"
    outer = next(e for e in events if e["name"] == "outer")
    assert outer["ts"] <= builds[0]["ts"] and \
        builds[0]["ts"] + builds[0]["dur"] <= outer["ts"] + outer["dur"] + 0.01


def test_telemetry_never_takes_a_build_down(stub_build, monkeypatch):
    from repro_torch.obs import trace

    def broken(*a, **k):
        raise RuntimeError("tracer down")

    monkeypatch.setattr(trace, "record", broken)
    monkeypatch.setattr(trace, "enabled", lambda: True)
    assert set(stub_build.build_all(["segment_sum"])) == {"segment_sum"}


# ---------------------------------------------------------------------- #
# The kernels' cost functions and their bookings
# ---------------------------------------------------------------------- #

def _mask_pairs(Sq, Sk, causal, window):
    """chip_smoke.py's count of the (q, k) pairs, from the mask itself."""
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    seen = mask.sum(1)
    return int(torch.where(seen == 0, Sk, seen).sum())


# the shapes chip_smoke.py times: the flash serve shape, yi-34b's heads, the
# windowed prefill of mixtral-8x22b, rows masked everywhere, Sq != Sk
FLASH_SHAPES = [(8, 2048, 2048, 16, 16, 64, 2, True, None),
                (1, 2048, 2048, 56, 8, 128, 2, True, None),
                (1, 9000, 9000, 48, 8, 128, 2, True, 4096), (2, 300, 300, 4, 2, 64, 4, True, -5),
                (1, 100, 700, 4, 4, 32, 4, False, None), (1, 700, 100, 4, 1, 16, 4, True, 33)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,s,causal,window", FLASH_SHAPES)
def test_flash_cost_is_the_smoke_formula(B, Sq, Sk, Hq, Hkv, d, s, causal, window):
    from repro_torch.kernels.flash_attention import ops as fa

    flops, nbytes = fa.cost(B, Sq, Sk, Hq, Hkv, d, s, causal, window)
    assert flops == 4 * B * Hq * d * _mask_pairs(Sq, Sk, causal, window)
    q, k = B * Sq * Hq * d, B * Sk * Hkv * d
    assert nbytes == (2 * q + k + k) * s


def test_flash_cost_at_the_serve_shape_is_perf_md_bound():
    from repro_torch.kernels.flash_attention import ops as fa

    flops, _ = fa.cost(8, 2048, 2048, 16, 16, 64, 2, True, None)
    assert flops == 4 * 128 * 2048 * 2049 // 2 * 64 == pytest.approx(6.875e10, rel=1e-3)


@pytest.mark.parametrize("E,n,F,s", [(327_660, 40_962, 512, 4), (1_865_728, 2_097_152, 1152, 2),
                                     (98_432, 1, 1152, 2), (10, 3, 1, 4)])
def test_float_segment_sum_costs_are_the_smoke_formulas(E, n, F, s):
    from repro_torch.kernels.segment_sum import ops as sk

    assert sk.float_cost(E, n, F, s) == (0.0, E * F * s + 8 * E + 8 * (n + 1) + n * F * s)
    assert sk.float_backward_cost(E, n, F, s) == (0.0, n * F * s + 8 * E + E * F * s)


@pytest.mark.parametrize("E,n", [(59_703_296, 2_097_152), (98_432, 1), (0, 5)])
def test_segment_sum_cost_is_the_smoke_formula(E, n):
    from repro_torch.kernels.segment_sum import ops as sk

    assert sk.cost(E, n) == (0.0, 4 * E + 8 * (n + 1) + 4 * n)


@pytest.mark.parametrize("R,W", [(1_048_576, 8), (65_536, 64), (3, 98_432), (0, 16)])
def test_hindex_cost_is_the_smoke_formula(R, W):
    from repro_torch.kernels.kcore_hindex import ops as hk

    assert hk.cost(R, W) == (0.0, 4 * R * W + 8 * R)


@pytest.mark.parametrize("B", [512, 262_144])
def test_bag_cost_is_the_smoke_formula(B):
    from repro_torch.kernels.embedding_bag import ops as bag

    V, D, L = 10_000, 18, 16
    idx = np.random.default_rng(0).integers(-1, V, (B, L))
    rows = len(np.unique(idx[idx >= 0]))
    assert bag.cost(B, L, D, V, 4, rows) == (0.0, idx.size * 4 + B * D * 4 + rows * D * 4)
    assert bag.cost(B, L, D, V, 4) == bag.cost(B, L, D, V, 4, min(V, B * L))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_every_entry_point_books_its_cost_once(device):
    from repro_torch.kernels.embedding_bag import ops as bag
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk

    g = torch.Generator().manual_seed(0)

    def t(shape, dtype=torch.float32, high=5):
        x = (torch.randn(shape, generator=g) if dtype.is_floating_point
             else torch.randint(0, high, shape, generator=g)).to(dtype)
        return x.to(device)

    q = t((2, 16, 4, 8))
    kv = t((2, 16, 2, 8))
    ids = torch.tensor([0, 0, 2, 3, 3, 3])
    lay = sk.segment_layout(ids.to(device) if device == "cpu" else ids.to("meta"), 4)
    vals = t((6, 3)).requires_grad_(True)
    calls = [("flash_attention", lambda: fa.flash_attention(q, kv, kv, causal=True, window=5),
              fa.cost(2, 16, 16, 4, 2, 8, 4, True, 5)),
             ("kcore_hindex", lambda: hk.hindex_rows(t((5, 7), torch.int32), t((5,), torch.int32),
                                                     3), hk.cost(5, 7)),
             ("segment_sum", lambda: sk.segment_sum(t((6,), torch.int32),
                                                     torch.tensor([0, 2, 2, 3, 6]).to(device)),
              sk.cost(6, 4)),
             ("segment_sum_float", lambda: sk.segment_sum_float(vals, lay),
              sk.float_cost(6, 4, 3, 4)),
             ("embedding_bag", lambda: bag.embedding_bag_sum(t((9, 3)), t((4, 2), torch.int32, 9)),
              bag.cost(4, 2, 3, 9, 4))]
    for name, call, (flops, nbytes) in calls:
        c = StepCounter()
        with c:
            out = call()
        assert out.device.type == device
        assert c.by_kernel == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}, name
        # the plain version's own ops are not counted
        assert (c.flops, c.bytes) == (flops, nbytes) and c.by_kind == {}, name
    # the float form's backward is the gather it is, counted as one
    c = StepCounter()
    with c:
        sk.segment_sum_float(vals, lay).backward(torch.ones(4, 3, device=device))
    assert c.by_kind["gather"] == [1, 0.0, sk.float_backward_cost(6, 4, 3, 4)[1]]


# the closed form against the mask, where each bound turns and where it does not: rows masked
# everywhere (window <= 0, Sq past Sk), windows wider than the keys, a query or a key alone
PAIRS_CASES = [(Sq, Sk, causal, w) for Sq, Sk in [(0, 4), (1, 1), (5, 3), (3, 5), (17, 17), (64, 9)]
               for causal in (True, False) for w in (None, -2, 0, 1, 4, 16, 1 << 30)]


@pytest.mark.parametrize("Sq,Sk,causal,window", PAIRS_CASES)
def test_flash_pairs_closed_form_is_the_mask_count(Sq, Sk, causal, window):
    from repro_torch.kernels.flash_attention import ops as fa

    assert fa.pairs(Sq, Sk, causal, window) == _mask_pairs(Sq, Sk, causal, window)


def test_booking_is_lazy_and_per_thread():
    import threading

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.flash_attention import ops as fa

    def refuse(*shape):
        raise AssertionError("the cost was computed with no counter open")

    with kcost.kernel_call("k", refuse, 1, 2):     # no counter open: the cost is never asked
        assert not kcost.is_uncounted()
    q = torch.randn(1, 8, 2, 8)
    elsewhere = {}

    def other_thread():
        c = StepCounter()
        with c:
            fa.flash_attention(q, q, q)
        elsewhere["by_kernel"], elsewhere["seen_here"] = c.by_kernel, dict(main.by_kernel)

    main = StepCounter()
    with main:
        fa.flash_attention(q, q, q)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        assert kcost.is_uncounted() is False
    flops, nbytes = fa.cost(1, 8, 8, 2, 2, 8, 4)
    one = {"calls": 1, "flops": flops, "bytes": nbytes}
    assert main.by_kernel == {"flash_attention": one}
    assert elsewhere == {"by_kernel": {"flash_attention": one},
                         "seen_here": {"flash_attention": one}}


def test_a_checkpoint_recompute_is_booked():
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.segment_sum import ops as sk

    lay = sk.segment_layout(torch.tensor([0, 0, 2, 3, 3, 3]), 4)
    vals = torch.randn(6, 8, requires_grad=True)
    counter = StepCounter()
    with counter:
        checkpoint(lambda v: sk.segment_sum_float(v, lay).square().sum(), vals,
                   use_reentrant=False).backward()
    assert counter.by_kernel["segment_sum_float"]["calls"] == 2     # the forward and its recompute


def test_collective_tally_is_per_thread():
    import threading

    from repro_torch.distribution import compat
    from repro_torch.distribution.collectives import collective_bytes, wire_bytes

    mesh = compat.make_mesh((4,), ("data",), device="cpu")
    x = torch.zeros(4, 6, dtype=torch.int32)
    other = threading.Thread(target=lambda: (compat.all_gather(x, mesh), compat.psum(x, mesh)))
    with collective_bytes() as tally:
        compat.all_gather(x, mesh)
        compat.psum(x, mesh)
        other.start()
        other.join()
    assert tally["counts"] == {"all-gather": 1, "all-reduce": 1}
    assert tally["total_bytes"] == wire_bytes("all-gather", 96, 4) + wire_bytes("all-reduce", 96, 4)


# ---------------------------------------------------------------------- #
# step_cost against the reference's jaxpr_cost
# ---------------------------------------------------------------------- #

def test_matmul_flops_and_checkpoint_recompute_are_counted():
    from torch.utils.checkpoint import checkpoint

    w = torch.randn(16, 8, requires_grad=True)
    x = torch.randn(4, 16)

    def loss(remat):
        f = (lambda a: torch.tanh(a @ w))
        y = checkpoint(f, x, use_reentrant=False) if remat else f(x)
        return y.sum()

    plain = step_cost(lambda: loss(False).backward())[0]
    remat = step_cost(lambda: loss(True).backward())[0]
    assert plain == 2 * 2 * 4 * 16 * 8              # forward and the weight's gradient
    assert remat == plain + 2 * 4 * 16 * 8          # plus the recomputed forward
    b = torch.randn(3, 4, 5)
    assert step_cost(torch.bmm, b, torch.randn(3, 5, 2))[0] == 2 * 3 * 4 * 5 * 2


@pytest.mark.parametrize("arch,shape", FULL[:5], ids=lambda x: x)
def test_step_flops_equal_the_reference_at_full_size(arch, shape, reference):
    from repro_torch.launch import dryrun

    rec = dryrun.meta_count(arch, shape)
    assert rec["flops"] == reference["full"][f"{arch}/{shape}"][0]


def test_prefill_flops_equal_the_reference_but_attention(reference):
    """The reference's prefill attends through XLA products over every
    (query, key) pair, and recomputes k and v for its cache; the port books
    the flash kernel's causal pairs and computes k and v once. Everything
    else is held exactly, each term from the shapes."""
    from repro_torch.configs.registry import get_config, shape_by_name
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import dryrun

    cfg = get_config("qwen1.5-0.5b")
    sp = shape_by_name("qwen1.5-0.5b", "prefill_32k").params
    B, S, L = sp["global_batch"], sp["seq_len"], cfg.n_layers
    Hq, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rec = dryrun.meta_count("qwen1.5-0.5b", "prefill_32k")
    flash = L * fa.cost(B, S, S, Hq, Hkv, d, 2, True, None)[0]
    assert rec["by_kernel"]["flash_attention"]["flops"] == flash
    ref_attention = L * 2 * (2 * B * Hq * S * S * d)        # q k^T and p v over all S x S pairs
    ref_kv_again = L * 2 * (2 * B * S * cfg.d_model * Hkv * d)
    ref = reference["full"]["qwen1.5-0.5b/prefill_32k"][0]
    assert rec["flops"] - flash == ref - ref_attention - ref_kv_again


def _port_kinds():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
    i = torch.tensor([3, 0, 9, 9, 1, 4], dtype=torch.int32)
    return {
        "matmul": lambda: r(8, 16) @ r(16, 4),
        "gather": lambda: r(10, 4).index_select(0, i),
        "scatter": lambda: torch.zeros(10, 4).index_add(0, i, r(6, 4)),
        "reduce_sum": lambda: r(10, 4).sum(0),
        "cumsum": lambda: torch.cumsum(r(10), 0),
    }


@pytest.mark.parametrize("kind", ["matmul", "gather", "scatter", "reduce_sum", "cumsum"])
def test_bytes_per_op_kind_equal_the_reference(kind, reference):
    c = StepCounter()
    with c:
        _port_kinds()[kind]()
    assert list(c.by_kind) == [kind]
    assert [c.flops, c.bytes] == reference["kinds"][kind]


def test_sort_and_topk_bytes_count_torchs_int64_indices():
    x = torch.randn(10)
    c = StepCounter()
    with c:
        torch.sort(x)
        torch.topk(x, 3)
    assert c.by_kind["sort"] == [1, 0.0, 40 + 40 + 80]
    assert c.by_kind["topk"] == [1, 0.0, 40 + 12 + 24]


# ---------------------------------------------------------------------- #
# The remat policies
# ---------------------------------------------------------------------- #

def test_remat_policies_equal_full_and_save_the_reference_s_products(reference):
    """``"dots"`` and ``"all_dots"`` give the loss and every gradient of
    ``"full"`` bit for bit on the CPU route; the backward products each
    saves, relative to ``"full"``, are the reference's jaxpr count of the
    same difference (and each policy's whole count is the reference's)."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.autodiff import value_and_grad
    from repro_torch.models.transformer import model as PM
    from repro_torch.tree import leaves

    cfg = get_smoke("qwen1.5-0.5b")
    params = PM.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    t = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), dtype=torch.int32)
    lab = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)), dtype=torch.int32)
    got = {}
    for pol in ("full", "dots", "all_dots"):
        c = dataclasses.replace(cfg, remat_policy=pol)
        counter = StepCounter()
        with counter:
            got[pol] = value_and_grad(lambda p: PM.lm_loss(p, c, t, lab), params)
        got[pol] += (counter.flops,)
    ref = reference["remat"]
    for pol in ("dots", "all_dots"):
        assert torch.equal(got[pol][0], got["full"][0])
        assert all(torch.equal(a, b) for a, b in zip(leaves(got[pol][1]), leaves(got["full"][1])))
        assert got["full"][2] - got[pol][2] == ref["full"] - ref[pol] > 0
    assert [got[p][2] for p in ("full", "dots", "all_dots")] == \
        [ref[p] for p in ("full", "dots", "all_dots")]


# ---------------------------------------------------------------------- #
# The dry-run's meta count
# ---------------------------------------------------------------------- #

def test_dryrun_counts_every_cell_on_meta(monkeypatch, tmp_path, capsys):
    """Every cell of the registry is counted at its full global shape on
    ``meta`` (the four ``long_500k`` cells of full attention skipped, as in
    the reference), each record written to the output directory."""
    from repro_torch.configs.registry import ARCH_IDS, get_shapes
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    dryrun.main(["--all"])
    lines = capsys.readouterr().out.splitlines()
    cells = [(a, s.name) for a in ARCH_IDS for s in get_shapes(a)]
    assert len(cells) == 40 and len(lines) == 40
    assert sum(line.startswith("[SKIP]") for line in lines) == 4
    assert all(line.startswith(("[OK]", "[SKIP]")) for line in lines), \
        [line for line in lines if not line.startswith(("[OK]", "[SKIP]"))]
    assert len(list(tmp_path.glob("*.json"))) == 40
    rec = json.loads((tmp_path / "din_serve_bulk_1.json").read_text())
    assert rec["status"] == "OK" and rec["by_kernel"]["embedding_bag"]["calls"] == 1
    assert rec["memory"]["temp_size_in_bytes"] == "not measured"
    assert rec["roofline"]["collective_s"] == "not measured"
    lm = json.loads((tmp_path / "qwen1.5-0.5b_prefill_32k_1.json").read_text())
    assert lm["by_kernel"]["flash_attention"]["calls"] == 24
    assert set(lm["flops_by_dtype"]) == {"bfloat16"}          # every product in bf16


def test_dryrun_depth_extension_equals_the_whole_count():
    """An LM counted at 1 and 2 layers and microbatches and extended equals
    the count of the whole step, field by field."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=3, train_microbatches=3)
    for shape, batch in (("train_4k", 3), ("prefill_32k", 1), ("decode_32k", 2)):
        ext = dryrun.meta_count("qwen2-moe-a2.7b", shape, batch=batch, cfg=cfg)
        whole = dryrun.count_cell(dryrun.build_cell("qwen2-moe-a2.7b", shape, batch=batch,
                                                    cfg=cfg))
        for key in ("flops", "bytes", "by_kind", "by_kernel", "memory"):
            assert ext[key] == whole[key], (shape, key)
