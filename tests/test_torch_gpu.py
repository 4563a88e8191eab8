"""The port on the card: each CUDA kernel against its plain version, the
decomposition through the k-core kernels (in memory, on a mesh of shards,
and out of core, blocks cycled through the card), the streaming engine (on a
mesh too) and the
sliding window on ``segment_sum`` against the CPU (and a window checkpoint
restored onto the card), the query server and its concurrent front end on
the card against the CPU and their snapshots, serving through the flash kernel
against the same weights served on the CPU, DIN through the
embedding-bag kernel against the CPU and a float64 evaluation, and the GNNs
on the float segment sum (its backward, the models and a weather training
step) against the CPU, LM training (the gradient, the embedding
gather's backward on the float kernel, the driver's restart, the trained
weights served on the flash kernel) against the CPU and itself, and MoE and
the sliding window (the MoE block's routing and output, its dispatch's
backward on the float kernel, the rolling cache served past its window)
against the CPU; a real nvcc build counted and traced, a dry-run cell's
count on the card against its meta count, and the example launchers.

Every test here is marked ``gpu`` and skips where no CUDA device is present;
the file imports neither ``jax`` nor the reference, so it runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro_torch import checks
from repro_torch.core.bz import bz_core_numbers
from repro_torch.core.kcore import kcore_decompose
from repro_torch.graph import generators
from repro_torch.configs import get_smoke
from repro_torch.kernels.embedding_bag import ops as bag
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.kcore_hindex import ops as hk
from repro_torch.kernels.segment_sum import ops as sk
from repro_torch.launch import din_serve, serve
from repro_torch.models.recsys import din, steps as din_steps
from repro_torch.models.recsys.embedding_bag import bag_sum
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,width,n_iters", [
    (1, 8, 13), (1001, 8, 13), (130, 17, 13), (77, 2048, 13), (5, 2049, 13),
    (3, 20000, 16), (64, 32, 3)])
def test_hindex_kernel_matches_plain(cuda, rows, width, n_iters):
    r = np.random.default_rng(rows + width)
    nbr = torch.as_tensor(r.integers(0, 3000, (rows, width)).astype(np.int32), device=cuda)
    est = torch.as_tensor(r.integers(0, 3000, rows).astype(np.int32), device=cuda)
    before = hk.launches
    got = hk.hindex_rows(nbr, est, n_iters)
    torch.cuda.synchronize()
    assert hk.launches == before + 1
    assert torch.equal(got, hk.hindex_rows_ref(nbr, est, n_iters))


@pytest.mark.parametrize("rows,width,hi,n_iters", [
    (1, 98432, 100000, 0), (1, 98432, 100000, 1), (1, 98432, 100000, 5),
    (1, 98432, 100000, 13), (1, 98432, 100000, 17), (1, 98432, 100000, 19),
    (2, 98432, 3000, 17), (3, 98432, 9000, 14), (4, 20000, 30000, 16), (4, 20000, 30000, 7),
    (9, 32, 100, 5), (9, 33, 100, 6), (65, 128, 300, 9), (65, 129, 300, 9),
    (17, 512, 1000, 11), (17, 513, 1000, 11), (7, 2048, 5000, 19), (5, 2049, 3000, 11)])
def test_hindex_kernel_at_the_wide_variants_edges(cuda, rows, width, hi, n_iters):
    """Every variant's border width, probe counts that stop a pass part way,
    R = 1, W = 98,432, and rows whose h-index lies above the block variant's
    8192-bin window (several passes)."""
    r = np.random.default_rng(rows * 7 + width + n_iters)
    nbr = torch.as_tensor(r.integers(0, hi, (rows, width)).astype(np.int32), device=cuda)
    est = torch.as_tensor(r.integers(hi // 2, hi, rows).astype(np.int32), device=cuda)
    est[0] = hi
    got = hk.hindex_rows(nbr, est, n_iters)
    torch.cuda.synchronize()
    assert torch.equal(got, hk.hindex_rows_ref(nbr, est, n_iters))


@pytest.mark.parametrize("E,n", [(1, 17), (33, 1), (100_001, 70_000), (1_000_000, 3)])
def test_segment_sum_kernel_matches_plain(cuda, E, n):
    r = np.random.default_rng(E)
    layout = sk.csr_layout(np.sort(r.integers(0, n, E)), n)
    vals = torch.as_tensor(r.integers(-2**31, 2**31, E).astype(np.int32), device=cuda)
    row_ptr = torch.as_tensor(layout.row_ptr, device=cuda)
    before = sk.launches
    got = sk.segment_sum(vals, row_ptr)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert torch.equal(got, sk.segment_sum_ref(vals, row_ptr))


def _csr(lengths, device):
    row_ptr = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    return torch.as_tensor(row_ptr, device=device)


@pytest.mark.parametrize("case", ["wide row among empty rows", "vals 4 bytes off 16",
                                  "E = 3 mod 4", "E = 0", "every row one arc",
                                  "rows of a whole block"])
def test_segment_sum_kernel_at_the_merge_paths_edges(cuda, case):
    """The merge path's edge cases (csrc/segment_sum.cu): a row spread over
    many blocks among 10^6 empty rows, a vals view that starts 4 bytes past a
    16-byte boundary, E not a multiple of 4, no arcs, a row end on every
    other item, and blocks that start exactly on row edges."""
    r = np.random.default_rng(len(case))
    lengths = {
        "wide row among empty rows": np.eye(1, 1_000_001, 500_000, dtype=np.int64)[0] * 98_432,
        "vals 4 bytes off 16": np.concatenate([np.zeros(999, np.int64), r.integers(0, 40, 20_000),
                                               np.zeros(999, np.int64)]),
        "E = 3 mod 4": np.full(10_001, 7),
        "E = 0": np.zeros(1_000_000, np.int64),
        "every row one arc": np.ones(1_000_003, np.int64),
        "rows of a whole block": np.full(33, sk.ITEMS_PER_BLOCK - 1),
    }[case]
    E = int(lengths.sum())
    x = torch.as_tensor(r.integers(-2**31, 2**31, E + 1).astype(np.int32), device=cuda)
    vals = x[1:] if case == "vals 4 bytes off 16" else x[:E]
    assert vals.is_contiguous() and (case != "vals 4 bytes off 16" or vals.data_ptr() % 16 == 4)
    row_ptr = _csr(lengths, cuda)
    before = sk.launches
    got = sk.segment_sum(vals, row_ptr)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert torch.equal(got, sk.segment_sum_ref(vals, row_ptr))


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_decomposition_on_the_card_runs_both_kernels(cuda, fused):
    g = generators.snap_analogue("EEN", 0.05, seed=0)
    hk.launches = sk.launches = 0
    res = kcore_decompose(g, fused=fused)
    assert res.dispatch == "kernel"
    assert hk.launches > 0 and sk.launches > 0
    np.testing.assert_array_equal(res.core, bz_core_numbers(g))
    cpu = kcore_decompose(g, fused=fused, device="cpu")
    assert res.rounds == cpu.rounds
    np.testing.assert_array_equal(res.stats.messages_per_round, cpu.stats.messages_per_round)


@pytest.mark.parametrize("mode,backend,n_blocks,kernel", [
    ("jacobi", "ell", 8, "kcore_hindex"), ("jacobi", "ell_pallas", 8, "kcore_hindex"),
    ("block_gs", "segment", 8, "segment_sum"), ("block_gs", "segment", 16, "segment_sum")])
def test_other_static_modes_on_the_card_equal_the_cpu(cuda, mode, backend, n_blocks, kernel):
    from repro_torch.core.kcore import KCoreConfig

    g = generators.snap_analogue("FC", 0.05, seed=0)
    config = KCoreConfig(mode=mode, backend=backend, n_blocks=n_blocks)
    hk.launches = sk.launches = 0
    res = kcore_decompose(g, config)
    assert res.dispatch == "kernel"
    assert {"kcore_hindex": hk.launches, "segment_sum": sk.launches}[kernel] > 0
    assert sk.launches > 0 and (hk.launches == 0) == (mode == "block_gs")
    np.testing.assert_array_equal(res.core, bz_core_numbers(g))
    cpu = kcore_decompose(g, config, device="cpu")
    assert res.rounds == cpu.rounds
    for k in ("messages_per_round", "active_per_round", "changed_per_round"):
        np.testing.assert_array_equal(getattr(res.stats, k), getattr(cpu.stats, k))


@pytest.mark.parametrize("mem_budget,n_blocks", [(1 << 20, None), (None, 16)])
def test_out_of_core_on_the_card_equals_the_cpu(cuda, mem_budget, n_blocks):
    """Blocks cycled through the card: the CPU route's result field for field
    (but the walls and the process's RSS), ``segment_sum`` launched, and the
    card's measured peak below the arc arrays' bytes."""
    import dataclasses

    from repro_torch.core.outofcore import outofcore_decompose

    g = generators.erdos_renyi(20000, 400000, seed=0)
    cpu = outofcore_decompose(g, mem_budget=mem_budget, n_blocks=n_blocks, device="cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sk.launches = 0
    res = outofcore_decompose(g, mem_budget=mem_budget, n_blocks=n_blocks)
    peak = torch.cuda.max_memory_allocated() - base
    assert res.dispatch == "kernel" and sk.launches > 0
    np.testing.assert_array_equal(res.core, bz_core_numbers(g))
    np.testing.assert_array_equal(res.core, cpu.core)
    assert (res.rounds, res.converged) == (cpu.rounds, cpu.converged)
    for k in ("messages_per_round", "active_per_round", "changed_per_round"):
        np.testing.assert_array_equal(getattr(res.stats, k), getattr(cpu.stats, k))
    got, want = dataclasses.asdict(res.block_stats), dataclasses.asdict(cpu.block_stats)
    for k in ("peak_rss_bytes", "ms_per_round"):
        got.pop(k), want.pop(k)
    assert got == want
    assert res.block_stats.device_block_bytes < res.block_stats.total_arc_bytes
    assert peak < res.block_stats.total_arc_bytes


@pytest.mark.parametrize("mode", ["dense", "compact", "fused", "auto"])
def test_streaming_modes_on_the_card_equal_the_cpu(cuda, mode):
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine, random_churn_batch

    g = generators.snap_analogue("EEN", 0.05, seed=0)
    card = StreamingKCoreEngine(g, StreamingConfig(frontier=mode))
    cpu = StreamingKCoreEngine(g, StreamingConfig(frontier=mode), device="cpu")
    rng = np.random.default_rng(1)
    for churn in (12, 200, 40):
        batch = random_churn_batch(cpu.graph, churn, churn, rng)
        sk.launches = 0
        got = card.apply_batch(batch)
        assert sk.launches > 0
        want = cpu.apply_batch(batch)
        np.testing.assert_array_equal(got.core, want.core)
        np.testing.assert_array_equal(got.core, bz_core_numbers(cpu.graph))
        assert (got.rounds, got.mode, got.region_size, got.seed_strategy) == \
            (want.rounds, want.mode, want.region_size, want.seed_strategy)
        for k in ("messages_per_round", "active_per_round", "changed_per_round"):
            np.testing.assert_array_equal(getattr(got.stats, k), getattr(want.stats, k))


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
@pytest.mark.parametrize("shape,axes", [((4,), ("data",)), ((2, 2), ("data", "model"))])
def test_sharded_decomposition_on_the_card_equals_the_cpu(cuda, shape, axes, fused):
    """The sharded superstep on ``cuda`` (the local shards stacked into one
    CSR, ``segment_sum`` n_iters + 1 times a round) against ``cpu``."""
    from repro_torch.core.kcore import _bs_iters, kcore_decompose_sharded
    from repro_torch.distribution.compat import make_mesh

    g = generators.snap_analogue("EEN", 0.05, seed=0)
    cpu = kcore_decompose_sharded(g, make_mesh(shape, axes, device="cpu"), axes, fused=fused)
    sk.launches = 0
    res = kcore_decompose_sharded(g, make_mesh(shape, axes), axes, fused=fused)
    assert res.dispatch == "kernel"
    assert sk.launches == (_bs_iters(g.max_deg) + 1) * res.rounds
    np.testing.assert_array_equal(res.core, bz_core_numbers(g))
    np.testing.assert_array_equal(res.core, cpu.core)
    assert (res.rounds, res.converged) == (cpu.rounds, cpu.converged)
    for k in ("messages_per_round", "active_per_round", "changed_per_round"):
        np.testing.assert_array_equal(getattr(res.stats, k), getattr(cpu.stats, k))


@pytest.mark.parametrize("mode", ["sharded", "fused", "auto"])
def test_sharded_streaming_on_the_card_equals_the_cpu(cuda, mode):
    from repro_torch.distribution.compat import make_mesh
    from repro_torch.streaming import StreamingConfig, StreamingKCoreEngine, random_churn_batch

    g = generators.snap_analogue("EEN", 0.05, seed=0)
    config = StreamingConfig(frontier=mode)
    card = StreamingKCoreEngine(g, config, mesh=make_mesh((4,), ("data",)))
    cpu = StreamingKCoreEngine(g, config, mesh=make_mesh((4,), ("data",), device="cpu"))
    assert card.device.type == "cuda"
    rng = np.random.default_rng(1)
    for churn in (12, 200, 40):
        batch = random_churn_batch(cpu.graph, churn, churn, rng)
        sk.launches = 0
        got = card.apply_batch(batch)
        assert sk.launches > 0
        want = cpu.apply_batch(batch)
        np.testing.assert_array_equal(got.core, want.core)
        np.testing.assert_array_equal(got.core, bz_core_numbers(cpu.graph))
        assert (got.rounds, got.mode, got.region_size, got.flag_reads) == \
            (want.rounds, want.mode, want.region_size, want.flag_reads)
        for k in ("messages_per_round", "active_per_round", "changed_per_round"):
            np.testing.assert_array_equal(getattr(got.stats, k), getattr(want.stats, k))
    assert card.state_dict()["shard_A_floor"] == cpu.state_dict()["shard_A_floor"]


def _same_step(got, want):
    assert (got.step, got.lo, got.hi, got.m) == (want.step, want.lo, want.hi, want.m)
    r, w = got.result, want.result
    np.testing.assert_array_equal(r.core, w.core)
    assert (r.rounds, r.mode, r.region_size, r.seed_strategy, r.csr_compactions) == \
        (w.rounds, w.mode, w.region_size, w.seed_strategy, w.csr_compactions)
    for k in ("messages_per_round", "active_per_round", "changed_per_round"):
        np.testing.assert_array_equal(getattr(r.stats, k), getattr(w.stats, k))


@pytest.mark.parametrize("mode", ["dense", "compact", "fused", "auto"])
def test_window_on_the_card_equals_the_cpu(cuda, mode):
    from repro_torch.streaming import StreamingConfig
    from repro_torch.temporal import WindowedKCoreEngine, check_step, temporal_snap_analogue

    log = temporal_snap_analogue("EEN", 0.05, seed=0, remove_frac=0.15)
    stride = len(log) // 10
    config = StreamingConfig(frontier=mode)
    card = WindowedKCoreEngine(log, 3 * stride, stride, config=config)
    cpu = WindowedKCoreEngine(log, 3 * stride, stride, config=config, device="cpu")
    assert card.engine.device.type == "cuda"
    for k in (1, 2, 1, 1, 3, 1):
        sk.launches = 0
        got = card.advance(k)
        assert sk.launches > 0
        _same_step(got, cpu.advance(k))
        assert check_step(card, got)


def test_window_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.temporal import WindowedKCoreEngine, temporal_barabasi_albert

    log = temporal_barabasi_albert(2000, 4, seed=1, remove_frac=0.15)
    cpu = WindowedKCoreEngine(log, 3000, 1000, device="cpu")
    for _ in range(3):
        cpu.advance()
    save_checkpoint(tmp_path, cpu.steps_taken, cpu.state_dict())
    card = WindowedKCoreEngine(log, 3000, 1000)
    state, step = restore_checkpoint(tmp_path, card.state_dict())
    card.load_state_dict(state)
    assert step == 3 and card.engine.device.type == "cuda" and card.steps_taken == 3
    while not cpu.done:
        sk.launches = 0
        got = card.advance()
        assert sk.launches > 0
        _same_step(got, cpu.advance())
    like = {"est": torch.zeros(4, dtype=torch.int32, device=cuda), "n": np.zeros(())}
    save_checkpoint(tmp_path, 9, {"est": torch.arange(4, dtype=torch.int32), "n": np.ones(())})
    out, _ = restore_checkpoint(tmp_path, like)
    assert out["est"].device.type == "cuda" and out["est"].tolist() == [0, 1, 2, 3]
    assert isinstance(out["n"], np.ndarray) and float(out["n"]) == 1.0


def test_served_graph_on_the_card_equals_the_cpu(cuda):
    from repro_torch.streaming import KCoreServer, Request, StreamingConfig, random_churn_batch

    g = generators.barabasi_albert(3000, 4, seed=0)
    hk.launches = sk.launches = 0
    card = KCoreServer(g, StreamingConfig(frontier="fused"))
    assert card.engine.device.type == "cuda" and hk.launches > 0
    cpu = KCoreServer(g, StreamingConfig(frontier="fused"), device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = random_churn_batch(cpu.engine.graph, 30, 30, rng)
        ids = rng.integers(0, g.n, 64)
        reqs = [Request(op="update", batch=batch), Request(op="core", vertices=ids),
                Request(op="in_kcore", vertices=ids, k=3), Request(op="members", k=4),
                Request(op="max_k"), Request(op="core", vertices=[g.n])]
        sk.launches = 0
        got, want = card.serve(reqs), cpu.serve(reqs)
        assert sk.launches > 0
        assert [(r.ok, r.error) for r in got] == [(r.ok, r.error) for r in want]
        assert got[0].payload.total_messages == want[0].payload.total_messages
        for a, b in zip(got[1:5], want[1:5]):
            np.testing.assert_array_equal(a.payload, b.payload)
        np.testing.assert_array_equal(card.core, bz_core_numbers(cpu.engine.graph))
    keep = ("queries_served", "clients_answered", "errors_returned", "updates_applied",
            "update_messages", "update_rounds", "max_k", "m")
    assert {k: card.stats()[k] for k in keep} == {k: cpu.stats()[k] for k in keep}


def test_concurrent_reads_during_card_updates_match_their_versions(cuda):
    import threading

    from repro_torch.streaming import (ConcurrentKCoreServer, KCoreServer, Request,
                                       random_churn_batch)

    front = ConcurrentKCoreServer(KCoreServer(generators.barabasi_albert(5000, 4, seed=1)))
    registry = {front.snapshot.version: front.snapshot}
    stop, outs = threading.Event(), [[] for _ in range(4)]

    def reader(seed, out):
        r = np.random.default_rng(seed)
        while True:
            req = Request(op="core", vertices=r.integers(0, 5000, 32))
            out.append((req, front.read(req)))
            if stop.wait(1e-3):      # spinning readers would slow the writer many-fold
                return

    threads = [threading.Thread(target=reader, args=(i, outs[i]), daemon=True) for i in range(4)]
    for th in threads:
        th.start()
    rng = np.random.default_rng(3)
    try:
        for _ in range(4):
            sk.launches = 0
            front.update(random_churn_batch(front.server.engine.graph, 100, 100, rng))
            assert sk.launches > 0
            registry[front.snapshot.version] = front.snapshot
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    pairs = [p for out in outs for p in out]
    assert pairs and all(resp.ok for _, resp in pairs)
    for req, resp in pairs:
        np.testing.assert_array_equal(resp.payload, registry[resp.version].core[req.vertices])
    np.testing.assert_array_equal(front.snapshot.core,
                                  bz_core_numbers(front.server.engine.graph))


# tolerances of tests/test_kernels.py:160 (reasons in tests/test_torch_flash_attention.py)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,dtype", [
    (2, 256, 256, 4, 4, 64, True, None, torch.bfloat16),     # tensor-core kernel, d 64
    (1, 200, 200, 4, 2, 128, True, None, torch.bfloat16),    # d 128, GQA, ragged tiles
    (2, 130, 130, 8, 1, 64, True, 48, torch.bfloat16),       # MQA, window
    (1, 96, 160, 2, 2, 64, False, None, torch.bfloat16),     # Sq != Sk, not causal
    (1, 100, 20, 2, 1, 64, True, 8, torch.bfloat16),         # rows masked everywhere
    (1, 100, 20, 2, 1, 128, True, 8, torch.float32),
    (2, 77, 77, 4, 2, 64, True, 16, torch.float32),          # float32 kernel
    (1, 65, 33, 2, 2, 128, False, 9, torch.float32),
    (2, 40, 40, 4, 4, 16, True, None, torch.bfloat16),       # small d: CUDA-core kernel
    (1, 50, 50, 8, 2, 8, True, 7, torch.float32),
    # the wgmma kernel: 128-row q tiles, 128-key (d 64) or 64-key (d 128) kv tiles
    (1, 129, 129, 4, 4, 64, True, None, torch.bfloat16),     # one row past a q tile
    (1, 200, 333, 2, 2, 128, False, None, torch.bfloat16),   # Sq, Sk off the tiles
    (2, 300, 300, 8, 4, 128, True, 100, torch.bfloat16),     # d 128, GQA rep 2, window
    (1, 257, 257, 4, 1, 128, True, None, torch.bfloat16),    # d 128, MQA
    (1, 100, 20, 4, 2, 128, True, 8, torch.bfloat16),        # d 128, rows masked everywhere
    (1, 700, 260, 4, 4, 64, True, 70, torch.bfloat16),       # masked everywhere past row 328
])
def test_flash_kernel_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, window, dtype):
    r = np.random.default_rng(Sq * 1000 + Sk + D)
    q, k, v = (torch.as_tensor(r.standard_normal(shape, dtype=np.float32), device=cuda).to(dtype)
               for shape in [(B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)])
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype and torch.isfinite(got).all()
    want = fa.attention_ref(q.transpose(1, 2).reshape(B * Hq, Sq, D),
                            k.transpose(1, 2).reshape(B * Hkv, Sk, D),
                            v.transpose(1, 2).reshape(B * Hkv, Sk, D), causal=causal, window=window)
    want = want.reshape(B, Hq, Sq, D).transpose(1, 2)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]


def test_flash_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 8, 2, 24, device=cuda)
    before = fa.launches
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    assert fa.launches == before


def test_flash_kernel_reads_strided_views_in_place(cuda):
    r = np.random.default_rng(5)
    qkv = torch.as_tensor(r.standard_normal((2, 300, 3, 4, 64), dtype=np.float32),
                          device=cuda).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert fa._kernel_layout(q) is q
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("D,Hq,Hkv", [(64, 8, 2), (128, 4, 4)])
def test_flash_kernel_on_views_of_one_fused_projection(cuda, D, Hq, Hkv):
    """q, k and v as head slices of one (B, S, Hq + 2 Hkv, d) projection: the
    tensor maps read them through their strides, with no copy."""
    r = np.random.default_rng(D + Hq)
    B, S = 2, 333
    qkv = torch.as_tensor(r.standard_normal((B, S, Hq + 2 * Hkv, D), dtype=np.float32),
                          device=cuda).bfloat16()
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    assert all(fa._kernel_layout(t) is t for t in (q, k, v))
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = fa.attention_ref(q.transpose(1, 2).reshape(B * Hq, S, D),
                            k.transpose(1, 2).reshape(B * Hkv, S, D),
                            v.transpose(1, 2).reshape(B * Hkv, S, D), causal=True)
    want = want.reshape(B, Hq, S, D).transpose(1, 2)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[torch.bfloat16]


def test_serve_on_the_card_matches_the_cpu(cuda):
    """The smoke qwen config (d_head 16: the CUDA-core kernel) served on the
    card and on the CPU from the same weights: prefill logits and four
    teacher-forced decode steps within two bf16 units in the last place of
    the largest logit, and one flash launch per layer in the prefill."""
    cfg = get_smoke("qwen1.5-0.5b")
    cpu_params = serve.make_params(cfg, 0, torch.device("cpu"))
    prompts = serve.make_prompts(cfg, 2, 40, torch.device("cpu"))
    fa.launches = 0
    card = serve.generate(serve.make_params(cfg, 0, cuda), cfg, prompts.to(cuda), 5,
                          keep_logits=True)
    assert fa.launches == cfg.n_layers
    plain = serve.generate(cpu_params, cfg, prompts, 5, forced=card.tokens, keep_logits=True)
    for got, want in zip([card.prefill_logits] + card.step_logits,
                         [plain.prefill_logits] + plain.step_logits):
        top = float(want.abs().max())
        tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
        assert float((got.cpu() - want).abs().max()) <= tol


# --------------------------- embedding bag -------------------------------- #

def _bag_inputs(V, D, B, L, dtype, device, lo=-1, seed=0):
    r = np.random.default_rng(seed + V + B + L)
    table = torch.as_tensor(r.standard_normal((V, D), dtype=np.float32), device=device).to(dtype)
    idx = torch.as_tensor(r.integers(lo, V, (B, L)).astype(np.int32), device=device)
    return table, idx


@pytest.mark.parametrize("V,D,B,L,dtype,lo", [
    (100, 8, 4, 5, torch.float32, -1), (500, 24, 13, 7, torch.float32, -1),
    (1000, 32, 32, 20, torch.float32, -1),                 # the reference's sweep
    (10_000, 18, 512, 16, torch.float32, 0),               # DIN's context bag, serve_p99
    (10_000, 18, 262_144, 16, torch.float32, 0),           # serve_bulk
    (1_000_000, 18, 4096, 100, torch.float32, -1),         # the item table
    (100, 18, 33, 1, torch.float32, -1), (100, 18, 7, 0, torch.float32, -1),
    (1000, 32, 64, 20, torch.bfloat16, -1), (10_000, 18, 512, 16, torch.bfloat16, 0)])
def test_bag_kernel_matches_plain(cuda, V, D, B, L, dtype, lo):
    """float32 within rtol = atol = 1e-5 (tests/test_kernels.py:202); bf16
    within one bf16 unit in the last place of the output (both sum in
    float32, in other orders, and round once)."""
    table, idx = _bag_inputs(V, D, B, L, dtype, cuda, lo)
    if V == 100 and L == 1:
        idx[::4] = -1
    before = bag.launches
    got = bag.embedding_bag_sum(table, idx)
    torch.cuda.synchronize()
    assert bag.launches == before + 1
    assert got.shape == (B, D) and got.dtype == dtype
    want = bag.embedding_bag_sum_ref(table, idx)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=2.0**-126))) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())
    if L == 0:
        assert not got.any()


@pytest.mark.parametrize("D,B,L,dtype,view", [
    (17, 301, 16, torch.float32, None), (18, 301, 16, torch.float32, None),
    (32, 301, 16, torch.float32, None),                      # 4-, 8- and 16-byte row reads
    (18, 301, 16, torch.float32, "element"), (32, 99, 16, torch.float32, "row"),
    (18, 97, 1, torch.float32, None), (18, 97, 15, torch.float32, None),
    (18, 97, 17, torch.float32, None), (18, 97, 100, torch.float32, None),
    (18, 1001, 16, torch.bfloat16, None), (17, 77, 16, torch.bfloat16, None),
    (18, 24 * 41 + 1, 16, torch.float32, None), (8, 128 * 3 + 5, 9, torch.float32, None),
    (200, 50, 33, torch.float32, None), (200, 50, 33, torch.float32, "element")])  # rounds
def test_bag_kernel_at_its_vector_widths(cuda, D, B, L, dtype, view):
    """Every row-read width the kernel picks, a table view whose base lies one
    element or one row into its buffer, L around the unrolled step and the
    staged tile, and B not a multiple of the bags a block takes."""
    V = 1000
    r = np.random.default_rng(D * 1000 + B + L)
    flat = torch.as_tensor(r.standard_normal((V + 1) * D + 1, dtype=np.float32),
                           device=cuda).to(dtype)
    table = {None: flat[:V * D].view(V, D), "element": flat[1:1 + V * D].view(V, D),
             "row": flat[:(V + 1) * D].view(V + 1, D)[1:]}[view]
    idx = torch.as_tensor(r.integers(-1, table.shape[0], (B, L)).astype(np.int32), device=cuda)
    before = bag.launches
    got = bag.embedding_bag_sum(table, idx)
    torch.cuda.synchronize()
    assert bag.launches == before + 1
    want = bag.embedding_bag_sum_ref(table, idx)
    assert got.shape == (B, D) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp(min=2.0**-126))) - 7)
        assert bool(((got.float() - want.float()).abs() <= ulp).all())


def test_bag_kernel_empty_batch_launches_nothing(cuda):
    table, idx = _bag_inputs(100, 18, 0, 5, torch.float32, cuda)
    before = bag.launches
    assert bag.embedding_bag_sum(table, idx).shape == (0, 18)
    assert bag.launches == before
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bag.embedding_bag_sum(table.double(), _bag_inputs(100, 18, 3, 5, torch.float32, cuda)[1])


def test_bag_gradient_on_the_card_equals_autograd_through_plain(cuda):
    table, idx = _bag_inputs(10_000, 18, 4096, 16, torch.float32, cuda)
    c = torch.randn(4096, 18, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    a = table.clone().requires_grad_(True)
    (bag_sum(a, idx) * c).sum().backward()
    b = table.clone().requires_grad_(True)
    (bag.embedding_bag_sum_ref(b, idx) * c).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


# --------------------------------- DIN ------------------------------------ #

def _hold(card, cpu, f64):
    r = checks.hold(card, cpu, f64)
    assert r["ok"], r


def test_din_serve_and_a_train_step_on_the_card_match_the_cpu(cuda):
    """The SMOKE config from the same weights and batches on the card, on the
    CPU and in float64 on the CPU, held by ``checks.hold``; one bag
    launch a serve step and a train step."""
    cfg = get_smoke("din")
    params = din.init_params(cfg, 0, cuda)
    p32 = din.params_to(params, "cpu")
    p64 = din.params_to(p32, dtype=torch.float64)
    sb = din_steps.synth_batch(cfg, din_serve.shape_spec("serve", 256), seed=99)
    bag.launches = 0
    with torch.no_grad():
        _hold(*(din.logits(p, cfg, din_steps.batch_to(sb, d))
                for p, d in [(params, cuda), (p32, "cpu"), (p64, "cpu")]))
    assert bag.launches == 1
    tb = din_steps.synth_batch(cfg, din_serve.shape_spec("train", 512), seed=1)
    step = din_steps.make_train_step(cfg)
    outs = [step(p, adamw_init(p), din_steps.batch_to(tb, d))
            for p, d in [(params, cuda), (p32, "cpu"), (p64, "cpu")]]
    assert bag.launches == 2
    _hold(*(o[2]["loss"] for o in outs))
    _hold(*(o[2]["grad_norm"] for o in outs))
    _hold(*(leaves(o[0]) for o in outs))


# ------------------- the float segment sum and the GNNs ------------------- #

def _float_case(cuda, E, n, F, dtype, seed, view=False, ids=None):
    r = np.random.default_rng(seed)
    ids = r.integers(0, n, E) if ids is None else ids
    base = torch.as_tensor(r.uniform(-100, 100, (E + 1, F + 3)).astype(np.float32)).to(dtype)
    vals = base[1:, 3:] if view else base[:E, :F].contiguous()
    return vals, ids


def _hold_float_kernel(cuda, vals, ids, n):
    """The kernel on the card: bit-equal to the plain version on the CPU
    (whose ``index_add_`` passes add in index order there: each stretch of
    ``sk.STRETCH`` arcs in edge order, then a row's stretches in order, as
    the kernel does), within ``checks.segment_sum_excess``'s bound of the
    plain version on the card (atomics in no fixed order), and the same bits
    on a second call; ``float_launches`` counts one a call, and each call
    leaves the stream's ticket counters at 0 for the next."""
    lay = sk.segment_layout(ids, n, device=cuda)
    v = vals.to(cuda)
    before = sk.float_launches
    got = sk.segment_sum_float(v, lay)
    again = sk.segment_sum_float(v, lay)
    torch.cuda.synchronize()
    assert sk.float_launches == before + (2 if n else 0)
    assert not sk._tickets(v.device).any()
    assert got.dtype == vals.dtype and torch.equal(got, again)
    cpu = sk.segment_sum_float(vals, sk.segment_layout(ids, n))
    assert torch.equal(got.cpu(), cpu)
    plain = sk.segment_sum_float_ref(v, lay.ids, n)
    assert checks.segment_sum_excess(v, lay.ids, n, got, plain)[0] <= 0


@pytest.mark.parametrize("F", [1, 3, 17, 64, 9 * 16, 512, 1152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_segment_sum_kernel_matches_plain(cuda, dtype, F):
    vals, ids = _float_case(cuda, 20_000, 1_500, F, dtype, F)
    _hold_float_kernel(cuda, vals, ids, 1_600)       # rows 1,500.. empty


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["E = 0", "rows of one arc", "masked pad arcs",
                                  "non-contiguous view", "base 4 bytes off 16", "(E,) values",
                                  "a 98,432-arc row among empty rows", "n = 0"])
def test_float_segment_sum_kernel_at_its_edges(cuda, dtype, case):
    r = np.random.default_rng(len(case))
    if case == "E = 0":
        vals, ids, n = torch.zeros((0, 8), dtype=dtype), np.zeros(0, np.int64), 100
    elif case == "rows of one arc":
        vals, _ = _float_case(cuda, 3_000, 1, 24, dtype, 1)
        ids, n = r.permutation(5_000)[:3_000], 5_000
    elif case == "masked pad arcs":
        vals, ids = _float_case(cuda, 9_000, 300, 128, dtype, 2)
        keep = torch.as_tensor(r.random(9_000) < 0.7)
        vals, ids, n = vals * keep[:, None].to(dtype), np.where(keep.numpy(), ids, 0), 300
    elif case == "non-contiguous view":
        vals, ids = _float_case(cuda, 7_000, 200, 64, dtype, 3, view=True)
        assert not vals.is_contiguous()
        n = 200
    elif case == "base 4 bytes off 16":
        x = torch.as_tensor(r.standard_normal(4_000 * 16 + 2).astype(np.float32)).to(dtype)
        vals = x[2 if dtype == torch.bfloat16 else 1:][:4_000 * 16].view(4_000, 16)
        assert vals.data_ptr() % 16 == 4
        ids, n = r.integers(0, 90, 4_000), 90
    elif case == "(E,) values":
        vals, ids, n = torch.as_tensor(r.standard_normal(3_840).astype(np.float32)).to(dtype), \
            np.repeat(np.arange(128), 30), 128
    elif case == "a 98,432-arc row among empty rows":
        vals, _ = _float_case(cuda, 98_432, 1, 256, dtype, 5)
        ids, n = np.full(98_432, 500_000), 1_000_001
    else:
        vals, ids, n = torch.zeros((0, 4), dtype=dtype), np.zeros(0, np.int64), 0
    _hold_float_kernel(cuda, vals, ids, n)


@pytest.mark.parametrize("F", [1, 3, 8, 144])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_segment_sum_kernel_at_the_stretch_boundaries(cuda, dtype, F):
    """Rows of 0, 1, S - 1, S, S + 1, 2S, 2S + 1 and 5S + 3 arcs (S = ``sk.STRETCH``),
    their arcs shuffled among each other's, and empty rows after them."""
    S = sk.STRETCH
    widths = (0, 1, S - 1, S, S + 1, 2 * S, 2 * S + 1, 5 * S + 3)
    ids = np.repeat(np.arange(len(widths)), widths)
    np.random.default_rng(F).shuffle(ids)
    vals, ids = _float_case(cuda, ids.size, 1, F, dtype, F, ids=ids)
    _hold_float_kernel(cuda, vals, ids, len(widths) + 3)


@pytest.mark.parametrize("F", [1, 3, 64, 512, 1152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_partial_kernel_is_the_unrounded_float_form(cuda, dtype, F):
    """``segment_sum_float_partial`` on the card: float32 out, bit-equal to
    its plain version on the CPU, rounded once bit for bit the float form's
    output, rows wider than a stretch among them; one launch a call."""
    S = sk.STRETCH
    ids = np.concatenate([np.random.default_rng(F).integers(0, 1_500, 20_000),
                          np.full(3 * S + 5, 1_550)])
    vals, ids = _float_case(cuda, ids.size, 1, F, dtype, F, ids=ids)
    lay = sk.segment_layout(ids, 1_600, device=cuda)
    v = vals.to(cuda)
    before = sk.float_launches
    got = sk.segment_sum_float_partial(v, lay)
    torch.cuda.synchronize()
    assert sk.float_launches == before + 1 and got.dtype == torch.float32
    assert torch.equal(got.cpu(), sk.segment_sum_float_partial(vals, sk.segment_layout(ids, 1_600)))
    assert torch.equal(got.to(dtype), sk.segment_sum_float(v, lay))
    assert not sk._tickets(v.device).any()


def test_gnn_mesh_step_on_the_card_matches_the_cpu(cuda):
    """GraphCast (SMOKE) on a 4-shard mesh of the card: the same step on a
    4-shard mesh of the CPU and the one-device step, by the bf16 rule
    against a float64 step; a float kernel launch a shard for each scatter
    and for each index of each gather's backward."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distribution import compat
    from repro_torch.models.gnn import common as PC, steps as PS

    cfg = get_smoke("graphcast")
    g = generators.erdos_renyi(1_200, 2_600, seed=0)
    batch = PC.batch_from_graph(g, 12, 5, seed=1)
    arcs = batch["src"].shape[0] - batch["src"].shape[0] % 4
    batch = dict(batch, src=batch["src"][:arcs], dst=batch["dst"][:arcs],
                 edge_mask=batch["edge_mask"][:arcs])
    shape = ShapeSpec("full_graph_sm", "full_graph", {"n_nodes": 1_200, "n_edges": arcs // 2,
                                                      "d_feat": 12, "n_classes": 5})
    params = PS.init_params(cfg, 0, d_in=12, n_classes=5, device="cpu")
    outs = []
    try:
        for dev in (cuda, "cpu"):
            mesh = compat.make_mesh((4,), ("data",), device=dev)
            step, _, _, _ = PS.build_train(cfg, shape, mesh)
            before = sk.float_launches
            p = PC.params_to(params, mesh.device)
            outs.append(step(p, adamw_init(p), PS.stage_batch(batch, mesh),
                             **PS.mesh_layouts(cfg, shape, batch, mesh)))
            if dev is cuda:
                torch.cuda.synchronize()
                # per layer: 4 partials forward, 4 recomputed, 8 in the gather's backward
                assert sk.float_launches - before == cfg.n_layers * 16
    finally:
        PC.set_flat_sharding(None, None)
    PS.build_train(cfg, shape, None)
    p64 = PC.params_to(params, dtype=torch.float64)
    with PC.plain_scatter():
        f64 = PS.make_train_step(cfg, shape)(p64, adamw_init(p64), PC.batch_to(batch, "cpu"))
    for pick in (lambda o: o[2]["loss"], lambda o: o[2]["grad_norm"], lambda o: leaves(o[1]["m"])):
        assert checks.hold_bf16(*(PC.params_to(pick(o), "cpu") for o in (*outs, f64)))["ok"]


def test_float_segment_sum_kernel_refuses_what_it_does_not_take(cuda):
    lay = sk.segment_layout(np.array([0, 1, 1]), 2, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sk.segment_sum_float(torch.ones(3, 2, dtype=torch.float64, device=cuda), lay)
    w = torch.ones(3, 2, device=cuda, requires_grad=True)
    # the backward on the card (a gather) equals the plain route's autograd; the forward is
    # the one launch
    g = torch.tensor([[1.0, -2.0], [3.5, 4.0]], device=cuda)
    before = sk.float_launches
    sk.segment_sum_float(w, lay).backward(g)
    assert sk.float_launches == before + 1
    wp = torch.ones(3, 2, device=cuda, requires_grad=True)
    sk.segment_sum_float_ref(wp, lay.ids, 2).backward(g)
    assert torch.equal(w.grad, wp.grad)
    with torch.no_grad():
        assert sk.segment_sum_float(w, lay).tolist() == [[1, 1], [2, 2]]
    with pytest.raises(ValueError, match="layout on"):
        sk.segment_sum_float(torch.ones(3, 2), lay)


def test_float_segment_sum_backward_on_the_card_equals_the_plain_route(cuda):
    r = np.random.default_rng(9)
    for dtype in (torch.float32, torch.bfloat16):
        for E, n, F in [(20_000, 1_600, 64), (5_000, 300, 1), (0, 13, 8)]:
            ids = r.integers(0, max(n - 100, 1), E)      # the last rows are empty
            lay = sk.segment_layout(ids, n, device=cuda)
            v = torch.as_tensor(r.standard_normal((E, F)).astype(np.float32), device=cuda)
            g = torch.as_tensor(r.standard_normal((n, F)).astype(np.float32), device=cuda)
            a, b = (v.to(dtype).requires_grad_(True) for _ in range(2))
            sk.segment_sum_float(a, lay).backward(g.to(dtype))
            sk.segment_sum_float_ref(b, lay.ids, n).backward(g.to(dtype))
            assert a.grad.dtype == dtype and torch.equal(a.grad, b.grad)


def test_weather_train_step_on_the_card_matches_the_cpu(cuda):
    """One step of the weather example's loss at SMOKE: the loss, and the
    gradient's leaves together (as the DIN test holds its updated
    parameters), on the card against the CPU and a float64 evaluation on the
    CPU (``checks.hold``); the processor blocks checkpointed, so the float
    kernel runs n_layers + 2 times in the forward and n_layers more in the
    backward."""
    from repro_torch.launch import graphcast_weather as GW
    from repro_torch.models.gnn import common as PC, graphcast
    from repro_torch.models.gnn.steps import value_and_grad

    cfg = get_smoke("graphcast")
    params = graphcast.init_weather_params(cfg, 0, device="cpu")
    outs = []
    for dev, p in [(cuda, PC.params_to(params, cuda)), ("cpu", params),
                   ("cpu", PC.params_to(params, dtype=torch.float64))]:
        graph, layouts = GW.make_graph(cfg, dev)
        state, target = GW.example_data(cfg, dev)
        state = state.to(p["mesh_embed"].dtype)
        before = sk.float_launches
        with PC.plain_scatter() if p["mesh_embed"].dtype == torch.float64 else nullcontext():
            loss, grads = value_and_grad(GW.weather_loss, p, cfg, state, target, graph, layouts)
        if dev == cuda:
            assert sk.float_launches - before == 2 * cfg.n_layers + 2
        outs.append((loss, leaves(grads)))
    _hold(*(o[0] for o in outs))
    _hold(*(o[1] for o in outs))


def _gnn(arch):
    from repro_torch.models.gnn import common as PC, steps as PS

    cfg = get_smoke(arch)
    batch = PC.batch_molecules(6, 10, 20, 4, seed=2)
    params = PS.init_params(cfg, 0, device="cpu")
    return cfg, PC, PS, batch, params


@pytest.mark.parametrize("arch", ["schnet", "egnn", "mace"])
def test_gnn_energy_on_the_card_matches_the_cpu(cuda, arch):
    """SMOKE weights on the card, the CPU and in float64 (plain scatter),
    float32 held by ``checks.hold``, bf16 (MACE) by ``checks.hold_bf16``;
    one float kernel launch a scatter."""
    cfg, PC, PS, batch, params = _gnn(arch)
    mod = PS.model_module(cfg)
    before = sk.float_launches
    with torch.no_grad():
        card = mod.energy(PC.params_to(params, cuda), cfg, PC.batch_to(batch, cuda), 6)
        torch.cuda.synchronize()
        launched = sk.float_launches - before
        cpu = mod.energy(params, cfg, PC.batch_to(batch, "cpu"), 6)
        with PC.plain_scatter():
            f64 = mod.energy(PC.params_to(params, dtype=torch.float64), cfg,
                             PC.batch_to(batch, "cpu"), 6)
    assert launched == {"schnet": 3, "egnn": 5, "mace": 7}[arch]
    if arch == "mace":
        assert checks.hold_bf16(card, cpu, f64)["ok"]
    else:
        _hold(card, cpu, f64)


@pytest.mark.parametrize("arch", ["graphcast", "mace"])
def test_gnn_bf16_node_embeddings_on_the_card(cuda, arch):
    cfg, PC, PS, batch, params = _gnn(arch)
    mod = PS.model_module(cfg)
    with torch.no_grad():
        card = mod.node_embeddings(PC.params_to(params, cuda), cfg, PC.batch_to(batch, cuda))
        cpu = mod.node_embeddings(params, cfg, PC.batch_to(batch, "cpu"))
        with PC.plain_scatter():
            f64 = mod.node_embeddings(PC.params_to(params, dtype=torch.float64), cfg,
                                      PC.batch_to(batch, "cpu"))
    r = checks.hold_bf16(card, cpu, f64)
    assert r["ok"], r


def test_weather_rollout_on_the_card_matches_the_cpu(cuda):
    from repro_torch.launch import graphcast_weather as GW
    from repro_torch.models.gnn import common as PC, graphcast

    cfg = get_smoke("graphcast")
    params = graphcast.init_weather_params(cfg, 0, device="cpu")
    outs = []
    for dev, p, dtype in [(cuda, PC.params_to(params, cuda), torch.float32),
                          ("cpu", params, torch.float32),
                          ("cpu", PC.params_to(params, dtype=torch.float64), torch.float64)]:
        graph, layouts = GW.make_graph(cfg, dev)
        before = sk.float_launches
        with PC.plain_scatter() if dtype == torch.float64 else torch.no_grad():
            outs.append(GW.rollout(p, cfg, GW.initial_state(cfg, dev).to(dtype), graph, layouts,
                                   3).state)
        if dev == cuda:
            assert sk.float_launches - before == 3 * (cfg.n_layers + 2)
    _hold(*outs)


# ------------------------------ LM training ------------------------------- #

def _lm_step(cfg, params, tokens, labels, dtype=torch.bfloat16):
    from repro_torch.models.autodiff import value_and_grad
    from repro_torch.models.transformer import model as M

    return value_and_grad(lambda p: M.lm_loss(p, cfg, tokens, labels, dtype=dtype), params)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-34b", "granite-34b", "qwen2-moe-a2.7b",
                                  "mixtral-8x22b"])
def test_lm_gradient_on_the_card_matches_the_cpu(cuda, arch):
    """The SMOKE LMs' loss and gradient on the card against the CPU bf16
    route and a float32 evaluation on the card (``checks.hold_bf16``, leaf by
    leaf but ``bk``, whose exact gradient is 0); one float kernel launch, the
    embedding gather's backward, and one a layer for an MoE model, the
    dispatch's backward."""
    from repro_torch.data import synth_lm_batch
    from repro_torch.models.transformer import model as M

    cfg = get_smoke(arch)
    params = M.init_params(cfg, 0, device="cpu")
    t, lab = (torch.from_numpy(a) for a in synth_lm_batch(cfg.vocab, 4, 48, seed=0, step=0))
    before = sk.float_launches
    card = _lm_step(cfg, M.params_to(params, cuda), t.to(cuda), lab.to(cuda))
    assert sk.float_launches - before == 1 + (cfg.n_layers if cfg.moe else 0)
    plain = _lm_step(cfg, params, t, lab)
    exact = _lm_step(cfg, M.params_to(params, cuda), t.to(cuda), lab.to(cuda), torch.float32)
    assert checks.hold_bf16(card[0], plain[0], exact[0])["ok"]
    for path, a, b, c in zip(_flat(card[1]), leaves(card[1]), leaves(plain[1]),
                             leaves(exact[1])):
        if "bk" not in path:
            assert checks.hold_bf16(a, b, c)["ok"], path


def _flat(tree, prefix=""):
    return [p for k in sorted(tree) for p in (_flat(tree[k], f"{prefix}/{k}")
                                              if isinstance(tree[k], dict) else [f"{prefix}/{k}"])]


def test_lm_embedding_backward_on_the_card_is_bit_equal_to_the_cpu(cuda):
    """The gather's backward on the float kernel adds each row's terms in
    token order (its hot row is under a stretch), as the plain version does
    on the CPU: bit-equal to the CPU, Zipf tokens with a hot row among
    them."""
    from repro_torch.data import synth_lm_batch
    from repro_torch.models.transformer import model as M

    tokens = torch.from_numpy(synth_lm_batch(4096, 8, 256, seed=0, step=0)[0])
    r = np.random.default_rng(1)
    table = torch.from_numpy(r.standard_normal((4096, 96)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((8, 256, 96)).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_(True)
        before = sk.float_launches
        M._EmbedGather.apply(t, tokens.to(dev)).backward(g.to(dev))
        assert sk.float_launches - before == (1 if dev == cuda else 0)
        grads.append(t.grad.cpu())
    assert torch.equal(*grads)


def test_lm_embedding_backward_with_a_hot_row_of_several_stretches(cuda):
    """The same at 8 x 4,096 Zipf tokens, whose hottest row is wider than a
    stretch: its partials are added in stretch order on the card as on the
    CPU, so the two stay bit-equal, and a second call gives the same bits."""
    from repro_torch.data import synth_lm_batch
    from repro_torch.models.transformer import model as M

    tokens = torch.from_numpy(synth_lm_batch(4096, 8, 4096, seed=0, step=0)[0])
    assert int(torch.bincount(tokens.reshape(-1)).max()) > sk.STRETCH
    r = np.random.default_rng(2)
    table = torch.from_numpy(r.standard_normal((4096, 96)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((8, 4096, 96)).astype(np.float32))
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_(True)
        before = sk.float_launches
        M._EmbedGather.apply(t, tokens.to(dev)).backward(g.to(dev))
        assert sk.float_launches - before == (1 if dev == cuda else 0)
        grads.append(t.grad.cpu())
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


def test_lm_driver_restart_on_the_card_is_bit_exact(cuda, tmp_path):
    """The SMOKE LM through ``TrainDriver`` on the card: fail at step 3 after
    the checkpoint of step 2, relaunch, finish step 4; every leaf of the
    state and every logged loss equal an uninterrupted run's."""
    from repro_torch.launch import train
    from repro_torch.runtime import HostFailure, TrainDriver, TrainDriverConfig, \
        make_failure_injector

    cfg = get_smoke("qwen1.5-0.5b")

    def driver(ckdir, fail_at=None):
        return TrainDriver(train.make_step_fn(cfg, 4), train.make_state(cfg, 0, cuda),
                           train.make_batch_fn(cfg.vocab, 4, 64, 0, cuda),
                           TrainDriverConfig(total_steps=4, checkpoint_every=2,
                                             checkpoint_dir=str(ckdir), log_every=1),
                           failure_injector=make_failure_injector(fail_at) if fail_at else None)

    ref = driver(tmp_path / "ref")
    want = ref.run()
    first = driver(tmp_path / "fail", 3)
    with pytest.raises(HostFailure):
        first.run()
    second = driver(tmp_path / "fail")
    second.run()
    assert [m["loss"] for m in first.metrics_log[:2] + second.metrics_log] == \
        [m["loss"] for m in want["metrics"]]
    for a, b in zip(leaves(second.state), leaves(ref.state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


def test_lm_trained_weights_served_on_the_flash_kernel(cuda):
    """Weights after 3 card steps, served through prefill on the flash
    kernel: the last position's logits against ``forward_hidden``'s by the
    bf16 rule against a float32 evaluation; one flash launch a layer."""
    from repro_torch.data import synth_lm_batch
    from repro_torch.models.transformer import model as M, steps as S
    from repro_torch.optim import AdamWConfig

    cfg = get_smoke("qwen1.5-0.5b")
    params = M.init_params(cfg, 0, device=cuda)
    opt = adamw_init(params)
    step = S.make_train_step(cfg, AdamWConfig(lr=3e-3, weight_decay=0.0), total_steps=3)
    for i in range(3):
        t, lab = (torch.from_numpy(a).to(cuda) for a in synth_lm_batch(cfg.vocab, 4, 64, seed=0,
                                                                       step=i))
        params, opt, _ = step(params, opt, t, lab)
    prompts = torch.from_numpy(synth_lm_batch(cfg.vocab, 2, 96, seed=0, step=9)[0]).long().to(cuda)
    before = fa.launches
    served = serve.generate(params, cfg, prompts, 1).prefill_logits
    assert fa.launches - before == cfg.n_layers
    with torch.no_grad():
        h, _ = M.forward_hidden(params, cfg, prompts)
        ref = M.logits_from_hidden(params, cfg, h[:, -1:])[:, 0].float()
        h, _ = M.forward_hidden(params, cfg, prompts, dtype=torch.float32)
        exact = M.logits_from_hidden(params, cfg, h[:, -1:])[:, 0]
    assert checks.hold_bf16(served, ref, exact)["ok"]


def test_train_launcher_on_the_card_profiles_a_step(cuda, tmp_path, capsys):
    """``launch.train`` at SMOKE on the card: the reference's line last, the
    card's line before it, and ``--profile``'s record of one more step."""
    from repro_torch.launch import train

    train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "10", "--batch", "2", "--seq",
                "64", "--ckpt-dir", str(tmp_path), "--profile"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("arch=qwen1.5-0.5b-smoke steps=10 loss: ")
    assert lines[-2].startswith("device: ") and "peak device memory" in lines[-2]
    assert lines[0].startswith("one more step at 2 x 64: wall ") and "kernel launches" in lines[0]


# --------------------------- MoE and the window --------------------------- #

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b"])
def test_moe_block_on_the_card_matches_the_cpu(cuda, arch):
    """The SMOKE MoE block from the same weights and input: the routing
    (experts, slots, kept selections) equal to the CPU's, the output by the
    bf16 rule against a float32 evaluation on the card."""
    from repro_torch.models.transformer import model as M

    from repro_torch.tree import map_tree

    cfg = get_smoke(arch)
    lp = map_tree(lambda v: v[0], M.cast_params(M.init_params(cfg, 0, device="cpu"))["layers"]
                  ["moe"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 48, cfg.d_model))
                         .astype(np.float32)).bfloat16()
    outs, routes = [], []
    for dev, dtype in [(cuda, torch.bfloat16), (torch.device("cpu"), torch.bfloat16),
                       (cuda, torch.float32)]:
        p = map_tree(lambda v: v.to(dev, v.dtype if dtype == torch.bfloat16 else dtype), lp)
        outs.append(M.moe_block(x.to(dev, dtype), p, cfg, routes)[0])
    for k in ("gate_i", "pos", "keep"):
        assert torch.equal(routes[0][k].cpu(), routes[1][k]), k
    assert checks.hold_bf16(*outs)["ok"]


def test_moe_dispatch_backward_on_the_card_is_bit_equal_to_the_cpu(cuda):
    """The dispatch's backward on the float kernel adds each token's slot
    rows in selection order, as the plain version does on the CPU: bit-equal
    to the CPU, with dropped selections and a virtual split; one launch."""
    import dataclasses

    from repro_torch.models.transformer import model as M

    base = get_smoke("mixtral-8x22b")
    moe = dataclasses.replace(base.moe, capacity_factor=0.5)
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((2, 64, base.d_model)).astype(np.float32)).bfloat16()
    router = torch.from_numpy(r.standard_normal((base.d_model, moe.e_pad)).astype(np.float32))
    C = M.moe_capacity(64, moe)
    g = torch.from_numpy(r.standard_normal((moe.n_experts * moe.virtual_split, 2 * C,
                                            base.d_model)).astype(np.float32)).bfloat16()
    grads = []
    for dev in (cuda, torch.device("cpu")):
        _, _, gate_i, pos = M.moe_route(x.to(dev), router.to(dev), moe)
        a = x.to(dev).requires_grad_(True)
        buf, _, keep = M.moe_dispatch(a, gate_i, pos, moe, C)
        assert not keep.all()
        before = sk.float_launches
        buf.backward(g.to(dev))
        assert sk.float_launches - before == (1 if dev == cuda else 0)
        grads.append(a.grad.cpu())
    assert torch.equal(*grads)


def test_windowed_serving_past_the_roll_on_the_card_matches_the_cpu(cuda):
    """Mixtral's SMOKE (window 32) served at a prompt of 45 from the same
    weights: the cache rolls from the first decode step; prefill logits and 6
    teacher-forced steps by the LM rule against a float32 evaluation on the
    card; one flash launch a layer (the windowed prefill)."""
    from repro_torch.models.transformer import model as M

    cfg = get_smoke("mixtral-8x22b")
    f32 = M.init_params(cfg, 0, device="cpu")
    cpu_params = M.cast_params(f32)
    prompts = serve.make_prompts(cfg, 2, 45, torch.device("cpu"))
    fa.launches = 0
    card = serve.generate(M.params_to(cpu_params, cuda), cfg, prompts.to(cuda), 7,
                          keep_logits=True)
    assert fa.launches == cfg.n_layers
    plain = serve.generate(cpu_params, cfg, prompts, 7, forced=card.tokens, keep_logits=True)
    exact = serve.generate(M.params_to(f32, cuda), cfg, prompts.to(cuda), 7, forced=card.tokens,
                           keep_logits=True, dtype=torch.float32)
    for got, want, ref in zip([card.prefill_logits] + card.step_logits,
                              [plain.prefill_logits] + plain.step_logits,
                              [exact.prefill_logits] + exact.step_logits):
        assert checks.hold_bf16_noise(got, want, ref)["ok"]


def test_moe_weights_drawn_on_the_card(cuda):
    """``init_params(on_device=True)``: bf16 weights drawn a layer at a time
    on the card, the router and the norms float32, the same numbers from
    one seed twice, the reference's scales."""
    from repro_torch.models.transformer import model as M

    cfg = get_smoke("qwen2-moe-a2.7b")
    a = M.init_params(cfg, 3, dtype=torch.bfloat16, device=cuda, on_device=True)
    b = M.init_params(cfg, 3, dtype=torch.bfloat16, device=cuda, on_device=True)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    moe = a["layers"]["moe"]
    assert moe["router"].dtype == torch.float32 and a["layers"]["norm1"].dtype == torch.float32
    assert moe["w_up"].dtype == torch.bfloat16 and moe["w_up"].device.type == "cuda"
    assert float(moe["w_up"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert not torch.equal(moe["w_up"][0], moe["w_up"][1])


def test_a_real_build_is_counted_and_traced(cuda, tmp_path, monkeypatch):
    """nvcc for real into an empty build directory: ``compile_count`` and
    ``compile_seconds`` move with ``_build``'s counters, and the build under
    tracing is one ``kernel.build`` span."""
    from repro_torch.core import jit_telemetry
    from repro_torch.kernels import _build
    from repro_torch.obs import trace

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    c0, s0 = jit_telemetry.compile_count(), jit_telemetry.compile_seconds()
    trace.reset()
    trace.enable()
    try:
        secs = _build.build_all(["kcore_hindex"])
        events = trace.events()
    finally:
        trace.disable()
        trace.reset()
    assert jit_telemetry.compile_count() - c0 == 1 == _build.build_count() - c0
    assert jit_telemetry.compile_seconds() - s0 == pytest.approx(secs["kcore_hindex"])
    assert secs["kcore_hindex"] > 0
    assert [e["args"]["kernels"] for e in events if e["name"] == "kernel.build"] == ["kcore_hindex"]
    assert "sm_90a" in _build.ptxas_log("kcore_hindex")


def test_dryrun_cell_on_the_card_equals_its_meta_count(cuda):
    """``dryrun --run`` of a DIN cell: the count on the card equals the meta
    count, the bag's booked calls its launches, the share at most 1."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("din", "serve_p99", save=False, run=True)
    run = rec["run"]
    assert rec["status"] == "OK" and run["status"] == "OK", rec
    assert run["same_count_as_meta"] and run["bookings_equal_launches"]
    assert run["launches"] == {"embedding_bag": 1}
    assert 0 < run["roofline_share"] <= 1
    assert rec["memory"]["fits_card"] is True


def test_a_checkpoint_recompute_in_the_backward_is_booked(cuda):
    """On the card the backward runs on the autograd engine's thread: a
    checkpointed float segment sum recomputed there is booked as often as it
    is launched."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.launch.step_cost import StepCounter

    lay = sk.segment_layout(torch.tensor([0, 0, 2, 3, 3, 3], device=cuda), 4)
    vals = torch.randn(6, 8, device=cuda, requires_grad=True)
    counter, before = StepCounter(), sk.float_launches
    with counter:
        checkpoint(lambda v: sk.segment_sum_float(v, lay).square().sum(), vals,
                   use_reentrant=False).backward()
    assert sk.float_launches - before == 2 == counter.by_kernel["segment_sum_float"]["calls"]


def test_launchers_on_the_card_name_it_first(cuda, capsys):
    from repro_torch.launch import paper_experiments, quickstart

    hk.launches = sk.launches = 0
    quickstart.main([])
    paper_experiments.main(["--graph", "EEN"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: ") and "Fig-1 cores :" in out[1]
    assert sum(line.startswith("device: ") for line in out) == 2
    assert "=== Table I row (EEN) ===" in out
    assert sk.launches > 0
