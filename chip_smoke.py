#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the paper's from-scratch k-core decomposition
(``repro_torch.launch.kcore_run``), whose superstep runs the two CUDA
kernels of ``src/repro_torch/kernels``. Phases, each of which must pass:

1. Card: the card's name and power limit, as ``nvidia-smi`` gives them.
2. Build: both kernels, for sm_90a, from the sources in this checkout, with
   the compiler's register and shared-memory report.
3. Kernel against plain: each kernel bit-equal to its plain PyTorch version
   on edge cases and at the main path's real shapes (every ELL bucket of
   the soc-pokec analogue, and the segment sum over its 59.7M arcs), with
   times from CUDA events beside the bytes bound and a library call.
4. The BZ-checked Table-I suite (EEN, G31, FC, PTBR, MGF at scale 0.05): host
   loop and fused on the card, cores equal to BZ, bills equal between the two,
   and ``benchmarks/static_baseline.json``'s message ratios reproduced.
5. The masked route (segment-sum binary search, no ELL) with the same bills.
6. Full size: ``snap_analogue("SPR", 1.0)`` through the CLI's entry point,
   fused and then host loop, equal to each other and to BZ, with the kernels'
   launch counters read around these runs only.
7. Flash attention against its plain version: the serve shape (bf16,
   B*H 128, S 2048, d 64, causal), a ragged S, GQA and MQA, a window, d 128,
   float32, Sq != Sk and rows masked everywhere, within 2e-2 (bf16) and
   2e-5 (float32); at the serve shape its time beside the plain version's,
   ``scaled_dot_product_attention``'s and the FLOP bound.
8. LM serving: ``qwen1.5-0.5b`` at full width (24 layers, d_model 1024,
   vocab 151,936; weights drawn from seed 0) through
   ``repro_torch.launch.serve.generate``: batch 8, prompt 2048, 32 tokens,
   with the flash kernel's launch counter read around that run only (24, one
   a layer of the prefill), and the same run once more under
   ``torch.profiler`` (``serve.profile_serve``: device busy and idle time,
   the costliest kernels). Then batch 1, prompt 128 on the card and on the
   CPU from the same weights, and in float32 on the CPU: the prefill logits
   and 4 teacher-forced decode steps of the card within ``tol`` of the CPU's
   and of the float32 evaluation, where ``tol`` is twice the CPU bf16
   route's own distance from the float32 evaluation (the bf16 model's
   rounding noise: two routes each that close to it are within twice that
   of each other), and at least two bf16 units in the last place of the
   largest logit.

It then prints the ``kernels`` JSON line and, last, the ``ok`` line. It exits
non-zero, without the ``ok`` line, if any check fails, if no CUDA device is
present, or if ``src/repro_torch`` is not beside it. It imports neither
``jax`` nor the reference package.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TABLE_I = ("EEN", "G31", "FC", "PTBR", "MGF")
TABLE_I_SCALE = 0.05
SPR_SCALE = 1.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
KERNEL_FILES = {
    "kcore_hindex": ("src/repro_torch/kernels/kcore_hindex/csrc/kcore_hindex.cu",
                     "src/repro/kernels/kcore_hindex/kernel.py:46"),
    "segment_sum": ("src/repro_torch/kernels/segment_sum/csrc/segment_sum.cu",
                    "src/repro/kernels/segment_sum/kernel.py:45"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:85"),
}
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor cores, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# tests/test_kernels.py:160's tolerances: a bf16 output ulp is 1.6e-2 in [2, 4) and the
# kernel rounds p to bf16 before PV, as the TPU kernel does; float32 rounds nothing narrower
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SERVE = {"arch": "qwen1.5-0.5b", "batch": 8, "prompt": 2048, "gen": 32, "seed": 0}

failures: list[str] = []


def check(cond: bool, what: str) -> bool:
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        failures.append(what)
    return cond


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, from CUDA
    events around the whole run (host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_err(torch, a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def flash_cases(torch, np, dev, st, small: bool = False) -> None:
    """Phase 7: the flash kernel against its plain version (``attention_ref``).
    ``small`` (the CPU rehearsal) cuts every length and window by 8."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa

    rng = np.random.default_rng(1)

    def qkv(B, Sq, Sk, Hq, Hkv, d, dtype):
        return [torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev).to(dtype)
                for shape in [(B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d)]]

    def plain(q, k, v, causal, window):
        B, Sq, Hq, d = q.shape
        _, Sk, Hkv, _ = k.shape
        out = fa.attention_ref(q.transpose(1, 2).reshape(B * Hq, Sq, d),
                               k.transpose(1, 2).reshape(B * Hkv, Sk, d),
                               v.transpose(1, 2).reshape(B * Hkv, Sk, d),
                               causal=causal, window=window)
        return out.reshape(B, Hq, Sq, d).transpose(1, 2)

    def pairs(Sq, Sk, causal, window):
        """(q, k) pairs the scores need: the unmasked ones, and all Sk keys of a
        row masked everywhere (it averages v over them)."""
        qp = torch.arange(Sq)[:, None]
        kp = torch.arange(Sk)[None, :]
        mask = torch.ones(Sq, Sk, dtype=torch.bool)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        seen = mask.sum(1)
        return int(torch.where(seen == 0, Sk, seen).sum())

    cases = [  # B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, label
        (8, 2048, 2048, 16, 16, 64, True, None, torch.bfloat16, "serve shape"),
        (2, 1000, 1000, 16, 16, 64, True, None, torch.bfloat16, "ragged S"),
        (2, 512, 512, 16, 8, 64, True, None, torch.bfloat16, "GQA rep 2"),
        (2, 512, 512, 16, 1, 64, True, None, torch.bfloat16, "MQA"),
        (2, 2048, 2048, 8, 8, 64, True, 256, torch.bfloat16, "window 256"),
        (2, 1024, 1024, 8, 2, 128, True, None, torch.bfloat16, "d 128, GQA rep 4"),
        (1, 777, 777, 8, 8, 128, False, 100, torch.bfloat16, "d 128, window, not causal"),
        (2, 512, 512, 8, 8, 64, True, None, torch.float32, "float32"),
        (1, 300, 300, 4, 2, 128, True, 64, torch.float32, "float32 d 128, window"),
        (2, 512, 1024, 16, 16, 64, False, None, torch.bfloat16, "Sq < Sk"),
        (2, 1024, 384, 16, 16, 64, True, None, torch.bfloat16, "Sq > Sk"),
        (1, 600, 200, 16, 4, 64, True, 64, torch.bfloat16, "rows masked everywhere"),
        (1, 300, 100, 4, 4, 64, True, 32, torch.float32, "float32, rows masked everywhere"),
    ]
    for B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, label in cases:
        if small:
            Sq, Sk, window = Sq // 8, Sk // 8, window and window // 8
        q, k, v = qkv(B, Sq, Sk, Hq, Hkv, d, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = plain(q, k, v, causal, window)
        err = float((got.float() - want.float()).abs().max())
        key = "err" if dtype == torch.bfloat16 else "err_f32"
        st[key] = max(st[key], err)
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        msg = (f"flash_attention {label}: B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} d={d} "
               f"causal={causal} window={window} {str(dtype).split('.')[1]}: max|err| {err:.3g} "
               f"< {tol}")
        ok = err < tol and bool(torch.isfinite(got).all())
        if "masked everywhere" in label:
            first = Sk + window - 1
            mean_v = v.float().mean(dim=1).repeat_interleave(Hq // Hkv, dim=1)   # (B, Hq, d)
            row_err = float((got[:, first:].float() - mean_v[:, None]).abs().max())
            msg += f"; rows >= {first} are the mean of v (max|err| {row_err:.3g})"
            ok = ok and row_err < tol
        if label == "serve shape":
            flop = 4 * B * Hq * d * pairs(Sq, Sk, causal, window)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bnd = max(flop / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), 20)
            plain_ms = time_ms(torch, lambda: plain(q, k, v, True, None), 3, warmup=1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                          20)
            lib_err = float((F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                             .transpose(1, 2).float() - want.float()).abs().max())
            st.update(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd)
            msg += (f"; {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                    f"scaled_dot_product_attention {lib:.4f} ms (its max|err| {lib_err:.3g}), "
                    f"bound {bnd:.4f} ms ({flop:.4g} FLOP, {nbytes} bytes), {bnd / ms:.1%} of it")
        check(ok, msg)
        del q, k, v, got, want


def serve_full_width(torch, dev, small: bool = False) -> int:
    """Phase 8: serve the full-width model on the card through the serve loop,
    then hold the card's route against the CPU's plain route at batch 1.
    Returns the flash kernel's launches in the measured serve run. ``small``
    (the CPU rehearsal) serves the SMOKE config at a short prompt instead."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models.transformer.model import cast_params, init_params, params_to

    cfg = (get_smoke if small else get_config)(SERVE["arch"])
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    f32_params = init_params(cfg, SERVE["seed"], device=cpu)
    cpu_params = cast_params(f32_params)
    params = params_to(cpu_params, dev)
    n_params = sum(t.numel() for t in params["layers"]["attn"].values()) \
        + sum(t.numel() for t in params["layers"]["mlp"].values()) + params["embed"].numel()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads} "
          f"(kv {cfg.n_kv_heads}), d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params} weights drawn and cast to bf16 in {time.perf_counter() - t0:.1f} s")
    B, P, G = SERVE["batch"], SERVE["prompt"] // (16 if small else 1), SERVE["gen"]
    prompts = serve.make_prompts(cfg, B, P, dev)
    serve.generate(params, cfg, prompts, 2)          # warm-up: cuBLAS handles, the allocator
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = 0
    res = serve.generate(params, cfg, prompts, G)
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    wall = res.prefill_s + res.decode_s
    print(f"  prefill {res.prefill_s * 1e3:.3f} ms ({B * P / res.prefill_s:.1f} prompt tok/s); "
          f"decode {res.decode_ms_per_token:.3f} ms per token ({B * (G - 1) / res.decode_s:.1f} "
          f"tok/s over {G - 1} steps); {B * G / wall:.1f} tok/s end to end ({wall:.3f} s); "
          f"peak device memory {peak} bytes; flash launches {launches}")
    print(f"  sample: {res.tokens[0][:12].tolist()}")
    if dev.type == "cuda":
        prof = serve.profile_serve(params, cfg, prompts, min(G, 9))
        print("  under torch.profiler (same shapes, after the measured run; 8 decode steps):")
        print("\n".join("    " + line for line in serve.format_profile(prof).splitlines()))
    logits = res.prefill_logits
    check(res.tokens.shape == (B, G) and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
          and tuple(logits.shape) == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"served {B} x {G} tokens in range, prefill logits ({B}, {cfg.vocab}) finite")
    if dev.type == "cuda":
        check(launches == cfg.n_layers,
              f"the prefill launched the flash kernel once a layer ({launches} == {cfg.n_layers})")
    del res, logits, prompts

    # the card's route against the CPU's plain route, from the same weights, and
    # both against a float32 evaluation of those weights
    prompt1 = serve.make_prompts(cfg, 1, 128, cpu)
    card = serve.generate(params, cfg, prompt1.to(dev), 5, keep_logits=True)
    t0 = time.perf_counter()
    plain = serve.generate(cpu_params, cfg, prompt1, 5, forced=card.tokens, keep_logits=True)
    exact = serve.generate(f32_params, cfg, prompt1, 5, forced=card.tokens, keep_logits=True,
                           dtype=torch.float32)
    print(f"  batch 1, prompt 128 on the CPU in bf16 and in float32 (plain versions) in "
          f"{time.perf_counter() - t0:.1f} s")

    def dist(a, b):
        return float((a.cpu().float() - b.cpu().float()).abs().max())

    for i, (got, want, ref) in enumerate(zip([card.prefill_logits] + card.step_logits,
                                             [plain.prefill_logits] + plain.step_logits,
                                             [exact.prefill_logits] + exact.step_logits)):
        top = float(ref.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        noise = dist(want, ref)
        tol = max(2 * noise, 2 * ulp)
        err, err32 = dist(got, want), dist(got, ref)
        check(err <= tol and err32 <= tol,
              f"{'prefill' if i == 0 else f'decode step {i}'} logits in bf16 ulps of max|logit| "
              f"{top:.4g}: card vs CPU {err / ulp:.2f}, card vs float32 {err32 / ulp:.2f}, "
              f"CPU vs float32 {noise / ulp:.2f}; tolerance {tol / ulp:.2f}")
    del params, cpu_params, f32_params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def main(device: str = "cuda", spr_scale: float = SPR_SCALE) -> int:
    import numpy as np
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this needs an NVIDIA card")
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} is missing: run from a checkout of the repo")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dispatch
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import _bs_iters, kcore_decompose
    from repro_torch.core.messages import work_bound
    from repro_torch.core.runtime import fused_converge_dense
    from repro_torch.graph import build_ell, generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.kcore_hindex import ops as hk
    from repro_torch.kernels.segment_sum import ops as sk
    from repro_torch.launch import kcore_run
    from repro_torch.platform import device_summary, nvidia_smi_line

    t_start = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    stats = {name: {"err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
             for name in KERNEL_FILES}
    stats["flash_attention"].update(err=0.0, err_f32=0.0, bound_by="operations")

    # ------------------------------------------------------------------ #
    phase("1. card")
    smi = nvidia_smi_line()
    print(smi if smi else "nvidia-smi: unavailable")
    card = device_summary(dev)
    kind, count = card["name"], card["count"]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind!r}, "
          f"count {count}, power limit {card['power_limit']}")
    if device == "cuda":
        check(smi is not None, "nvidia-smi reports the card")

    # ------------------------------------------------------------------ #
    phase("2. build")
    if device == "cuda":
        t0 = time.perf_counter()
        secs = _build.build_all()
        print(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s wall "
              f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})")
        for name in KERNEL_FILES:
            for line in _build.ptxas_log(name).splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
            check("sm_90a" in _build.ptxas_log(name), f"{name} compiled for sm_90a")

    # the main path's graph, made once and used by phases 3 and 6
    t0 = time.perf_counter()
    g = generators.snap_analogue("SPR", spr_scale, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = build_ell(g)
    t_ell = time.perf_counter() - t0
    t0 = time.perf_counter()
    core_bz = bz_core_numbers(g)
    t_bz = time.perf_counter() - t0
    print(f"SPR analogue at scale {spr_scale}: n={g.n} m={g.m} arcs={g.num_arcs} "
          f"max_deg={g.max_deg} isolated={int((g.deg == 0).sum())} max_core={int(core_bz.max())}; "
          f"generated in {t_gen:.1f} s, ELL in {t_ell:.1f} s "
          f"({ell.padded_slots} slots), BZ in {t_bz:.1f} s")

    # ------------------------------------------------------------------ #
    phase("3. kernels against their plain versions")

    def hindex_case(nbr, est_u, n_iters, label, timed=False):
        got = hk.hindex_rows(nbr, est_u, n_iters)
        want = hk.hindex_rows_ref(nbr, est_u, n_iters)
        err = max_err(torch, got, want)
        st = stats["kcore_hindex"]
        st["err"] = max(st["err"], err)
        msg = f"kcore_hindex {label} R={nbr.shape[0]} W={nbr.shape[1]} n_iters={n_iters} bit-equal"
        if timed:
            reps = max(3, min(200, int(2e9 // max(nbr.numel() * 4, 1))))
            ms = time_ms(torch, lambda: hk.hindex_rows(nbr, est_u, n_iters), reps)
            plain = time_ms(torch, lambda: hk.hindex_rows_ref(nbr, est_u, n_iters), 3, warmup=1)
            bnd = bound_ms(4 * nbr.numel() + 8 * nbr.shape[0])
            st["ms"] += ms
            st["plain_ms"] += plain
            st["bound_ms"] += bnd
            msg += f": {ms:.4f} ms (plain {plain:.3f} ms, bound {bnd:.4f} ms, {bnd / ms:.1%} of it)"
        check(err == 0, msg)

    def ints(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.int32), device=dev)

    for rows, width, hi, n_iters in [(1, 8, 50, 7), (1001, 8, 50, 7), (130, 17, 50, 7),
                                     (64, 32, 50, 3), (77, 2048, 3000, 13), (5, 2049, 3000, 13),
                                     (3, 98432, 100000, 18), (40, 600, 50, 2)]:
        hindex_case(ints(0, hi, (rows, width)), ints(0, hi, rows), n_iters, "edge case")
    nbr = ints(0, 50, (33, 128))
    hindex_case(nbr, torch.zeros(33, dtype=torch.int32, device=dev), 7, "zero estimates")
    hindex_case(torch.zeros((9, 8), dtype=torch.int32, device=dev), ints(0, 9, 9), 5, "zero tiles")

    n_iters = _bs_iters(g.max_deg)
    deg_t = torch.as_tensor(g.deg, device=dev)
    tiles = dispatch._stage_ell(ell, dev)
    for est_name, est in [("degree seed", deg_t), ("cores", torch.as_tensor(core_bz, device=dev))]:
        est_ext = torch.cat([est, est.new_zeros(1)])
        for t in tiles:
            nbr_est = est_ext.index_select(0, t.nbrs).view(t.rows, t.width)
            hindex_case(nbr_est, est.index_select(0, t.ids), n_iters,
                        f"SPR bucket, {est_name},", timed=est_name == "degree seed")
            del nbr_est

    def segsum_case(vals, row_ptr, label, timed=False, seg_ids=None):
        got = sk.segment_sum(vals, row_ptr)
        want = sk.segment_sum_ref(vals, row_ptr)
        err = max_err(torch, got, want)
        st = stats["segment_sum"]
        st["err"] = max(st["err"], err)
        n = row_ptr.numel() - 1
        msg = f"segment_sum {label} E={vals.numel()} n={n} bit-equal"
        if timed:
            ms = time_ms(torch, lambda: sk.segment_sum(vals, row_ptr), 50)
            plain = time_ms(torch, lambda: sk.segment_sum_ref(vals, row_ptr), 5)
            lib = time_ms(torch, lambda: torch.zeros(n, dtype=torch.int32, device=dev)
                          .index_add_(0, seg_ids, vals), 20)
            bnd = bound_ms(4 * vals.numel() + 8 * (n + 1) + 4 * n)
            st.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd)
            msg += f": {ms:.4f} ms (plain {plain:.3f} ms, index_add_ {lib:.4f} ms, " \
                   f"bound {bnd:.4f} ms, {bnd / ms:.1%} of it)"
        check(err == 0, msg)

    for e, n in [(1, 17), (0, 5), (33, 1), (1000, 10), (100_001, 70_000), (1_000_000, 3)]:
        layout = sk.csr_layout(np.sort(rng.integers(0, n, e)), n)
        segsum_case(ints(-2**31, 2**31, e), torch.as_tensor(layout.row_ptr, device=dev),
                    "edge case (wrapping sums, empty rows)")
    ids = rng.integers(0, 1000, 5000)
    layout = sk.csr_layout(ids, 1000)
    vals = ints(0, 2**20, 5000)
    got = sk.segment_sum(vals.index_select(0, torch.as_tensor(layout.order, device=dev)),
                         torch.as_tensor(layout.row_ptr, device=dev))
    lib = torch.zeros(1000, dtype=torch.int32, device=dev).index_add_(
        0, torch.as_tensor(ids, device=dev), vals)
    check(torch.equal(got, lib), "segment_sum over unsorted ids (csr_layout) equals index_add_")
    src64 = torch.as_tensor(g.src.astype(np.int64), device=dev)
    spr_vals = ints(0, 2, g.num_arcs)
    segsum_case(spr_vals, torch.as_tensor(g.offsets, device=dev), "SPR arcs", timed=True,
                seg_ids=src64)
    del src64, spr_vals

    # ------------------------------------------------------------------ #
    phase(f"4. BZ-checked Table-I suite at scale {TABLE_I_SCALE}, host loop and fused")
    baseline = json.loads((ROOT / "benchmarks" / "static_baseline.json").read_text())["mean_ratio"]
    een = None
    for abbrev in TABLE_I:
        ga = generators.snap_analogue(abbrev, TABLE_I_SCALE, seed=0)
        bz = bz_core_numbers(ga)
        host = kcore_decompose(ga, device=dev)
        fused = kcore_decompose(ga, fused=True, device=dev)
        ratio = round(host.stats.total_messages / max(work_bound(ga, host.core), 1), 4)
        same = host.rounds == fused.rounds and all(
            np.array_equal(getattr(host.stats, k), getattr(fused.stats, k))
            for k in ("messages_per_round", "active_per_round", "changed_per_round"))
        print(f"  {abbrev}: n={ga.n} m={ga.m} rounds={host.rounds} "
              f"messages={host.stats.total_messages} ratio={ratio} (baseline {baseline[abbrev]}); "
              f"host {host.phase_s['converge'] * 1e3 / host.rounds:.3f} ms/round, fused "
              f"{fused.phase_s['device-converge'] * 1e3 / fused.rounds:.3f} ms/round")
        check(np.array_equal(host.core, bz) and np.array_equal(fused.core, bz),
              f"{abbrev} cores equal BZ (host loop and fused)")
        check(same and host.converged and fused.converged,
              f"{abbrev} host loop and fused agree on rounds and per-round bills")
        check(ratio == baseline[abbrev], f"{abbrev} messages/work bound {ratio} == {baseline[abbrev]}")
        if abbrev == "EEN":
            een = (ga, host)

    # ------------------------------------------------------------------ #
    phase("5. masked route (segment-sum binary search, no ELL) on EEN")
    ga, host = een
    hk.launches = sk.launches = 0
    out = fused_converge_dense(ga.deg, np.ones(ga.n, bool), ga.src, ga.dst,
                               np.ones(ga.num_arcs, bool), ga.deg, n=ga.n,
                               n_iters=_bs_iters(ga.max_deg), max_rounds=ga.n + 1,
                               device=dev, ell=None)
    print(f"  rounds={out.rounds} launches: segment_sum {sk.launches}, kcore_hindex {hk.launches}")
    check(np.array_equal(out.est, host.core) and out.rounds == host.rounds
          and np.array_equal(out.msgs, host.stats.messages_per_round[1:])
          and np.array_equal(out.changed, host.stats.changed_per_round[1:])
          and np.array_equal(out.recv[:-1], host.stats.active_per_round[2:]),
          "masked route: cores, rounds and bills equal the ELL route's")
    if device == "cuda":
        check(sk.launches > 0 and hk.launches == 0,
              "masked route ran on the segment_sum kernel alone")

    # ------------------------------------------------------------------ #
    phase(f"6. full size: SPR at scale {spr_scale} through kcore_run, fused then host loop")
    runs = {}
    launches = {"kcore_hindex": 0, "segment_sum": 0}
    for label, argv in [("fused", ["--fused"]), ("host loop", [])]:
        args = kcore_run.parse_args(["--graph", "SPR", "--scale", str(spr_scale),
                                     "--device", device, "--json", *argv])
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        hk.launches = sk.launches = 0
        report, res = kcore_run.decompose_report(g, args, core_ref=core_bz)
        launches["kcore_hindex"] += hk.launches
        launches["segment_sum"] += sk.launches
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        runs[label] = res
        conv_s = res.phase_s.get("device-converge", res.phase_s.get("converge", 0.0))
        print(f"  {label}: n={report['n']} m={report['m']} rounds={report['rounds']} "
              f"total_messages={report['total_messages']} converged={report['converged']} "
              f"wall_s={report['wall_s']} phase_s={report['phase_s']} "
              f"ms/round={conv_s * 1e3 / max(res.rounds, 1):.3f} peak_bytes={peak} "
              f"launches: kcore_hindex {hk.launches}, segment_sum {sk.launches}")
        check(report["correct_vs_BZ"] and report["converged"], f"SPR {label}: cores equal BZ")
        if device == "cuda":
            check(hk.launches > 0 and sk.launches > 0, f"SPR {label} launched both kernels")
    fused, host = runs["fused"], runs["host loop"]
    check(np.array_equal(fused.core, host.core) and fused.rounds == host.rounds and all(
        np.array_equal(getattr(fused.stats, k), getattr(host.stats, k))
        for k in ("messages_per_round", "active_per_round", "changed_per_round")),
        "SPR fused and host loop agree on cores, rounds and per-round bills")

    # where one superstep's time goes, at the degree seed
    plan = dispatch.resolve_plan(dev)
    body = dispatch.masked_round_program(g.n, n_iters, plan, g.src, g.dst, ell=ell)
    live = torch.ones(g.num_arcs, dtype=torch.bool, device=dev)
    everyone = torch.ones(g.n, dtype=torch.bool, device=dev)
    round_ms = time_ms(torch, lambda: body(deg_t, live, everyone), 5)
    ext = torch.cat([deg_t, deg_t.new_zeros(1)])
    gather_ms = time_ms(torch, lambda: [ext.index_select(0, t.nbrs) for t in tiles], 5)
    print(f"  one superstep at the degree seed: {round_ms:.3f} ms, of which ELL gathers "
          f"{gather_ms:.3f} ms, kcore_hindex {stats['kcore_hindex']['ms']:.3f} ms, "
          f"segment_sum {stats['segment_sum']['ms']:.3f} ms")

    del body, live, everyone, ext, tiles, deg_t, runs, fused, host, g, ell
    # ------------------------------------------------------------------ #
    phase("7. flash_attention against its plain version")
    flash_cases(torch, np, dev, stats["flash_attention"], small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase(f"8. serve {SERVE['arch']} at full width: batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt']}, {SERVE['gen']} tokens")
    launches["flash_attention"] = serve_full_width(torch, dev, small=device != "cuda")

    # ------------------------------------------------------------------ #
    phase("9. kernels")
    kernels = []
    for name, (source, replaces) in KERNEL_FILES.items():
        st = stats[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": st["err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st.get("bound_by", "bytes"), "library_ms": st["library_ms"],
            "check": "bit-equal to plain" if st["err"] == 0 else "MISMATCH",
        }
        if name == "flash_attention":
            ok = st["err"] < FLASH_TOL["bfloat16"] and st["err_f32"] < FLASH_TOL["float32"]
            entry.update(max_abs_err_f32=st["err_f32"], tolerance=FLASH_TOL,
                         check="within tolerance of plain" if ok else "MISMATCH")
        kernels.append(entry)
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s")
    if failures:
        print(f"FAILED {len(failures)} check(s):")
        for f in failures:
            print(f"  {f}")
        return 1
    print(smi if smi else "nvidia-smi: unavailable")
    print(json.dumps({"kernels": kernels}))
    if device != "cuda":
        print("rehearsal on the CPU: no result")
        return 3
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
