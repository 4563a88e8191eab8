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

It then prints the ``kernels`` JSON line and, last, the ``ok`` line. It exits
non-zero, without the ``ok`` line, if any check fails, if no CUDA device is
present, or if ``src/repro_torch`` is not beside it. It imports neither
``jax`` nor the reference package.
"""

from __future__ import annotations

import json
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
}

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

    # ------------------------------------------------------------------ #
    phase("7. kernels")
    kernels = []
    for name, (source, replaces) in KERNEL_FILES.items():
        st = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": st["err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": "bytes",
            "library_ms": st["library_ms"],
            "check": "bit-equal to plain" if st["err"] == 0 else "MISMATCH",
        })
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
