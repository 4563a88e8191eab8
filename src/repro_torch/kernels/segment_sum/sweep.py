"""Time the float segment-sum kernel of this source on the card, at the main
path's shapes, beside other sources of it built in the same call:
``--variant`` sources with this one's entry points (another design of the
kernel on the same work table) and ``--parent``, an earlier source with the
one-group-a-row entry points (vals, ld, order, row_ptr, out, n, F, stream);
and beside ``index_add_``.

    python -m repro_torch.kernels.segment_sum.sweep [--variant OTHER.cu ...]
        [--parent OLD.cu] [--shapes widest ...] [--reps 20] [--json OUT]

Every source is one nvcc build (all started at once). For every shape each
variant must give the bits of this source's build, and on the smaller
shapes those bits must equal the plain version's on the CPU. Times: CUDA
events over ``--reps`` back-to-back calls, after a warm-up ("a call"), the
device time of the same calls in a ``torch.profiler`` trace, and the bytes
bound E F s + 8E + 8(n + 1) + n F s at 3.35 TB/s. The shapes are those of
``chip_smoke.py`` phases 22a, 24b and 25d: the widest SPR row alone at
MACE's a2 width, MACE's a2 scatter of one SPR chunk, the LM embedding's
backward at 8 x 4,096 and its hottest row, GraphCast weather's ``mm``
scatter, Mixtral's MoE dispatch backward at 1 x 9,216. It needs a card and
generates SPR at scale 1.0 (about 100 s) when a shape needs it. Rounds run
in turns (each build once, then again in reverse), so a drift of the card
falls on every build alike.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum import ops as sk

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SHAPES = ("widest", "mace", "lm", "hot", "weather", "moe")
CPU_CHECKED = ("widest", "hot", "weather", "moe")
PARENT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def build(variants, parent=None) -> dict:
    """One nvcc per ``variants`` source and for ``parent``, all at once;
    returns {name: ctypes library}, the variants under their file stems."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {pathlib.Path(v).stem: pathlib.Path(v) for v in variants}
    if parent:
        jobs["parent"] = pathlib.Path(parent)
    procs = {key: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                    str(_build.BUILD_DIR / f"libsweep_{key}.so"), str(source)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for key, source in jobs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"libsweep_{key}.so"))
        symbols = ({f"segment_sum_float_{t}": PARENT_ARGS for t in ("f32", "bf16")}
                   if key == "parent" else sk._SYMBOLS)
        for sym, argtypes in symbols.items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def parent_call(lib, vals, layout):
    """The earlier kernel's one launch (vals (E, F) contiguous)."""
    out = torch.empty((layout.n, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    fn = getattr(lib, sk._FLOAT_SYMBOL[vals.dtype])
    err = fn(vals.data_ptr(), vals.shape[1], layout.order.data_ptr(), layout.row_ptr.data_ptr(),
             out.data_ptr(), layout.n, vals.shape[1],
             torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(lib, err, "parent segment_sum_float")
    return out


def variant_call(lib, vals, layout):
    """A build's call with this source's arguments, as ``ops._launch_float``
    makes it (vals (E, F) contiguous), without the wrapper's checks, so that
    every build is timed through the same host path."""
    E, F = vals.shape
    st = layout.stretches
    out = torch.empty((layout.n, F), dtype=vals.dtype, device=vals.device)
    partials = (torch.empty((st.owner.numel(), F), dtype=torch.float32, device=vals.device)
                if st.owner.numel() else None)
    tickets = sk._tickets(vals.device)
    err = getattr(lib, sk._FLOAT_SYMBOL[vals.dtype])(
        vals.data_ptr(), F, layout.order.data_ptr(), layout.row_ptr.data_ptr(),
        st.rows.data_ptr(), st.ptr.data_ptr(), st.owner.data_ptr(), st.batches.data_ptr(),
        out.data_ptr(), partials.data_ptr() if partials is not None else None,
        tickets.data_ptr(), layout.n, F, st.rows.numel(), st.owner.numel(),
        st.batches.numel() - 1, sk.STRETCH, torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(lib, err, "variant segment_sum_float")
    return out


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device milliseconds a call: every kernel's time in a ``torch.profiler``
    trace of ``reps`` calls, over the launches of the most launched kernel
    that the trace holds (it may miss the first few)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if e.device_time_total > 0]
    calls = max((e.count for e in found), default=0)
    return sum(e.device_time_total for e in found) / calls / 1e3 if calls else float("nan")


def shapes(names, dev) -> dict:
    """{name: (label, vals, ids, n)} on ``dev``, generated from fixed seeds."""
    gen = torch.Generator(device=dev).manual_seed(27)
    out, g = {}, None
    if {"widest", "mace"} & set(names):
        from repro_torch.graph import generators

        t0 = time.perf_counter()
        g = generators.snap_analogue("SPR", 1.0, seed=0)
        print(f"SPR generated in {time.perf_counter() - t0:.1f} s", flush=True)
        from repro_torch.configs import get_config
        from repro_torch.models.gnn import steps

        C = get_config("mace").d_hidden
        if "widest" in names:
            d = int(g.deg.max())
            out["widest"] = ("the widest SPR row alone at MACE's a2 width",
                             torch.randn((d, 9 * C), generator=gen, device=dev).mul_(30).bfloat16(),
                             torch.zeros(d, dtype=torch.int64, device=dev), 1)
        if "mace" in names:
            E = steps._pad512(g.num_arcs)
            Ec = E // 32
            dst = np.concatenate([g.dst, np.zeros(E - g.num_arcs, np.int32)])[:Ec]
            out["mace"] = ("MACE a2 chunk over SPR",
                           torch.randn((Ec, 9 * C), generator=gen, device=dev).mul_(30).bfloat16(),
                           torch.as_tensor(dst.astype(np.int64), device=dev), g.n)
    if {"lm", "hot"} & set(names):
        from repro_torch.data import synth_lm_batch

        vocab = 151_936
        tokens = torch.from_numpy(synth_lm_batch(vocab, 8, 4096, seed=0, step=0)[0]).reshape(-1)
        tokens = tokens.to(torch.int64).to(dev)
        rows = torch.randn((tokens.numel(), 1024), generator=gen, device=dev)
        if "lm" in names:
            out["lm"] = ("LM embedding backward (8 x 4096 tokens)", rows, tokens, vocab)
        if "hot" in names:
            counts = torch.bincount(tokens, minlength=vocab)
            hot = int(counts.argmax())
            out["hot"] = ("the LM embedding's hottest row alone", rows[tokens == hot].contiguous(),
                          torch.zeros(int(counts[hot]), dtype=torch.int64, device=dev), 1)
    if "weather" in names:
        from repro_torch.configs import get_config
        from repro_torch.models.gnn import graphcast

        wcfg = get_config("graphcast")
        mm = graphcast.make_weather_graph(wcfg, 0)["mm_dst"]
        out["weather"] = ("weather mm (processor block)",
                          torch.randn((mm.shape[0], wcfg.d_hidden), generator=gen, device=dev),
                          torch.as_tensor(np.asarray(mm, np.int64), device=dev),
                          wcfg.params["mesh_nodes"])
    if "moe" in names:
        tokens, per, d = 9_216, 4, 6_144
        out["moe"] = ("MoE dispatch backward (mixtral-8x22b, 1 x 9216, 4 slot rows a token)",
                      torch.randn((tokens * per, d), generator=gen, device=dev).bfloat16(),
                      torch.arange(tokens, device=dev).repeat_interleave(per), tokens)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", nargs="+", default=[],
                    help="other sources of the kernel with this one's entry points")
    ap.add_argument("--parent", default=None, help="an earlier segment_sum.cu to time beside")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=SHAPES)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", default=None, help="write every time here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep times the kernel on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    this = _build.load("segment_sum", sk._SYMBOLS)
    libs = build(args.variant, args.parent)
    print(f"{len(libs) + 1} builds in {time.perf_counter() - t0:.1f} s", flush=True)
    ok, rows = True, []
    for name, (label, vals, ids, n) in shapes(args.shapes, dev).items():
        E, F = vals.shape
        s = vals.element_size()
        bound = (E * F * s + 8 * E + 8 * (n + 1) + n * F * s) / HBM_BYTES_PER_S * 1e3
        lay = sk.segment_layout(ids, n)
        calls = {"this source": lambda: variant_call(this, vals, lay)}
        for key, lib in libs.items():
            call = parent_call if key == "parent" else variant_call
            calls[key] = lambda lib=lib, call=call: call(lib, vals, lay)
        calls["index_add_"] = lambda: torch.zeros((n, F), dtype=vals.dtype, device=dev).index_add_(
            0, lay.ids, vals)
        got = sk.segment_sum_float(vals, lay)
        same = all(torch.equal(got, calls[key]()) for key in ("this source", *libs)
                   if key != "parent")
        if name in CPU_CHECKED:
            same = same and torch.equal(got.cpu(), sk.segment_sum_float_ref(vals.cpu(), ids.cpu(), n))
        ok = ok and same
        print(f"  {name}: the variants agree with this source"
              f"{' and with the CPU plain version' if name in CPU_CHECKED else ''}: {same}",
              flush=True)
        del got
        times = {key: [] for key in calls}
        dev_times = {key: [] for key in calls}
        order = list(calls)
        for rnd in range(args.rounds):
            for key in (order if rnd % 2 == 0 else order[::-1]):
                times[key].append(events_ms(calls[key], args.reps))
                dev_times[key].append(device_ms(calls[key], args.reps))
        print(f"{label}: E={E} n={n} F={F} {str(vals.dtype)[6:]}, bound {bound:.4f} ms", flush=True)
        for key, ts in times.items():
            dt = dev_times[key]
            print(f"  {key:16s} {min(ts):.4f} ms a call, {min(dt):.4f} on the device (rounds "
                  f"{', '.join(f'{t:.4f}' for t in ts)} / {', '.join(f'{t:.4f}' for t in dt)}; "
                  f"the bound {bound / min(dt):.1%} of the device time)", flush=True)
            rows.append(dict(shape=name, label=label, E=E, n=n, F=F, dtype=str(vals.dtype)[6:],
                             variant=key, ms=ts, device_ms=dt, bound_ms=bound))
        del calls, lay, vals, ids
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "rows": rows, "ok": ok}, f, indent=1)
    print("all variants agree" if ok else "FAILED: variants disagree")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
