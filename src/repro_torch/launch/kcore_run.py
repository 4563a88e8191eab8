"""The paper's experiment entry point, ported: k-core decomposition on the card.

    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph FC --scale 0.2
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph SPR --scale 1.0 --fused --json
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph ba --mesh 4 --fused --device cpu
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph chain --n 2000 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph FC --mode block_gs
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph FC --backend ell --device cpu
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph FC --metrics --flight f.json
    PYTHONPATH=src python -m repro_torch.launch.kcore_run --graph LJ1 --scale 0.01 \
        --out-of-core --mem-budget $((4 << 20))

Prints the paper's measurement set: total messages, messages/active nodes
per round, rounds to convergence, work bound, heartbeat-model overhead and
the simulated-network runtime, plus validation against the BZ oracle. The
JSON report keeps ``repro.launch.kcore_run``'s keys, so a run of each can be
diffed field by field, and adds ``device``, the card's name.

Runs on the CUDA card unless ``--device cpu`` is given (then the kernels'
plain PyTorch versions run); with no card and no ``--device cpu`` it fails.
``--fused`` keeps the per-round bills on the device (core/runtime.py),
bit-equal to the host loop (jacobi only). ``--mode block_gs`` sweeps 8
vertex blocks in order within a round; ``--backend ell|ell_pallas`` names
the ELL route, which every jacobi backend of the port runs. ``--mesh N``
runs the sharded engine (``core.kcore.kcore_decompose_sharded``) on an
N-shard ("data",) mesh held by this process on ``--device``, the host loop
or, with ``--fused``, the fused loop; jacobi/segment only.
``--out-of-core`` cycles arc blocks from a temporary on-disk store through
the card one at a time (``core/outofcore.py``), the block count planned from
``--mem-budget`` or forced by ``--blocks``; the report gains its
``out_of_core`` block. ``--metrics``
dumps the metrics registry (JSON or Prometheus text), ``--flight`` the
per-round flight ring with the invariant monitor's health verdict.
"""

from __future__ import annotations

import argparse
import json
import time

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="FC", help="SNAP abbrev (Table I) or chain/ba/er")
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="jacobi", choices=["jacobi", "block_gs"])
    ap.add_argument("--backend", default="segment", choices=["segment", "ell", "ell_pallas"])
    ap.add_argument(
        "--fused",
        action="store_true",
        help="keep the per-round bills on the device and reconstruct them "
        "afterwards (accounting bit-equal to the host loop)",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="cuda (default) runs the CUDA kernels and fails without a card; "
        "cpu runs their plain PyTorch versions",
    )
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the sharded engine on an N-shard ('data',) mesh held by this "
                    "process on --device")
    ap.add_argument(
        "--out-of-core",
        action="store_true",
        help="block-cycling decomposition on bounded device memory "
        "(repro_torch.core.outofcore): arc blocks spill to disk and cycle "
        "through an LRU cache; bills bit-equal to the in-memory modes",
    )
    ap.add_argument(
        "--mem-budget",
        type=int,
        default=None,
        metavar="BYTES",
        help="out-of-core LRU block-cache budget in bytes (drives the "
        "block-count plan; default: 8 blocks, unbounded cache)",
    )
    ap.add_argument(
        "--blocks",
        type=int,
        default=None,
        metavar="N",
        help="force the out-of-core block count instead of planning it "
        "from --mem-budget",
    )
    ap.add_argument("--json", action="store_true")
    ap.add_argument(
        "--trace",
        default=None,
        metavar="OUT.json",
        help="enable span tracing and export a Chrome trace_event JSON "
        "(open in Perfetto / chrome://tracing)",
    )
    ap.add_argument(
        "--metrics",
        action="store_true",
        help="dump the process metrics registry after the run "
        "(see --metrics-format / --metrics-out)",
    )
    ap.add_argument(
        "--metrics-format",
        default="json",
        choices=["json", "prom"],
        help="stdout format for --metrics: structured JSON (default) or "
        "the Prometheus text exposition format",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        metavar="PATH",
        help="also write the metrics registry to a file (implies "
        "--metrics); format inferred from the extension: .prom/.txt -> "
        "Prometheus text, anything else -> JSON",
    )
    ap.add_argument(
        "--flight",
        default=None,
        metavar="OUT.json",
        help="enable the convergence flight recorder + invariant monitor "
        "and dump the per-round ring and health verdict as JSON",
    )
    args = ap.parse_args(argv)
    if args.metrics_out:
        args.metrics = True
    if args.mesh and (args.mode != "jacobi" or args.backend != "segment"):
        ap.error("--mesh supports --mode jacobi --backend segment only")
    if args.out_of_core and (args.mesh or args.fused or args.mode != "jacobi"
                             or args.backend != "segment"):
        ap.error("--out-of-core is its own engine: jacobi/segment only, "
                 "no --mesh/--fused")
    if (args.mem_budget or args.blocks) and not args.out_of_core:
        ap.error("--mem-budget/--blocks require --out-of-core")
    return args


def build_graph(args, generators):
    if args.graph == "chain":
        return generators.chain(args.n)
    if args.graph == "ba":
        return generators.barabasi_albert(args.n, 4, seed=args.seed)
    if args.graph == "er":
        return generators.erdos_renyi(args.n, 4 * args.n, seed=args.seed)
    return generators.snap_analogue(args.graph, scale=args.scale, seed=args.seed)


def decompose_report(g, args, core_ref=None):
    """Decompose ``g`` as ``args`` asks and build the report.

    ``core_ref`` is the BZ oracle's answer when the caller already has it
    (it is computed here otherwise). With ``args.metrics`` the run's numbers
    are also folded into the metrics registry. Returns ``(report, result)``.
    """
    import torch

    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.cost_model import DATACENTER, INTERNET, TPU_POD, simulate_runtime
    from repro_torch.core.kcore import KCoreConfig, kcore_decompose, kcore_decompose_sharded
    from repro_torch.core.messages import heartbeat_overhead, work_bound
    from repro_torch.core.outofcore import outofcore_decompose
    from repro_torch.platform import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    if args.out_of_core:
        res = outofcore_decompose(g, mem_budget=args.mem_budget, n_blocks=args.blocks,
                                  device=dev)
    elif args.mesh:
        from repro_torch.distribution.compat import make_mesh

        mesh = make_mesh((args.mesh,), ("data",), device=dev)
        res = kcore_decompose_sharded(g, mesh, ("data",), fused=args.fused)
    else:
        res = kcore_decompose(g, KCoreConfig(mode=args.mode, backend=args.backend),
                              fused=args.fused, device=dev)
    wall = time.perf_counter() - t0

    ref = bz_core_numbers(g) if core_ref is None else core_ref
    ok = bool((res.core == ref).all())
    wb = work_bound(g, res.core)
    hb = heartbeat_overhead(res.stats)
    report = {
        "graph": args.graph,
        "n": g.n,
        "m": g.m,
        "avg_deg": round(g.avg_deg, 1),
        "max_deg": g.max_deg,
        "max_core": int(res.core.max()) if g.n else 0,
        "mode": args.mode,
        "backend": args.backend,
        "fused": args.fused,
        "dispatch": res.dispatch,
        "mesh": args.mesh or 1,
        "correct_vs_BZ": ok,
        "rounds": res.rounds,
        "converged": res.converged,
        "total_messages": res.stats.total_messages,
        "work_bound": wb,
        "messages_over_bound": round(res.stats.total_messages / max(wb, 1), 3),
        "messages_per_round": res.stats.messages_per_round.tolist()[:20],
        "active_per_round": res.stats.active_per_round.tolist()[:20],
        "heartbeats": hb["heartbeat_messages"],
        "wall_s": round(wall, 2),
        "recompiles": res.recompiles,
        "compile_s": round(res.compile_s, 3),
        "phase_s": {k: round(v, 4) for k, v in res.phase_s.items()},
        "simulated_runtime_s": {
            m.name: round(simulate_runtime(res.stats, m)["total_s"], 4)
            for m in (INTERNET, DATACENTER, TPU_POD)
        },
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if args.out_of_core and res.block_stats is not None:
        report["out_of_core"] = res.block_stats.to_json()
    if args.metrics:
        record_metrics(args, res, wall)
    return report, res


def record_metrics(args, res, wall: float) -> None:
    """Fold the run's headline numbers into the process metrics registry, as
    the reference CLI does, so the dump is useful for a single decomposition."""
    from repro_torch.obs import metrics

    labels = {"graph": args.graph}
    metrics.counter("kcore_rounds_total", **labels).inc(res.rounds)
    metrics.counter("kcore_messages_total", **labels).inc(int(res.stats.total_messages))
    metrics.gauge("kcore_compile_seconds", **labels).set(res.compile_s)
    metrics.gauge("kcore_wall_seconds", **labels).set(wall)
    for phase, secs in res.phase_s.items():
        metrics.gauge("kcore_phase_seconds", graph=args.graph, phase=phase).set(secs)


def dump_metrics(args) -> None:
    """Print the metrics registry (and write ``--metrics-out``), as the
    reference CLI does."""
    from repro_torch.obs import metrics

    if args.metrics_format == "prom":
        print(metrics.to_prometheus(), end="")
    else:
        print(json.dumps({"metrics": metrics.to_json()}, indent=1))
    if args.metrics_out:
        prom_file = args.metrics_out.endswith((".prom", ".txt"))
        with open(args.metrics_out, "w") as f:
            if prom_file:
                f.write(metrics.to_prometheus())
            else:
                json.dump({"metrics": metrics.to_json()}, f, indent=1)
        print(f"metrics: {args.metrics_out} ({'prom' if prom_file else 'json'})")


def main(argv=None) -> None:
    args = parse_args(argv)
    from repro_torch.graph import generators
    from repro_torch.obs import flight, health, trace

    if args.trace:
        trace.enable()
    if args.flight:
        flight.enable()
        health.install()

    g = build_graph(args, generators)
    report, _res = decompose_report(g, args)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    if args.trace:
        trace.export(args.trace)
        print(f"trace: {args.trace} ({len(trace.events())} events)")
    if args.metrics:
        dump_metrics(args)
    if args.flight:
        payload = flight.to_json()
        payload["health"] = health.verdict()
        with open(args.flight, "w") as f:
            json.dump(payload, f)
        print(f"flight: {args.flight} (runs={payload['runs']} "
              f"rounds={payload['rounds_recorded']} health={payload['health']['status']})")
    if not report["correct_vs_BZ"]:
        raise SystemExit("core numbers disagree with BZ oracle!")


if __name__ == "__main__":
    main()
