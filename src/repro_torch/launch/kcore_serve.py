"""Streaming k-core serving loop on the card: churn batches interleaved with
query load (the port of ``repro.launch.kcore_serve``).

    PYTHONPATH=src python -m repro_torch.launch.kcore_serve --graph EEN --scale 0.27
    PYTHONPATH=src python -m repro_torch.launch.kcore_serve --graph FC \\
        --batches 10 --churn 0.01 --queries 100000 --verify
    PYTHONPATH=src python -m repro_torch.launch.kcore_serve --graph ba --n 500 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.kcore_serve --graph ba --n 500 --mesh 2 \
        --frontier sharded --device cpu --verify

    # temporal replay: slide a window over a timestamped event stream
    PYTHONPATH=src python -m repro_torch.launch.kcore_serve --events snap:FC \\
        --scale 0.05 --window 3000 --stride 500 --verify

    # concurrent reads, live HTTP routes, warm restarts
    PYTHONPATH=src python -m repro_torch.launch.kcore_serve --graph ba --n 500 \\
        --concurrent 4 --listen 0 --checkpoint-dir /tmp/ck

Each tick applies one churn batch (--churn fraction of current edges, split
between deletes and inserts) through the incremental engine, then answers a
batched query load (--queries core-number lookups plus k-core membership and
max-k probes) from the maintained index. Prints one CSV row per tick:
incremental vs from-scratch message bill (the scratch run decomposes the
current graph on the same device), re-convergence rounds, region size and
query throughput. --verify checks every tick against the BZ oracle. The
header, the CSV columns and the ``#`` lines are the reference CLI's, so a run
of each can be diffed; the header adds ``device=``.

--events replays a timestamped event stream instead (``repro_torch.temporal``):
a tick slides a count- or time-based window (--window/--stride/--by), the
delta re-converges incrementally, every boundary's core vector goes into the
server's as-of ring, and each tick also answers a ``core_asof`` query. It
takes an .npz or text event log, ``snap:<ABBREV>``, ``ba`` or ``contact``.

--concurrent N serves the read side from an N-worker snapshot-isolated pool
(``streaming.concurrent``); with --listen the /query/* HTTP routes go live.
--checkpoint-dir DIR adds warm restarts: the latest checkpoint in DIR is
loaded at startup, and the full server state is saved on exit, a
SIGTERM/SIGINT drain included, in the reference's layout; the per-tick RNG
is derived from (seed, tick), so a resumed run draws what the uninterrupted
one drew.

Runs on the CUDA card unless ``--device cpu`` is given (then the kernels'
plain PyTorch versions run); with no card and no ``--device cpu`` it fails.
--mesh N runs the maintenance engine mesh-native on an N-shard ("data",)
mesh held by this process on ``--device`` (``dense`` becomes ``sharded``):
the initial decomposition and the per-batch supersteps run on the shards.
Cores and message counts equal the single-device engine's on any mesh.
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="EEN", help="SNAP abbrev (Table I) or chain/ba/er")
    ap.add_argument("--scale", type=float, default=0.27)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--churn", type=float, default=0.01,
                    help="fraction of edges churned per batch")
    ap.add_argument("--queries", type=int, default=100_000,
                    help="core-number lookups per tick")
    ap.add_argument("--frontier", default="dense",
                    choices=["dense", "compact", "sharded", "fused", "auto"],
                    help="engine execution mode; fused = the batch's rounds in one "
                    "device-resident loop")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run mesh-native on an N-shard ('data',) mesh held by this process "
                    "on --device. 0 = single device (default)")
    ap.add_argument("--verify", action="store_true",
                    help="check vs the BZ oracle every tick (slow)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernels and fails without a card; "
                    "cpu runs their plain PyTorch versions")
    # temporal replay mode (repro_torch.temporal)
    ap.add_argument("--events", default=None, metavar="SRC",
                    help="replay a timestamped event stream instead of synthetic churn: "
                    "a .npz/text event-log path or a generator spec "
                    "(snap:<ABBREV> | ba | contact)")
    ap.add_argument("--window", type=float, default=2000,
                    help="window size: events (--by count) or time span (--by time)")
    ap.add_argument("--stride", type=float, default=500,
                    help="window advance per tick, same unit as --window")
    ap.add_argument("--by", default="count", choices=["count", "time"])
    ap.add_argument("--remove-frac", type=float, default=0.15,
                    help="removal-event fraction for generated traces")
    ap.add_argument("--asof-capacity", type=int, default=16,
                    help="retained window boundaries for core_asof queries")
    ap.add_argument("--concurrent", type=int, default=0, metavar="N",
                    help="serve reads from an N-worker snapshot-isolated pool while the "
                    "single writer re-converges (streaming.concurrent); with --listen, "
                    "also mounts live /query/* HTTP routes. 0 = the sequential serve "
                    "loop (default)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="warm restarts: resume from the latest checkpoint in DIR at "
                    "startup (if any) and save the full server state there on exit, "
                    "including a SIGTERM/SIGINT drain")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="enable span tracing and export a Chrome trace_event JSON")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the server metrics registry (JSON, incl. per-op latency "
                    "histograms) after the run")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve live observability over HTTP while the loop runs: "
                    "/metrics, /healthz, /debug/flight (and /query/* with "
                    "--concurrent). Implies the flight recorder + invariant monitor. "
                    "0 = ephemeral port")
    ap.add_argument("--flight", default=None, metavar="OUT.json",
                    help="enable the convergence flight recorder + invariant monitor and "
                    "dump the round ring, watch timelines and health verdict as JSON")
    return ap.parse_args(argv)


def _fmt_stats(stats: dict) -> dict:
    """Round the raw-float walls and latencies for the footer line
    (``KCoreServer.stats()`` reports exact float seconds)."""
    def _r(v):
        if isinstance(v, float):
            return round(v, 6)
        if isinstance(v, dict):
            return {k: _r(x) for k, x in v.items()}
        return v

    return {k: _r(v) for k, v in stats.items()}


def _tick_rng(seed: int, tick: int):
    """Per-tick RNG derived from (seed, tick), not one stream threaded
    through the loop, so a run resumed from a checkpoint at tick T draws
    exactly what the uninterrupted run drew at T."""
    import numpy as np

    return np.random.default_rng((int(seed), int(tick)))


def _install_stop():
    """SIGTERM/SIGINT -> graceful drain: the serving loop finishes its
    current tick, then checkpoints (with --checkpoint-dir) and exits 0.
    Main thread only (``signal.signal``)."""
    import signal
    import threading

    stop = threading.Event()

    def _handler(signum, frame):  # noqa: ARG001 - signal API
        if not stop.is_set():
            print(f"# signal {signum}: draining after current tick", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
    return stop


def _maybe_restore(args, server) -> int:
    """Warm restart: load the latest checkpoint in --checkpoint-dir (if any)
    into the freshly constructed server. Returns the tick to resume from."""
    if not args.checkpoint_dir:
        return 0
    from repro_torch.checkpoint import latest_step, restore_checkpoint

    step = latest_step(args.checkpoint_dir)
    if step is None:
        return 0
    state, _ = restore_checkpoint(args.checkpoint_dir, like=server.state_dict(), step=step)
    server.load_state_dict(state)
    print(f"# resumed: step {step} from {args.checkpoint_dir} "
          f"(m={server.engine.m} max_k={server.max_k()} "
          f"asof_boundaries={len(server.asof_ring)})", flush=True)
    return int(step)


def _front_end(args, server, httpd=None):
    """--concurrent N: wrap the server in the snapshot-isolated threaded
    front end and (with --listen) mount it on the /query/* HTTP routes."""
    if not args.concurrent:
        return None
    from repro_torch.streaming import ConcurrentKCoreServer

    front = ConcurrentKCoreServer(server, read_workers=args.concurrent,
                                  checkpoint_dir=args.checkpoint_dir)
    if httpd is not None:
        httpd.attach_query_backend(front)
        print(f"# obs: /query/* mounted ({args.concurrent} read workers)", flush=True)
    return front


def _save_on_exit(args, front, server, tick: int) -> None:
    """Drain the front end and persist the full server state."""
    if front is not None:
        path = front.drain(save=bool(args.checkpoint_dir), step=tick)
    elif args.checkpoint_dir:
        from repro_torch.checkpoint import save_checkpoint

        path = save_checkpoint(args.checkpoint_dir, int(tick), server.state_dict())
    else:
        return
    if path:
        print(f"# checkpoint: step {tick} -> {path}", flush=True)


def build_graph(args, generators):
    if args.graph == "chain":
        return generators.chain(args.n)
    if args.graph == "ba":
        return generators.barabasi_albert(args.n, 4, seed=args.seed)
    if args.graph == "er":
        return generators.erdos_renyi(args.n, 4 * args.n, seed=args.seed)
    return generators.snap_analogue(args.graph, scale=args.scale, seed=args.seed)


def build_event_log(args):
    """Resolve --events: a generator spec or an on-disk log."""
    from repro_torch import temporal

    src = args.events
    if src.startswith("snap:"):
        return temporal.temporal_snap_analogue(src.split(":", 1)[1], scale=args.scale,
                                               seed=args.seed, remove_frac=args.remove_frac)
    if src == "ba":
        return temporal.temporal_barabasi_albert(args.n, 4, seed=args.seed,
                                                 remove_frac=args.remove_frac)
    if src == "contact":
        return temporal.contact_bursts(args.n, seed=args.seed)
    return temporal.load_event_log(src)


def _serve_reads(front, server, reqs) -> float:
    """Answer one tick's query load; returns its wall."""
    t0 = time.perf_counter()
    if front is not None:
        front.serve_concurrent(reqs)
    else:
        server.serve(reqs)
    return time.perf_counter() - t0


def replay_serve(args, dev, mesh, httpd=None) -> None:
    """Temporal replay loop: window advances + query load + as-of probes."""
    import numpy as np

    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.streaming import KCoreServer, Request, StreamingConfig
    from repro_torch.temporal import WindowedKCoreEngine, check_step

    log = build_event_log(args)
    t0 = time.perf_counter()
    weng = WindowedKCoreEngine(log, args.window, args.stride, by=args.by,
                               config=StreamingConfig(frontier=args.frontier), mesh=mesh,
                               device=dev)
    server = KCoreServer(windowed=weng, asof_capacity=args.asof_capacity)
    if httpd is not None:
        httpd.add_registry(server.metrics)
    start_tick = _maybe_restore(args, server)
    front = _front_end(args, server, httpd=httpd)
    stop = _install_stop()
    print(f"# events={args.events} n={log.n} log_events={len(log)} "
          f"adds={log.num_adds} window={args.window} stride={args.stride} "
          f"by={args.by} mesh={args.mesh or 1} frontier={args.frontier} "
          f"init_wall_s={time.perf_counter() - t0:.2f} device={dev}", flush=True)

    print("tick,t_hi,m,inserted,deleted,inc_messages,scratch_messages,"
          "ratio,rounds,mode,patch_s,compactions,occupancy,queries,query_s,"
          "max_k,asof_t,verified", flush=True)
    tick = start_tick
    while not weng.done and tick < args.batches and not stop.is_set():
        rng = _tick_rng(args.seed, tick)
        ws = front.advance_window() if front is not None else server.advance_window()
        res = ws.result

        qids = rng.integers(0, log.n, size=args.queries)
        asof_t = float(rng.choice(server.asof_boundaries()))
        reqs = [Request(op="core", vertices=qids),
                Request(op="in_kcore", vertices=qids[: args.queries // 2],
                        k=max(server.max_k() - 1, 1)),
                Request(op="core_asof", t=asof_t, vertices=qids[: args.queries // 2]),
                Request(op="max_k")]
        query_s = _serve_reads(front, server, reqs)

        scratch = kcore_decompose(weng.window_graph(), device=dev)
        verified = str(check_step(weng, ws)) if args.verify else ""
        ratio = res.total_messages / max(scratch.stats.total_messages, 1)
        print(",".join(str(c) for c in (
            tick, round(ws.t_hi, 3), ws.m, res.delta.inserted.shape[0],
            res.delta.deleted.shape[0], res.total_messages,
            scratch.stats.total_messages, round(ratio, 4), res.rounds,
            res.mode, round(res.patch_s, 5), res.csr_compactions,
            round(res.csr_occupancy, 3), args.queries, round(query_s, 4),
            server.max_k(), round(asof_t, 3), verified)), flush=True)
        tick += 1

    print(f"# asof_boundaries={np.round(server.asof_boundaries(), 3).tolist()}")
    stats = front.stats() if front is not None else server.stats()
    print(f"# final_stats={_fmt_stats(stats)}")
    _save_on_exit(args, front, server, tick)
    _finish_obs(args, server)


def churn_serve(args, dev, mesh, httpd=None) -> None:
    """Static loop: a churn batch, the query load and the scratch bill a tick."""
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.graph import generators
    from repro_torch.streaming import KCoreServer, Request, StreamingConfig, random_churn_batch

    g = build_graph(args, generators)
    t0 = time.perf_counter()
    server = KCoreServer(g, StreamingConfig(frontier=args.frontier), mesh=mesh, device=dev)
    if httpd is not None:
        httpd.add_registry(server.metrics)
    print(f"# graph={args.graph} n={g.n} m={g.m} mesh={args.mesh or 1} "
          f"frontier={args.frontier} "
          f"init_messages={server.engine.init_result.stats.total_messages} "
          f"init_wall_s={time.perf_counter() - t0:.2f} device={dev}", flush=True)
    start_tick = _maybe_restore(args, server)
    front = _front_end(args, server, httpd=httpd)
    stop = _install_stop()

    print("tick,m,inserted,deleted,inc_messages,scratch_messages,ratio,"
          "rounds,region,seed_changed,mode,patch_s,queries,query_s,max_k,"
          "verified", flush=True)
    tick = start_tick
    while tick < args.batches and not stop.is_set():
        rng = _tick_rng(args.seed, tick)
        b = max(2, int(args.churn * server.engine.graph.m))
        batch = random_churn_batch(server.engine.graph, b // 2, b - b // 2, rng)
        res = front.update(batch) if front is not None else server.update(batch)

        # query load: batched core-number lookups + membership/max-k probes
        qids = rng.integers(0, server.engine.graph.n, size=args.queries)
        reqs = [Request(op="core", vertices=qids),
                Request(op="in_kcore", vertices=qids[: args.queries // 2],
                        k=max(server.max_k() - 1, 1)),
                Request(op="members", k=server.max_k()),
                Request(op="max_k")]
        query_s = _serve_reads(front, server, reqs)

        scratch = kcore_decompose(server.engine.graph, device=dev)
        verified = ""
        if args.verify:
            if not (res.core == bz_core_numbers(server.engine.graph)).all():
                raise SystemExit("incremental cores diverged from the BZ oracle!")
            verified = "True"
        ratio = res.total_messages / max(scratch.stats.total_messages, 1)
        print(",".join(str(c) for c in (
            tick, server.engine.graph.m, res.delta.inserted.shape[0],
            res.delta.deleted.shape[0], res.total_messages,
            scratch.stats.total_messages, round(ratio, 4), res.rounds,
            res.region_size, res.seed_changed, res.mode,
            round(res.patch_s, 5), args.queries,
            round(query_s, 4), server.max_k(), verified)), flush=True)
        tick += 1

    stats = front.stats() if front is not None else server.stats()
    print(f"# final_stats={_fmt_stats(stats)}")
    _save_on_exit(args, front, server, tick)
    _finish_obs(args, server)


def _finish_obs(args, server) -> None:
    """Shared --trace/--metrics/--flight tail of both serving loops."""
    import json

    if args.trace:
        from repro_torch.obs import trace

        trace.export(args.trace)
        print(f"# trace: {args.trace} ({len(trace.events())} events)")
    if args.metrics:
        print(json.dumps({"server_metrics": server.metrics.to_json()}, indent=1))
    if args.flight:
        from repro_torch.obs import flight, health

        payload = flight.to_json()
        payload["health"] = health.verdict()
        with open(args.flight, "w") as f:
            json.dump(payload, f)
        print(f"# flight: {args.flight} "
              f"(runs={payload['runs']} rounds={payload['rounds_recorded']} "
              f"health={payload['health']['status']})")


def main(argv=None) -> None:
    args = parse_args(argv)
    from repro_torch.platform import resolve_device

    # fail before any work when the card is wanted and missing
    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.distribution.compat import make_mesh

        mesh = make_mesh((args.mesh,), ("data",), device=dev)
        if args.frontier == "dense":
            args.frontier = "sharded"

    # live observability starts BEFORE the graph and the initial
    # decomposition, so external pollers can reach /healthz during startup
    httpd = None
    if args.listen is not None or args.flight:
        from repro_torch.obs import flight, health

        flight.enable()
        health.install()
        if args.listen is not None:
            from repro_torch.obs.http import start_server

            httpd = start_server(port=args.listen)
            print(f"# obs: listening on {httpd.url} (/metrics /healthz /debug/flight)",
                  flush=True)
    if args.trace:
        from repro_torch.obs import trace

        trace.enable()
    try:
        if args.events:
            replay_serve(args, dev, mesh, httpd=httpd)
        else:
            churn_serve(args, dev, mesh, httpd=httpd)
    finally:
        if httpd is not None:
            httpd.stop()


if __name__ == "__main__":
    main()
