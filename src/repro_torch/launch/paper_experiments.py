"""The paper's experiment suite on one graph, ported from
``examples/paper_experiments.py``: the Table-I row, the Fig 5 total against
the work bound, the Fig 6/7 message and Fig 8/9 active-node series, the
termination-detection overhead and the simulated runtimes of Fig 10.

    PYTHONPATH=src python -m repro_torch.launch.paper_experiments --graph EEN
    PYTHONPATH=src python -m repro_torch.launch.paper_experiments --graph chain --n 500 --device cpu

The flags are the example's, plus ``--device cuda|cpu`` (the card unless
``--device cpu``; with no card and no ``--device cpu`` it fails). On the
card a first line names the card and its power limit; every other line is
the example's, byte for byte. ``report`` is the suite on a graph already
made, for callers that hold one (and its BZ cores) already.
"""

from __future__ import annotations

import argparse


def report(g, *, device, core_ref=None, name: str = "graph"):
    """Decompose ``g`` on ``device``, assert the cores against ``core_ref``
    (BZ's cores of ``g``; computed here when None) and print the suite with
    ``name`` in the Table-I heading. Returns the ``KCoreResult``."""
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.cost_model import DATACENTER, INTERNET, simulate_runtime
    from repro_torch.core.kcore import kcore_decompose
    from repro_torch.core.messages import work_bound
    from repro_torch.core.termination import HeartbeatModel, bsp_termination_cost

    res = kcore_decompose(g, device=device)
    want = bz_core_numbers(g) if core_ref is None else core_ref
    assert (res.core == want).all()
    st = res.stats

    print(f"=== Table I row ({name}) ===")
    print(f"n={g.n} m={g.m} AvgDeg={g.avg_deg:.1f} MaxDeg={g.max_deg} "
          f"MaxCore={res.core.max()}")

    print("\n=== Fig 5: total messages ===")
    wb = work_bound(g, res.core)
    print(f"total={st.total_messages}  work_bound={wb}  "
          f"ratio={st.total_messages / wb:.3f}")

    print("\n=== Fig 6/7: messages per round ===")
    print(st.messages_per_round.tolist())

    print("\n=== Fig 8/9: active nodes per round ===")
    print(st.active_per_round.tolist())

    print("\n=== termination detection (paper SIII.C vs BSP) ===")
    hb = HeartbeatModel().overhead(st, round_time_s=1.0)
    print(f"heartbeats={hb['total_heartbeats']} "
          f"(delay {hb['termination_delay_s']}s) vs BSP all-reduces="
          f"{bsp_termination_cost(st, 256)['allreduces']} (delay 1 round)")

    print("\n=== Fig 10 analogue: simulated runtime ===")
    for m in (INTERNET, DATACENTER):
        r = simulate_runtime(st, m)
        print(f"{m.name}: {r['total_s']:.4f}s "
              f"(latency-bound {r['latency_bound_fraction']:.0%})")
    return res


def main(argv=None) -> None:
    from repro_torch.graph import generators as gen
    from repro_torch.platform import device_summary, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="EEN")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernels and fails without a card; "
                    "cpu runs their plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = device_summary(dev)
        print(f"device: {card['name']} (power limit {card['power_limit']})")

    if args.graph == "chain":
        g = gen.chain(args.n)
    else:
        g = gen.snap_analogue(args.graph, scale=args.scale, seed=0)
    report(g, device=dev, name=args.graph)


if __name__ == "__main__":
    main()
