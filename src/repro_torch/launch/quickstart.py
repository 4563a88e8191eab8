"""Quickstart, ported from ``examples/quickstart.py``: distributed k-core
decomposition in a few lines.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Runs on the card unless ``--device cpu`` is given (then the kernels' plain
PyTorch versions run); with no card and no ``--device cpu`` it fails. On
the card a first line names the card and its power limit; every other line
is the example's, byte for byte.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from repro_torch.core.bz import bz_core_numbers
    from repro_torch.core.kcore import KCoreConfig, kcore_decompose
    from repro_torch.graph import generators as gen
    from repro_torch.platform import device_summary, resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernels and fails without a card; "
                    "cpu runs their plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = device_summary(dev)
        print(f"device: {card['name']} (power limit {card['power_limit']})")

    # The paper's Fig. 1 example graph (A..H)
    g, expected = gen.fig1_example()
    res = kcore_decompose(g, device=dev)
    print("Fig-1 cores :", dict(zip("ABCDEFGH", res.core.tolist())))
    assert (res.core == expected).all()

    # A social-network analogue (facebook-combined, Table I)
    g = gen.snap_analogue("FC", scale=0.2, seed=0)
    res = kcore_decompose(g, device=dev)
    print(f"\nFC-analogue: n={g.n} m={g.m} max_core={res.core.max()} "
          f"rounds={res.rounds} total_messages={res.stats.total_messages}")
    assert (res.core == bz_core_numbers(g)).all()

    # messages per round: the paper's Fig 6/7 quantity
    bars = res.stats.messages_per_round
    peak = bars.max()
    print("\nmessages per round:")
    for r, m in enumerate(bars):
        print(f"  round {r:2d} {'#' * int(40 * m / peak):<40} {m}")

    # beyond the paper: block-Gauss-Seidel scheduling
    gs = kcore_decompose(g, KCoreConfig(mode="block_gs", n_blocks=16), device=dev)
    print(f"\nblock-GS: rounds {res.rounds} -> {gs.rounds}, messages "
          f"{res.stats.total_messages} -> {gs.stats.total_messages}")


if __name__ == "__main__":
    main()
