"""GraphCast weather mode, ported, serving half: an autoregressive rollout of
the encoder-processor-decoder on the lat-lon grid and the multimesh (the
counterpart of the rollout in ``examples/graphcast_weather.py``).

    PYTHONPATH=src python -m repro_torch.launch.graphcast_weather --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.graphcast_weather

Without ``--smoke`` the model is ``configs/graphcast.py::CONFIG`` at full
width (65,160 grid nodes, 40,962 mesh nodes, d 512, 16 processor layers,
227 variables). The run is on the card unless ``--device cpu`` is given
(then the segment-sum kernel's plain version runs); with no card and no
``--device cpu`` it fails. The graph is ``make_weather_graph(cfg, 0)``;
weights are drawn from ``--seed`` on the run's device; the initial state
is the example's (``default_rng(0)``). It prints the example's rollout line,
then the card's name and power limit with the ms a step and the peak device
memory. The example's training loop arrives with the training slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig


@dataclasses.dataclass
class Rollout:
    state: torch.Tensor
    ms_per_step: list


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_graph(cfg: GNNConfig, device, seed: int = 0) -> tuple[dict, dict]:
    """The weather graph as int64 tensors on ``device`` and its three
    destination layouts."""
    from repro_torch.models.gnn import graphcast

    graph = {k: torch.as_tensor(v.astype(np.int64), device=device)
             for k, v in graphcast.make_weather_graph(cfg, seed).items()}
    return graph, graphcast.weather_layouts(cfg, graph)


def initial_state(cfg: GNNConfig, device) -> torch.Tensor:
    """The example's state0: (n_grid, n_vars) float32 from ``default_rng(0)``."""
    n_grid = cfg.params["grid_lat"] * cfg.params["grid_lon"]
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.normal(size=(n_grid, cfg.params["n_vars"])).astype(np.float32),
                           device=device)


def rollout(params: dict, cfg: GNNConfig, state: torch.Tensor, graph: dict, layouts: dict,
            steps: int) -> Rollout:
    """``steps`` applications of ``weather_forward`` under inference mode,
    each timed to its end (a synchronize on the card)."""
    from repro_torch.models.gnn.graphcast import weather_forward

    times = []
    with torch.inference_mode():
        for _ in range(steps):
            _sync(state.device)
            t0 = time.perf_counter()
            state = weather_forward(params, cfg, state, graph, layouts)
            _sync(state.device)
            times.append((time.perf_counter() - t0) * 1e3)
    return Rollout(state, times)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="the SMOKE config, not full width")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernel and fails without a card; "
                    "cpu runs its plain PyTorch version")
    ap.add_argument("--steps", type=int, default=3, help="rollout steps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    return args


def main(argv=None) -> None:
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models.gnn import graphcast
    from repro_torch.platform import device_summary, resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke("graphcast") if args.smoke else get_config("graphcast")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    graph, layouts = make_graph(cfg, dev)
    params = graphcast.init_weather_params(cfg, args.seed, dev)
    res = rollout(params, cfg, initial_state(cfg, dev), graph, layouts, args.steps)
    print(f"{args.steps}-step rollout finite:", bool(torch.isfinite(res.state).all()),
          "shape:", tuple(res.state.shape))
    card = device_summary(dev)
    peak = f"{torch.cuda.max_memory_allocated(dev)} bytes" if dev.type == "cuda" else "not measured"
    print(f"device: {card['name']} (count {card['count']}, power limit {card['power_limit']}); "
          f"{cfg.name}: {sum(res.ms_per_step) / args.steps:.3f} ms a step (steps "
          f"{', '.join(f'{t:.3f}' for t in res.ms_per_step)} ms); peak device memory {peak}")


if __name__ == "__main__":
    main()
