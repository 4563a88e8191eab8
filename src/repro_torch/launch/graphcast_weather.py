"""GraphCast weather mode, ported: the next-state training loop and the
autoregressive rollout of ``examples/graphcast_weather.py``, the
encoder-processor-decoder on the lat-lon grid and the multimesh.

    PYTHONPATH=src python -m repro_torch.launch.graphcast_weather --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.graphcast_weather --smoke --device cpu --train-steps 25
    PYTHONPATH=src python -m repro_torch.launch.graphcast_weather

Without ``--smoke`` the model is ``configs/graphcast.py::CONFIG`` at full
width (65,160 grid nodes, 40,962 mesh nodes, d 512, 16 processor layers,
227 variables). The run is on the card unless ``--device cpu`` is given
(then the segment-sum kernel's plain version runs); with no card and no
``--device cpu`` it fails. The graph is ``make_weather_graph(cfg, 0)``;
weights are drawn from ``--seed`` on the run's device; the data are the
example's (``default_rng(0)`` draws the initial state, then the target
pattern; the next state is ``0.9 s + 0.1 target``). ``--train-steps N``
first takes the example's N AdamW steps (lr 1e-3, no weight decay) and
prints its loss line; the rollout then starts from the initial state with
the trained weights. Last it prints the card's name and power limit with
the ms a step and the peak device memory.
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


@dataclasses.dataclass
class Training:
    params: dict
    opt_state: dict
    losses: list
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


def example_data(cfg: GNNConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The example's state0 and target pattern, (n_grid, n_vars) float32
    each, drawn from ``default_rng(0)`` in that order."""
    n_grid = cfg.params["grid_lat"] * cfg.params["grid_lon"]
    rng = np.random.default_rng(0)
    draws = [rng.normal(size=(n_grid, cfg.params["n_vars"])).astype(np.float32) for _ in range(2)]
    return tuple(torch.as_tensor(d, device=device) for d in draws)


def initial_state(cfg: GNNConfig, device) -> torch.Tensor:
    """The example's state0: (n_grid, n_vars) float32 from ``default_rng(0)``."""
    return example_data(cfg, device)[0]


def next_state(state: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The example's synthetic dynamics: a smooth decay toward ``target``."""
    return 0.9 * state + 0.1 * target.to(state.dtype)


def weather_loss(params: dict, cfg: GNNConfig, state: torch.Tensor, target: torch.Tensor,
                 graph: dict, layouts: dict) -> torch.Tensor:
    """The example's loss: the mean squared error of the predicted next
    state against ``next_state``."""
    from repro_torch.models.gnn.graphcast import weather_forward

    pred = weather_forward(params, cfg, state, graph, layouts)
    return torch.mean((pred - next_state(state, target)) ** 2)


def train(params: dict, cfg: GNNConfig, graph: dict, layouts: dict, steps: int,
          opt_cfg=None) -> Training:
    """The example's loop: ``steps`` AdamW steps (default lr 1e-3, weight
    decay 0) of ``weather_loss``, the state advanced by ``next_state`` after
    each; each step timed to its end (a synchronize on the card)."""
    from repro_torch.models.autodiff import value_and_grad
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, weight_decay=0.0)
    device = params["mesh_embed"].device
    state, target = example_data(cfg, device)
    opt_state = adamw_init(params)
    losses, times = [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        loss, grads = value_and_grad(weather_loss, params, cfg, state, target, graph, layouts)
        params, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg)
        del grads
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        state = next_state(state, target)
    return Training(params, opt_state, losses, times)


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
    ap.add_argument("--train-steps", type=int, default=0,
                    help="AdamW steps of the example's next-state loss before the rollout "
                    "(the example takes 25; default 0, no training)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    if args.train_steps < 0:
        ap.error("--train-steps must not be negative")
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
    timing = ""
    if args.train_steps:
        tr = train(params, cfg, graph, layouts, args.train_steps)
        params = tr.params
        print(f"weather next-state MSE: {tr.losses[0]:.4f} -> {tr.losses[-1]:.4f}")
        timing = (f"train {sum(tr.ms_per_step) / args.train_steps:.3f} ms a step (steps "
                  f"{', '.join(f'{t:.3f}' for t in tr.ms_per_step)} ms), ")
    res = rollout(params, cfg, initial_state(cfg, dev), graph, layouts, args.steps)
    print(f"{args.steps}-step rollout finite:", bool(torch.isfinite(res.state).all()),
          "shape:", tuple(res.state.shape))
    card = device_summary(dev)
    peak = f"{torch.cuda.max_memory_allocated(dev)} bytes" if dev.type == "cuda" else "not measured"
    print(f"device: {card['name']} (count {card['count']}, power limit {card['power_limit']}); "
          f"{cfg.name}: {timing}{sum(res.ms_per_step) / args.steps:.3f} ms a step (steps "
          f"{', '.join(f'{t:.3f}' for t in res.ms_per_step)} ms); peak device memory {peak}")


if __name__ == "__main__":
    main()
