"""DIN scenario, ported: train briefly, then serve batched requests and run
candidate retrieval (the counterpart of ``examples/din_serving.py``).

    PYTHONPATH=src python -m repro_torch.launch.din_serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.din_serve
    PYTHONPATH=src python -m repro_torch.launch.din_serve --batch 262144 \\
        --n-candidates 1000000 --top-k 100

Without ``--smoke`` the model is ``configs/din.py::CONFIG`` at full width
(10^6 x 18 item table, history of 100). The run is on the card unless
``--device cpu`` is given (then the embedding-bag kernel's plain version
runs); with no card and no ``--device cpu`` it fails. Weights are drawn
from ``--seed`` on the run's device; batches come from ``synth_batch`` with
the example's seeds (step i for training, 99 for serving, 7 for
retrieval). It prints the example's three lines (train loss first -> last,
serve ms and mean CTR, retrieval top-k ids), then the card's name and power
limit with the step times and the peak device memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import RECSYS_SHAPES, RecSysConfig, ShapeSpec


@dataclasses.dataclass
class TrainResult:
    params: dict
    opt_state: dict
    losses: list
    ms_per_step: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shape_spec(kind: str, size: int) -> ShapeSpec:
    """The shape of a ``kind`` batch (train, serve: ``size`` rows; retrieval:
    ``size`` candidates, which ``synth_batch`` pads to a multiple of 512)."""
    params = {"batch": 1, "n_candidates": size} if kind == "retrieval" else {"batch": size}
    return ShapeSpec(kind, kind, params)


def make_batch(cfg: RecSysConfig, kind: str, size: int, seed: int, device) -> dict:
    """A ``synth_batch`` of ``shape_spec(kind, size)`` as tensors on ``device``."""
    from repro_torch.models.recsys import steps

    return steps.batch_to(steps.synth_batch(cfg, shape_spec(kind, size), seed), device)


def train(params: dict, opt_state: dict, cfg: RecSysConfig, n_steps: int, batch: int,
          device, opt_cfg=None) -> TrainResult:
    """``n_steps`` AdamW steps on batches drawn with seeds 0, 1, ...; the time
    is that of the steps alone (each ended by reading its loss back), not of
    drawing the batches."""
    from repro_torch.models.recsys.steps import make_train_step

    step = make_train_step(cfg, opt_cfg)
    losses, seconds = [], 0.0
    for i in range(n_steps):
        b = make_batch(cfg, "train", batch, i, device)
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        seconds += time.perf_counter() - t0
    return TrainResult(params, opt_state, losses, seconds * 1e3 / max(n_steps, 1))


def serve(params: dict, cfg: RecSysConfig, batch: dict) -> tuple[torch.Tensor, float]:
    """Click probabilities (B,) and the ms of the call, ended by a synchronize."""
    from repro_torch.models.recsys.steps import make_serve_step

    dev = batch["hist_items"].device
    _sync(dev)
    t0 = time.perf_counter()
    probs = make_serve_step(cfg)(params, batch)
    _sync(dev)
    return probs, (time.perf_counter() - t0) * 1e3


def retrieve(params: dict, cfg: RecSysConfig, batch: dict, top_k: int):
    """(values, indices) of the ``top_k`` best candidates and the ms of the call."""
    from repro_torch.models.recsys.steps import make_retrieval_step

    dev = batch["hist_items"].device
    _sync(dev)
    t0 = time.perf_counter()
    vals, idx = make_retrieval_step(cfg, top_k)(params, batch)
    _sync(dev)
    return vals, idx, (time.perf_counter() - t0) * 1e3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="the SMOKE config, not full width")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernel and fails without a card; "
                    "cpu runs its plain PyTorch version")
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--batch", type=int, default=512, help="serve batch")
    ap.add_argument("--n-candidates", type=int, default=5000)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if min(args.train_steps, args.train_batch, args.batch, args.top_k) < 1:
        ap.error("--train-steps, --train-batch, --batch and --top-k must be at least 1")
    if args.n_candidates < args.top_k:
        ap.error("--n-candidates must be at least --top-k")
    return args


def main(argv=None) -> None:
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models.recsys import din
    from repro_torch.optim import adamw_init
    from repro_torch.platform import device_summary, resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke("din") if args.smoke else get_config("din")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = din.init_params(cfg, args.seed, dev)
    tr = train(params, adamw_init(params), cfg, args.train_steps, args.train_batch, dev)
    print(f"train: loss {tr.losses[0]:.4f} -> {tr.losses[-1]:.4f}")

    batch = make_batch(cfg, "serve", args.batch, 99, dev)
    serve(tr.params, cfg, batch)                       # warm-up
    probs, serve_ms = serve(tr.params, cfg, batch)
    name = next((s.name for s in RECSYS_SHAPES
                 if s.kind == "serve" and s.params["batch"] == args.batch), "serve")
    print(f"{name} batch={args.batch}: {serve_ms:.1f} ms, mean ctr {float(probs.mean()):.3f}")

    rb = make_batch(cfg, "retrieval", args.n_candidates, 7, dev)
    _, idx, retrieval_ms = retrieve(tr.params, cfg, rb, args.top_k)
    print(f"retrieval top-{args.top_k} candidate ids:", idx.tolist())

    card = device_summary(dev)
    peak = f"{torch.cuda.max_memory_allocated(dev)} bytes" if dev.type == "cuda" else "not measured"
    print(f"device: {card['name']} (count {card['count']}, power limit {card['power_limit']}); "
          f"{cfg.name}: train {tr.ms_per_step:.3f} ms/step at batch {args.train_batch}, serve "
          f"{serve_ms:.3f} ms at batch {args.batch}, retrieval {retrieval_ms:.3f} ms over "
          f"{rb['cand_items'].numel()} candidates; peak device memory {peak}")


if __name__ == "__main__":
    main()
