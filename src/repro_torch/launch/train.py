"""Training launcher, ported: an LM trained through the fault-tolerant driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --steps 20 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 20 --batch 8 --seq 4096

The flags are ``repro.launch.train``'s, plus ``--device cuda|cpu``: the run
is on the card unless ``--device cpu`` is given (then the kernels' plain
PyTorch versions run); with no card and no ``--device cpu`` it fails.
Without ``--smoke`` the model is the architecture's full config. Weights
are drawn from ``--seed`` (``model.init_params``; the reference's
``jax.random`` draws differ), batches are ``synth_lm_batch(vocab, batch,
seq, seed, step)``, and the driver checkpoints every ``--ckpt-every`` steps
into ``--ckpt-dir``, resuming from its newest committed step, whose state
it then continues (a reference checkpoint there restores too).

It prints the card's name and power limit, ms a step and the peak device
memory, then the reference's line ``arch=... steps=... loss: a -> b
stragglers=N``. Its losses are the driver's log, one every 10 steps: where
none was logged (fewer than 10 steps ran, or the run resumed at its end) it
exits with a message where the reference raises ``IndexError``.
``--profile`` (the card only) first takes one more step of the trained
state under ``torch.profiler`` and prints its wall, device time and
costliest kernels (``obs.profile``); the run's state does not advance.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch


def make_state(cfg, seed: int, device) -> list:
    """``[params, opt_state]``: the weights drawn from ``seed`` and a fresh
    AdamW state, on ``device``."""
    from repro_torch.models.transformer import model as M
    from repro_torch.optim import adamw_init

    params = M.init_params(cfg, seed, device=device)
    return [params, adamw_init(params)]


def make_step_fn(cfg, total_steps: int, opt_cfg=None):
    """The driver's ``step_fn(state, batch) -> (state, metrics)`` around
    ``steps.make_train_step``."""
    from repro_torch.models.transformer.steps import make_train_step

    step = make_train_step(cfg, opt_cfg, total_steps=total_steps)

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = step(params, opt, *batch)
        return [params, opt], metrics

    return step_fn


def make_batch_fn(vocab: int, batch: int, seq: int, seed: int, device):
    """``batch_fn(step) -> (tokens, labels)``: ``synth_lm_batch`` on ``device``."""
    from repro_torch.data import synth_lm_batch

    def batch_fn(i):
        t, lab = synth_lm_batch(vocab, batch, seq, seed=seed, step=i)
        return torch.from_numpy(t).to(device), torch.from_numpy(lab).to(device)

    return batch_fn


def run_summary(driver, device) -> str:
    """The card's name and power limit, ms a step (after the first, where
    there is more than one) and the peak device memory of a driver's run."""
    from repro_torch.platform import device_summary

    card = device_summary(device)
    times = driver.step_times[1:] or driver.step_times
    ms = 1e3 * sum(times) / len(times) if times else float("nan")
    peak = (f"{torch.cuda.max_memory_allocated(device)} bytes" if device.type == "cuda"
            else "not measured")
    return (f"device: {card['name']} (count {card['count']}, power limit {card['power_limit']}); "
            f"{ms:.3f} ms a step over {len(times)} step(s)"
            f"{' after the first' if len(driver.step_times) > 1 else ''}; peak device memory {peak}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernels and fails without a card; "
                    "cpu runs their plain PyTorch versions")
    ap.add_argument("--profile", action="store_true",
                    help="after the run, one more step under torch.profiler (the card only)")
    args = ap.parse_args(argv)
    if args.profile and args.device != "cuda":
        ap.error("--profile measures the card; drop --device cpu")
    try:
        from repro_torch.configs import get_config, get_smoke

        args.cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        if args.cfg.family != "lm":
            raise SystemExit("train.py drives the LM family; use kcore_run.py "
                             "or the examples for graph/recsys work")
    except KeyError as e:
        ap.error(str(e).strip("'\""))
    return args


def main(argv=None) -> None:
    from repro_torch.platform import resolve_device
    from repro_torch.runtime import TrainDriver, TrainDriverConfig

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = args.cfg
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = TrainDriver(
        make_step_fn(cfg, args.steps), make_state(cfg, args.seed, dev),
        make_batch_fn(cfg.vocab, args.batch, args.seq, args.seed, dev),
        TrainDriverConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                          checkpoint_dir=args.ckpt_dir))
    report = driver.run()
    if args.profile:
        from repro_torch.obs.profile import format_profile, profile_call

        _, prof = profile_call(lambda: driver.step_fn(driver.state, driver.batch_fn(driver.step)),
                               dev, top=12)
        print(format_profile({f"one more step at {args.batch} x {args.seq}": prof}))
    losses = [m["loss"] for m in report["metrics"]]
    print(run_summary(driver, dev))
    if not losses:
        raise SystemExit(f"no loss was logged: the driver logs one every "
                         f"{driver.cfg.log_every} steps, and this run took "
                         f"{len(driver.step_times)} step(s) to step {report['final_step']}")
    print(f"arch={cfg.name} steps={report['final_step']} "
          f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"stragglers={len(report['stragglers'])}")


if __name__ == "__main__":
    main()
