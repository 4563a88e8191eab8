"""End-to-end LM training, ported from ``examples/train_lm_e2e.py``: data
pipeline -> train step (AdamW, grad clip, schedule) -> fault-tolerant driver
with checkpoint/restart -> loss curve.

    PYTHONPATH=src python -m repro_torch.launch.train_lm_e2e --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_lm_e2e \\
        --layers 10 --d-model 768 --steps 300 --batch 8 --seq 256

The flags are the example's, plus ``--device cuda|cpu`` (the card unless
``--device cpu``; with no card and no ``--device cpu`` it fails). The model
is the example's ``example-lm`` (vocab 8,192, tied embeddings, d_head 64),
weights drawn from seed 0; the run fails, as the example does, unless the
last logged loss is below the first.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> None:
    from repro_torch.configs.base import LMConfig
    from repro_torch.launch.train import make_batch_fn, make_state, make_step_fn, run_summary
    from repro_torch.optim import AdamWConfig
    from repro_torch.platform import resolve_device
    from repro_torch.runtime import TrainDriver, TrainDriverConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_example_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernels and fails without a card; "
                    "cpu runs their plain PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LMConfig(
        name="example-lm", n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1),
        d_head=64, d_ff=args.d_model * 3, vocab=8192, tie_embeddings=True)
    print(f"params: {cfg.n_params/1e6:.1f}M")

    driver = TrainDriver(make_step_fn(cfg, args.steps, AdamWConfig(lr=1e-3)),
                         make_state(cfg, 0, dev),
                         make_batch_fn(cfg.vocab, args.batch, args.seq, 0, dev),
                         TrainDriverConfig(total_steps=args.steps,
                                           checkpoint_every=args.steps // 2,
                                           checkpoint_dir=args.ckpt_dir,
                                           log_every=max(args.steps // 10, 1)))
    report = driver.run()
    print("loss curve:")
    for m in report["metrics"]:
        print(f"  step {m['step']:4d} loss {m['loss']:.3f} "
              f"({m['step_time_s']:.2f}s/step)")
    print(run_summary(driver, dev))
    first, last = report["metrics"][0]["loss"], report["metrics"][-1]["loss"]
    assert last < first, "loss did not decrease"
    print(f"OK: {first:.3f} -> {last:.3f}")


if __name__ == "__main__":
    main()
