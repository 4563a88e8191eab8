"""Wall times of the port's paths that the work bookings (``kernels/cost.py``)
and the shape-static forms of MoE routing and GraphCast's species encoding
run through, for this tree's ``repro_torch`` and another checkout's.

    python -m repro_torch.launch.path_timing --parent DIR [--out FILE]
    python -m repro_torch.launch.path_timing --device cpu --small

With ``--parent DIR`` (a checkout whose ``src/repro_torch`` is the one to
compare with) each side runs in a process of its own, in the order parent,
change, change, parent, and one JSON line is printed per run and written to
``--out``. Without it, this tree alone runs once. Each path is called once
to warm up and then timed on the host's clock, each call ended by a
synchronise; the median of the timed calls is kept:

  * ``flash_call``: the flash wrapper at the serve shape (8 x 2,048, 16
    heads, d 64, bf16, causal) and at 1 x 128, where the host's share is
    largest;
  * ``lm_serve``: qwen1.5-0.5b at full width served 8 x 2,048 + 32 through
    ``launch.serve.generate``: prefill ms and decode ms a token;
  * ``kcore_block_gs``: the FC analogue at scale 0.2 through
    ``kcore_decompose`` in ``block_gs`` mode, thousands of kernel launches;
  * ``din_train``: DIN at full width, AdamW steps at batch 65,536 through
    ``launch.din_serve.train``;
  * ``moe_serve``: qwen2-moe-a2.7b at full width served 8 x 2,048 + 32;
  * ``moe_train``: qwen2-moe-a2.7b cut to 1 layer, the loss and its
    gradient at 1 x 4,096;
  * ``graphcast_molecule``: a GraphCast train step at full width on the
    molecule batch, whose nodes are one-hot species.

``--small`` runs the SMOKE configs at small shapes (a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

PATHS = ("flash_call", "lm_serve", "kcore_block_gs", "din_train", "moe_serve", "moe_train",
         "graphcast_molecule")


def _timed(torch, dev, fn, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn`` after one warm-up call."""

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn()
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def flash_call(torch, dev, small):
    from repro_torch.kernels.flash_attention import ops as fa

    out = {}
    for name, (B, S) in {"serve": (8, 2048), "short": (1, 128)}.items():
        S = S // (16 if small else 1)
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn((B, S, 16, 64), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out[f"{name}_ms"] = _timed(torch, dev, lambda: fa.flash_attention(q, k, v),
                                    2 if small else 50)
    return out


def _serve(torch, dev, small, arch, reps):
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch import serve

    cfg = (get_smoke if small else get_config)(arch)
    params = serve.make_params(cfg, 0, dev)
    prompts = serve.make_prompts(cfg, 8, 2048 // (16 if small else 1), dev)
    serve.generate(params, cfg, prompts, 2)
    runs = [serve.generate(params, cfg, prompts, 32) for _ in range(1 if small else reps)]
    return {"prefill_ms": statistics.median(r.prefill_s * 1e3 for r in runs),
            "decode_ms_per_token": statistics.median(r.decode_ms_per_token for r in runs)}


def lm_serve(torch, dev, small):
    return _serve(torch, dev, small, "qwen1.5-0.5b", 3)


def moe_serve(torch, dev, small):
    return _serve(torch, dev, small, "qwen2-moe-a2.7b", 2)


def kcore_block_gs(torch, dev, small):
    from repro_torch.core.kcore import KCoreConfig, kcore_decompose
    from repro_torch.graph import generators

    g = generators.snap_analogue("FC", 0.02 if small else 0.2)
    cfg = KCoreConfig(mode="block_gs")
    rounds = kcore_decompose(g, cfg, device=dev).rounds
    ms = _timed(torch, dev, lambda: kcore_decompose(g, cfg, device=dev), 1 if small else 3)
    return {"ms": ms, "rounds": rounds}


def din_train(torch, dev, small):
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch import din_serve
    from repro_torch.models.recsys import din
    from repro_torch.optim import adamw_init

    cfg = (get_smoke if small else get_config)("din")
    params = din.init_params(cfg, 0, dev)
    B = 65536 // (64 if small else 1)
    tr = din_serve.train(params, adamw_init(params), cfg, 1, B, dev)     # warm-up
    tr = din_serve.train(tr.params, tr.opt_state, cfg, 1 if small else 5, B, dev)
    return {"ms_per_step": tr.ms_per_step}


def moe_train(torch, dev, small):
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import synth_lm_batch
    from repro_torch.models.autodiff import value_and_grad
    from repro_torch.models.transformer import model as M

    cfg = (get_smoke if small else get_config)("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, n_layers=1)
    on_card = dev.type == "cuda"
    params = M.init_params(cfg, 0, device=dev, on_device=True) if on_card \
        else M.init_params(cfg, 0, device=dev)
    tok, lab = (torch.from_numpy(a).to(dev)
                for a in synth_lm_batch(cfg.vocab, 1, 4096 // (32 if small else 1), seed=0, step=0))
    return {"ms": _timed(torch, dev, lambda: value_and_grad(
        lambda p: M.lm_loss(p, cfg, tok, lab), params), 1 if small else 3)}


def graphcast_molecule(torch, dev, small):
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models.gnn import common, steps
    from repro_torch.optim import adamw_init

    cfg = (get_smoke if small else get_config)("graphcast")
    shape = {sp.name: sp for sp in GNN_SHAPES}["molecule"]
    batch = common.batch_to(common.batch_molecules(128, 30, 64, cfg.params.get("n_species", 10),
                                                   seed=0), dev)
    params = steps.init_params(cfg, 0, device=dev)
    step = steps.make_train_step(cfg, shape)
    opt = adamw_init(params)
    return {"ms": _timed(torch, dev, lambda: step(params, opt, batch), 1 if small else 5)}


def worker(paths, device: str, small: bool) -> dict:
    import torch

    import repro_torch
    from repro_torch.platform import nvidia_smi_line, resolve_device

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"package": str(pathlib.Path(repro_torch.__file__).parent), "device": str(dev),
           "card": nvidia_smi_line() if dev.type == "cuda" else None}
    for name in paths:
        t0 = time.perf_counter()
        rec[name] = globals()[name](torch, dev, small)
        rec[name]["wall_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose src/repro_torch to compare with")
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--small", action="store_true", help="SMOKE configs at small shapes")
    ap.add_argument("--out", help="append each run's JSON line to this file")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker or not args.parent:
        rec = worker(args.paths, args.device, args.small)
        print(json.dumps(rec), flush=True)
        return 0
    here = pathlib.Path(__file__).resolve().parents[2]
    sides = {"parent": pathlib.Path(args.parent).resolve() / "src", "change": here}
    flags = ["--paths", *args.paths] + (["--device", args.device] if args.device else []) \
        + (["--small"] if args.small else [])
    for side in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(sides[side]))
        # -P: the script's own directory stays off sys.path, so the side's package is imported
        out = subprocess.run([sys.executable, "-P", __file__, "--worker", *flags], env=env,
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        rec = dict(json.loads(out.stdout.strip().splitlines()[-1]), side=side)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
