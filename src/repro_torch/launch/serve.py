"""Serving launcher, ported: prefill + greedy decode over a batch of requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --smoke \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --batch 8 --prompt-len 2048 --gen 32

The flags are ``repro.launch.serve``'s, plus ``--device cuda|cpu``: the run
is on the card unless ``--device cpu`` is given (then the kernels' plain
PyTorch versions run); with no card and no ``--device cpu`` it fails.
Weights are drawn from ``--seed`` (``make_params``) and prompts from a
generator seeded 1, as the reference draws its prompts from key 1. With a
sliding window (``mixtral-8x22b``) the serving cache holds the last window
and rolls; prefill writes each position at the slot decode reads it from
(``model.prefill``), where the reference's placement is right only when the
prompt length is at most the window or a multiple of it. It
prints the reference's two lines, then the card's name and power limit and
the prefill and decode times. ``profile_serve`` runs prefill and decode
under ``torch.profiler`` (``chip_smoke.py`` prints it with
``obs.profile.format_profile``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch


@dataclasses.dataclass
class ServeResult:
    """What ``generate`` returns. ``tokens`` (B, G) int64 on the CPU: the
    greedy tokens (the first from the prefill logits); ``prefill_logits``
    (B, vocab) float32 on the run's device; ``step_logits`` the decode
    steps' logits when asked for; times in seconds on the host clock, each
    ended by a synchronize of the card."""

    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    step_logits: list | None
    prefill_s: float
    decode_s: float

    @property
    def decode_ms_per_token(self) -> float:
        steps = self.tokens.shape[1] - 1
        return self.decode_s * 1e3 / steps if steps else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen).to(device)


# the most float32 weight bytes ``make_params`` draws on the host before casting them: a
# few GiB (qwen1.5-0.5b takes 1.9 GB) where the host may share its memory
HOST_DRAW_BYTES = 8 << 30


def make_params(cfg, seed: int, device) -> dict:
    """The bf16 serving weights (``cast_params``' form) on ``device``, drawn
    from ``seed``. A model whose float32 draw fits ``HOST_DRAW_BYTES`` is
    drawn on the CPU, so one seed gives the same weights on any device. A
    larger one is drawn where it will live, in bf16 a layer at a time
    (``init_params(on_device=True)``), so that its float32 copy never
    exists (qwen2-moe-a2.7b's would take 60.6 GB, yi-34b's 137.6 GB); its
    numbers then come from that device's generator, and differ between the
    card and the CPU."""
    from repro_torch.models.transformer import model as M

    if 4 * M.param_numel(cfg) > HOST_DRAW_BYTES:
        return M.init_params(cfg, seed, dtype=M.COMPUTE_DTYPE, device=device, on_device=True)
    return M.params_to(M.cast_params(M.init_params(cfg, seed, device="cpu")), device)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *, forced: torch.Tensor | None = None,
             keep_logits: bool = False, dtype=torch.bfloat16, routes: list | None = None,
             forced_routes: list | None = None) -> ServeResult:
    """Prefill ``prompts`` (B, P) and decode ``gen`` tokens greedily, on the
    device the prompts and ``params`` lie on.

    ``forced`` (B, gen), when given, is fed to the decode steps in place of
    the greedy choices (teacher forcing); the tokens returned are then the
    forced ones. ``keep_logits`` keeps each decode step's logits. ``dtype``
    is the compute dtype (bf16, the serving type; float32 with float32
    parameters gives a yardstick without bf16 rounding). An MoE model's
    ``moe_block`` calls append their routing to ``routes`` in call order
    (``n_layers`` a pass: prefill, then each decode step), and take their
    experts from the record at the same place in ``forced_routes`` (another
    run's ``routes``) where given.
    """
    from repro_torch.models.transformer import model as M

    dev = prompts.device
    B, P = prompts.shape
    L = cfg.n_layers

    def pass_routes(i):
        return None if forced_routes is None else forced_routes[i * L:(i + 1) * L]

    cache = M.init_kv_cache(cfg, B, P + gen, dtype=dtype, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, prompts, cache=cache, dtype=dtype, routes=routes,
                              forced=pass_routes(0))
    tok = logits.argmax(dim=-1, keepdim=True)
    _sync(dev)
    t1 = time.perf_counter()
    if forced is not None:
        tok = forced[:, :1].to(dev)
    out, steps = [tok], []
    for i in range(gen - 1):
        step, cache = M.decode_step(params, cfg, tok, cache, P + i, dtype=dtype, routes=routes,
                                    forced=pass_routes(i + 1))
        if forced is None:
            tok = step.argmax(dim=-1, keepdim=True)
        else:
            tok = forced[:, i + 1:i + 2].to(dev)
        out.append(tok)
        if keep_logits:
            steps.append(step)
    _sync(dev)
    t2 = time.perf_counter()
    return ServeResult(tokens=torch.cat(out, dim=1).cpu(), prefill_logits=logits,
                       step_logits=steps if keep_logits else None,
                       prefill_s=t1 - t0, decode_s=t2 - t1)


def profile_serve(params, cfg, prompts: torch.Tensor, gen: int, top: int = 8) -> dict:
    """Prefill ``prompts`` and decode ``gen - 1`` steps under ``torch.profiler``
    on the card: ``obs.profile.profile_call``'s record for ``"prefill"`` and
    for ``"decode"``."""
    from repro_torch.models.transformer import model as M
    from repro_torch.obs.profile import profile_call

    dev = prompts.device
    if dev.type != "cuda":
        raise RuntimeError("profile_serve measures the card; its prompts are on the CPU")
    B, P = prompts.shape
    cache = M.init_kv_cache(cfg, B, P + gen, device=dev)
    out = {}
    (logits, cache), out["prefill"] = profile_call(
        lambda: M.prefill(params, cfg, prompts, cache=cache), dev, top)
    tok = logits.argmax(dim=-1, keepdim=True)

    def decode():
        t = tok
        for i in range(gen - 1):
            step, _ = M.decode_step(params, cfg, t, cache, P + i)
            t = step.argmax(dim=-1, keepdim=True)

    _, out["decode"] = profile_call(decode, dev, top)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) runs the CUDA kernels and fails without a card; "
                    "cpu runs their plain PyTorch versions")
    args = ap.parse_args(argv)
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be at least 1")
    try:
        from repro_torch.configs import get_config, get_smoke

        args.cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        if args.cfg.family != "lm":
            ap.error(f"--arch {args.arch} is a {args.cfg.family} model; this serves language "
                     f"models (DIN: python -m repro_torch.launch.din_serve; GraphCast weather: "
                     f"python -m repro_torch.launch.graphcast_weather)")
    except KeyError as e:
        ap.error(str(e).strip("'\""))
    return args


def main(argv=None) -> None:
    from repro_torch.platform import device_summary, resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = args.cfg
    B, P, G = args.batch, args.prompt_len, args.gen
    params = make_params(cfg, args.seed, dev)
    res = generate(params, cfg, make_prompts(cfg, B, P, dev), G)
    dt = res.prefill_s + res.decode_s
    print(f"arch={cfg.name} served batch={B} prompt={P} generated={G} "
          f"tokens in {dt:.2f}s ({B * G / dt:.1f} tok/s)")
    print("sample:", res.tokens[0][:12].tolist())
    card = device_summary(dev)
    print(f"device: {card['name']} (count {card['count']}, power limit {card['power_limit']}); "
          f"prefill {res.prefill_s * 1e3:.3f} ms, decode {res.decode_ms_per_token:.3f} ms/token")


if __name__ == "__main__":
    main()
