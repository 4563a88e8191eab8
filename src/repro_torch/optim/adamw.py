"""AdamW with global-norm gradient clipping (a copy of ``repro.optim.adamw``).

Functional, as the reference is: ``adamw_update`` returns new parameters and
a new state and changes nothing it is given. Parameters, gradients and
moments are trees of tensors (``repro_torch.tree``). The update is the
reference's exactly: the gradients are scaled by ``min(1, clip / (norm +
1e-9))``, the bias corrections come from the step count as float32, and the
weight decay is added to the step before it is scaled by ``lr``. Moments are
float32 (float64 for float64 parameters), and the update is dense over every
entry, the whole 18M-entry item table of DIN included.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, map_tree, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _moment_dtype(p: torch.Tensor) -> torch.dtype:
    return torch.promote_types(p.dtype, torch.float32)


def adamw_init(params) -> dict:
    first = leaves(params)[0]
    return {
        "m": map_tree(lambda p: torch.zeros_like(p, dtype=_moment_dtype(p)), params),
        "v": map_tree(lambda p: torch.zeros_like(p, dtype=_moment_dtype(p)), params),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    ``leaves`` order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(_moment_dtype(x))))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    mdt = leaves(state["m"])[0].dtype
    c1 = 1.0 - cfg.b1 ** count.to(mdt)
    c2 = 1.0 - cfg.b2 ** count.to(mdt)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.to(m.dtype) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(m.dtype)
        return (p.to(m.dtype) - lr * step).to(p.dtype), m, v

    out = [upd(*t) for t in zip(leaves(params), leaves(grads), leaves(state["m"]),
                                leaves(state["v"]))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics
