"""The MLP of ``repro.models.gnn.common`` (``mlp_init``, ``mlp_apply``).

Layers are a list of ``{"w": (in, out), "b": (out,)}`` dicts in the
reference's layout: weights drawn N(0, 1/in) from a ``torch.Generator``,
zero biases, SiLU between layers and none after the last. The rest of the
reference's module (segment sums, message passing) waits for the GNN slice
(ROADMAP.md Queue A item 12).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32, device=None) -> list[dict]:
    """One ``{"w", "b"}`` dict per pair of consecutive ``sizes``; the draws
    come from ``gen``, on its device, in layer order."""
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, dtype=dtype, device=device) * (1.0 / math.sqrt(a))
        layers.append({"w": w, "b": torch.zeros((b,), dtype=dtype, device=device)})
    return layers


def mlp_apply(layers: list[dict], x: torch.Tensor, act=F.silu, final_act: bool = False):
    """``x @ w + b`` per layer, ``act`` between layers (and after the last
    with ``final_act``). Outside autograd the activation runs in place, which
    saves one activation-sized buffer a layer."""
    for i, layer in enumerate(layers):
        x = F.linear(x, layer["w"].to(x.dtype).t(), layer["b"].to(x.dtype))
        if i < len(layers) - 1 or final_act:
            x = act(x, inplace=True) if act is F.silu and not torch.is_grad_enabled() else act(x)
    return x
