"""``value_and_grad`` over a parameter tree, the counterpart of
``jax.value_and_grad`` that the GNN and LM train steps share."""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree, unflatten


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)``, ``grads`` shaped as
    ``params``; a leaf the loss does not reach gets zeros, as in JAX."""
    with torch.enable_grad():
        live = map_tree(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, *args)
        grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves(live), grads)]
    return loss.detach(), unflatten(params, grads)
