"""``value_and_grad`` over a parameter tree, the counterpart of
``jax.value_and_grad`` that the GNN and LM train steps share."""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree, unflatten


def value_and_grad(loss_fn, params, *args, seed: float = 1.0):
    """``(loss, grads)`` of ``loss_fn(params, *args)``, ``grads`` shaped as
    ``params``; a leaf the loss does not reach gets zeros, as in JAX. The
    gradients are ``seed`` times the loss's (a process's share of a loss
    held whole on a mesh of several processes: ``distribution/compat.py``)."""
    with torch.enable_grad():
        live = map_tree(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, *args)
        grads = torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                    grad_outputs=None if seed == 1.0 else torch.full_like(loss, seed))
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves(live), grads)]
    return loss.detach(), unflatten(params, grads)
