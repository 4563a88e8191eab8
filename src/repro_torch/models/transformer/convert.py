"""Carry weights and optimizer state into the port: the first weight carrier.

``params_from_jax(tree)`` takes the reference's parameter pytree (the key
layout of ``repro.models.transformer.model.init_params``, stacked ``(L, ...)``
leaves, an MoE model's nested ``layers["moe"]`` and ``["moe"]["shared"]``
among them) with its leaves as numpy arrays, as ``jax.tree.map(np.asarray,
params)`` gives them, and returns the port's parameter tree of torch
tensors. ``opt_state_from_jax(tree)`` does the same for the reference's
AdamW state ``{"m", "v", "count"}``, so a JAX step and a port step can start
from the same state. Nothing of JAX is imported: numpy arrays are the
interface. With a ``cfg`` the trees' keys and shapes are checked against
``model.param_spec``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer.model import param_spec
from repro_torch.platform import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, which torch.from_numpy does not read
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _check(tree: dict, spec: dict, where: str = "") -> None:
    if set(tree) != set(spec):
        raise ValueError(f"params{where}: keys {sorted(tree)} != expected {sorted(spec)}")
    for k, s in spec.items():
        if isinstance(s, dict):
            if not isinstance(tree[k], dict):
                raise ValueError(f"params{where}[{k!r}] must be a dict")
            _check(tree[k], s, f"{where}[{k!r}]")
        elif tuple(np.shape(tree[k])) != tuple(s[0]):
            raise ValueError(f"params{where}[{k!r}]: shape {tuple(np.shape(tree[k]))} != "
                             f"expected {tuple(s[0])}")


def params_from_jax(tree: dict, cfg: LMConfig | None = None, device=None) -> dict:
    """The reference's pytree (numpy leaves) -> the port's parameters on
    ``device`` (the card unless ``"cpu"``), dtypes kept."""
    if cfg is not None:
        _check(tree, param_spec(cfg))
    dev = resolve_device(device)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else _leaf(v, dev) for k, v in node.items()}

    return walk(tree)


def opt_state_from_jax(tree: dict, cfg: LMConfig | None = None, device=None) -> dict:
    """The reference's AdamW state ``{"m", "v", "count"}`` (numpy leaves) ->
    the port's on ``device`` (the card unless ``"cpu"``), dtypes kept: the
    moments as ``params_from_jax`` carries parameters, ``count`` a 0-d
    tensor."""
    if set(tree) != {"m", "v", "count"}:
        raise ValueError(f"opt state: keys {sorted(tree)} != ['count', 'm', 'v']")
    if np.shape(tree["count"]) != ():
        raise ValueError(f"opt state: count must be a scalar, got shape {np.shape(tree['count'])}")
    return {"m": params_from_jax(tree["m"], cfg, device), "v": params_from_jax(tree["v"], cfg, device),
            "count": _leaf(tree["count"], resolve_device(device))}
