"""Carry DIN weights into the port.

``params_from_jax(tree, cfg=None, device=None)`` takes the reference's
parameter pytree (``repro.models.recsys.din.init_params``'s layout: the two
tables, and ``attn`` and ``mlp`` as lists of ``{"w", "b"}`` dicts) with its
leaves as numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives them,
and returns the port's tree of torch tensors on ``device`` (the card unless
``"cpu"``), dtypes kept. With a ``cfg`` the keys, the list lengths and the
shapes are checked against ``din.param_spec``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import RecSysConfig
from repro_torch.models.recsys.din import param_spec
from repro_torch.models.transformer.convert import _leaf
from repro_torch.platform import resolve_device


def _check(tree, spec, where: str = "") -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params{where}: keys {got} != expected {sorted(spec)}")
        for k, s in spec.items():
            _check(tree[k], s, f"{where}[{k!r}]")
    elif isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise ValueError(f"params{where}: {got} layers != expected {len(spec)}")
        for i, (t, s) in enumerate(zip(tree, spec)):
            _check(t, s, f"{where}[{i}]")
    elif tuple(np.shape(tree)) != tuple(spec):
        raise ValueError(f"params{where}: shape {tuple(np.shape(tree))} != expected {tuple(spec)}")


def params_from_jax(tree: dict, cfg: RecSysConfig | None = None, device=None) -> dict:
    """The reference's DIN pytree (numpy leaves) -> the port's parameters."""
    if cfg is not None:
        _check(tree, param_spec(cfg))
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf(node, dev)

    return walk(tree)
