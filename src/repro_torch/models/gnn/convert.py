"""Carry GNN weights into the port.

``params_from_jax(tree, cfg, device=None)`` takes a reference parameter
pytree with its leaves as numpy arrays, as ``jax.tree.map(np.asarray,
params)`` gives them: either ``repro.models.gnn.steps.init_params``'s (the
model's entries, ``classify`` when it has a head) or
``graphcast.init_weather_params``'s. The reference stacks the per-layer
``blocks`` along a leading ``n_layers`` axis; the port keeps a list of
per-layer dicts, so the stacking is undone here. Keys, list lengths and
shapes are checked against the model's ``param_spec`` (``d_in`` and
``n_classes`` read off the tree's ``proj_in``/``encode`` and ``classify``).
Leaves go to ``device`` (the card unless ``"cpu"``), dtypes kept.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import graphcast, steps
from repro_torch.models.transformer.convert import _leaf
from repro_torch.platform import resolve_device


def _check(tree, spec, where: str = "", lead: tuple = ()) -> None:
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params{where}: keys {got} != expected {sorted(spec)}")
        for k, s in spec.items():
            _check(tree[k], s, f"{where}[{k!r}]", lead)
    elif isinstance(spec, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise ValueError(f"params{where}: {got} layers != expected {len(spec)}")
        for i, (t, s) in enumerate(zip(tree, spec)):
            _check(t, s, f"{where}[{i}]", lead)
    elif spec is None:
        if tree is not None:
            raise ValueError(f"params{where}: expected None")
    elif tuple(np.shape(tree)) != (*lead, *spec):
        raise ValueError(f"params{where}: shape {tuple(np.shape(tree))} != expected "
                         f"{(*lead, *spec)}")


def _spec(tree: dict, cfg: GNNConfig) -> dict:
    if "grid_encode" in tree:
        return graphcast.weather_param_spec(cfg)
    first = tree.get("encode") if cfg.kind == "graphcast" else tree.get("proj_in")
    try:
        d_in = int(np.shape(first[0]["w"])[0])
    except (TypeError, KeyError, IndexError):   # no proj_in (None), or a tree _check refuses
        d_in = None
    n_classes = int(np.shape(tree["classify"])[-1]) if "classify" in tree else 0
    return steps.param_spec(cfg, d_in, n_classes)


def params_from_jax(tree: dict, cfg: GNNConfig, device=None) -> dict:
    """The reference's pytree (numpy leaves) -> the port's parameters."""
    if not isinstance(tree, dict):
        raise ValueError(f"params: expected a dict, got {type(tree).__name__}")
    spec = _spec(tree, cfg)
    if set(tree) != set(spec):
        raise ValueError(f"params: keys {sorted(tree)} != expected {sorted(spec)}")
    block_spec = spec.pop("blocks")
    _check({k: tree[k] for k in spec}, spec)
    _check(tree["blocks"], block_spec, "['blocks']", (cfg.n_layers,))
    dev = resolve_device(device)

    def walk(node, pick=None):
        if isinstance(node, dict):
            return {k: walk(v, pick) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, pick) for v in node]
        if node is None:
            return None
        return _leaf(node if pick is None else np.asarray(node)[pick], dev)

    out = {k: walk(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [walk(tree["blocks"], i) for i in range(cfg.n_layers)]
    return out
