"""``--arch <id>`` registry over the 10 assigned architectures (a copy of
``repro.configs.registry``).

Every id loads: the LMs ``qwen1.5-0.5b`` (served and trained at full
width), ``qwen2-moe-a2.7b`` (MoE, served at full width), ``mixtral-8x22b``
(MoE and sliding-window attention, at full width and cut depth), ``yi-34b``
(GQA) and ``granite-34b`` (MQA, GELU MLP); the recommender ``din``
(trained, served and retrieved at full width); and the GNNs ``schnet``,
``egnn``, ``mace`` and ``graphcast`` (forward and training at full width).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ShapeSpec, shapes_for

_MODULES = {
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "din": "repro_torch.configs.din",
    "mace": "repro_torch.configs.mace",
    "graphcast": "repro_torch.configs.graphcast",
    "schnet": "repro_torch.configs.schnet",
    "egnn": "repro_torch.configs.egnn",
}

ARCH_IDS = ("qwen2-moe-a2.7b", "mixtral-8x22b", "yi-34b", "granite-34b", "qwen1.5-0.5b",
            "mace", "graphcast", "schnet", "egnn", "din")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown --arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def get_shapes(arch: str) -> tuple[ShapeSpec, ...]:
    return shapes_for(get_config(arch))


def shape_by_name(arch: str, shape: str) -> ShapeSpec:
    for s in get_shapes(arch):
        if s.name == shape:
            return s
    raise KeyError(f"{arch} has no shape {shape}")
