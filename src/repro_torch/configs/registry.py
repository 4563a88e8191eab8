"""``--arch <id>`` registry over the 10 assigned architectures (a copy of
``repro.configs.registry``).

The port holds the configs of the architectures it runs: the dense LMs
``qwen1.5-0.5b`` (served at full width), and ``yi-34b`` (GQA) and
``granite-34b`` (MQA, GELU MLP), whose ``SMOKE`` variants the tests use;
the recommender ``din`` (trained, served and retrieved at full width); and
the GNNs ``schnet``, ``egnn``, ``mace`` and ``graphcast``, whose forward
paths run at full width (GraphCast's weather rollout among them). For the
MoE ids ``get_config``/``get_smoke`` raise ``NotImplementedError``
naming the ROADMAP.md items that will port them.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ShapeSpec, shapes_for

_MODULES = {
    "yi-34b": "repro_torch.configs.yi_34b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1p5_0p5b",
    "din": "repro_torch.configs.din",
    "mace": "repro_torch.configs.mace",
    "graphcast": "repro_torch.configs.graphcast",
    "schnet": "repro_torch.configs.schnet",
    "egnn": "repro_torch.configs.egnn",
}

_NOT_PORTED = {
    "qwen2-moe-a2.7b": "ROADMAP.md Queue A item 17 (MoE)",
    "mixtral-8x22b": "ROADMAP.md Queue A items 17 and 18 (MoE; sliding-window attention)",
}

ARCH_IDS = ("qwen2-moe-a2.7b", "mixtral-8x22b", "yi-34b", "granite-34b", "qwen1.5-0.5b",
            "mace", "graphcast", "schnet", "egnn", "din")


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"--arch {arch} is not ported yet: {_NOT_PORTED[arch]}")
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
