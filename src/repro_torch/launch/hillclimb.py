"""Perf-iteration tool (the port of ``repro.launch.hillclimb``): counts
VARIANTS of the hill-climb cells on ``meta`` and prints their roofline
terms on one H100, without touching the dry-run's records.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb mixtral_cap110
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --list

``measure(cfg, arch, shape)`` takes the variant's config as an argument
(``dryrun.meta_count(..., cfg=)``), where the reference swaps the registry's
function for the call. Each result has the reference's keys: the
``compute_s``/``memory_s``/``collective_s`` terms with the H100's peaks
(``launch.roofline``; ``collective_s`` "not measured"), the ``dominant``
term, ``mem_GB`` (the arguments and outputs: the temporaries are not
measured on ``meta``) and ``compile_s`` (here the wall of the count).
``din_fullshard`` needs DIN on a mesh and fails, naming ROADMAP.md Queue A
item 12b.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import _MESH, meta_count


def measure(arch_cfg, arch: str, shape_name: str) -> dict:
    """Count a (possibly modified) config on one cell; return its terms."""
    t0 = time.perf_counter()
    rec = meta_count(arch, shape_name, cfg=arch_cfg)
    roof = rec["roofline"]
    coll = roof["collective_s"]
    return {
        "compute_s": round(roof["compute_s"], 4),
        "memory_s": round(roof["memory_s"], 4),
        "collective_s": coll if isinstance(coll, str) else round(coll, 4),
        "dominant": roof["dominant"],
        "mem_GB": round(rec["memory"]["args_and_outputs_bytes"] / 1e9, 2),
        "compile_s": round(time.perf_counter() - t0, 1),
    }


VARIANTS = {}


def variant(name):
    def deco(fn):
        VARIANTS[name] = fn
        return fn
    return deco


def _moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


@variant("mixtral_base")
def mixtral_base():
    return measure(get_config("mixtral-8x22b"), "mixtral-8x22b", "train_4k")


@variant("mixtral_cap110")
def mixtral_cap110():
    cfg = _moe(get_config("mixtral-8x22b"), capacity_factor=1.10)
    return measure(cfg, "mixtral-8x22b", "train_4k")


@variant("mixtral_dots_remat")
def mixtral_dots_remat():
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), remat_policy="dots")
    return measure(cfg, "mixtral-8x22b", "train_4k")


@variant("mixtral_cap110_dots")
def mixtral_cap110_dots():
    cfg = dataclasses.replace(_moe(get_config("mixtral-8x22b"), capacity_factor=1.10),
                              remat_policy="dots")
    return measure(cfg, "mixtral-8x22b", "train_4k")


@variant("mixtral_micro4_dots")
def mixtral_micro4_dots():
    cfg = dataclasses.replace(_moe(get_config("mixtral-8x22b"), capacity_factor=1.10),
                              remat_policy="dots", train_microbatches=16)
    return measure(cfg, "mixtral-8x22b", "train_4k")


@variant("mixtral_alldots")
def mixtral_alldots():
    cfg = dataclasses.replace(_moe(get_config("mixtral-8x22b"), capacity_factor=1.10),
                              remat_policy="all_dots", train_microbatches=16)
    return measure(cfg, "mixtral-8x22b", "train_4k")


@variant("mixtral_alldots_m64")
def mixtral_alldots_m64():
    cfg = dataclasses.replace(_moe(get_config("mixtral-8x22b"), capacity_factor=1.10),
                              remat_policy="all_dots", train_microbatches=64)
    return measure(cfg, "mixtral-8x22b", "train_4k")


@variant("graphcast_products")
def graphcast_products():
    return measure(get_config("graphcast"), "graphcast", "ogb_products")


@variant("din_train")
def din_train():
    return measure(get_config("din"), "din", "train_batch")


@variant("qwen2moe_base")
def qwen2moe_base():
    return measure(get_config("qwen2-moe-a2.7b"), "qwen2-moe-a2.7b", "train_4k")


@variant("qwen2moe_cap105")
def qwen2moe_cap105():
    cfg = dataclasses.replace(_moe(get_config("qwen2-moe-a2.7b"), capacity_factor=1.05),
                              remat_policy="dots")
    return measure(cfg, "qwen2-moe-a2.7b", "train_4k")


@variant("din_fullshard")
def din_fullshard():
    # the reference shards DIN's item table over the whole mesh
    # (REPRO_DIN_FULLSHARD) with n_items padded to 1,000,448
    raise NotImplementedError(f"din_fullshard shards DIN over a mesh, which is not ported yet: "
                              f"{_MESH}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(VARIANTS))
        return
    for name in (args.names or list(VARIANTS)):
        res = VARIANTS[name]()
        print(f"{name}: {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    main()
