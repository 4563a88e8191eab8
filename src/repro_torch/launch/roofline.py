"""Roofline terms of a step on the H100 (the port of ``repro.launch.hlo_analysis``).

    compute    = sum over the products' dtypes of FLOPs / (chips x that dtype's peak FLOP/s)
    memory     = HBM bytes / (chips x HBM bytes/s)
    collective = collective bytes / (chips x link bytes/s)

The peaks are one H100 SXM's, from NVIDIA's data sheet: 989e12 FLOP/s dense
bf16 on the tensor cores, 67e12 FLOP/s float32 outside them (no TF32),
3.35e12 B/s of HBM3. ``chip_smoke.py`` reads its bounds from here too.

The reference parses the collectives out of compiled HLO text. The port has
no HLO: ``distribution.collectives.collective_bytes`` counts what
``distribution.compat.all_gather`` and ``psum`` move, from their shapes,
with the reference's ring multipliers, into the reference's
``bytes_by_kind``/``counts``/``total_bytes`` record, and its
``total_bytes`` is ``Roofline``'s ``coll_bytes``. No rate across cards has
been measured (the port's meshes are shards of one card), so
``LINK_BYTES_PER_S`` is None and ``collective_s`` is None ("not measured"
in ``to_dict``). ``roofline_from_compiled`` has no
counterpart: there is no compiled artifact to read.
"""

from __future__ import annotations

import dataclasses

import torch

BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
LINK_BYTES_PER_S = None    # not measured: no mesh across cards yet

_PEAK = {"bfloat16": BF16_FLOP_PER_S, "float16": BF16_FLOP_PER_S, "float32": F32_FLOP_PER_S}


def dtype_name(dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16`` (a name passes through)."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


def peak_flops(dtype=torch.bfloat16) -> float:
    """The card's peak FLOP/s for products in ``dtype``."""
    name = dtype_name(dtype)
    if name not in _PEAK:
        raise ValueError(f"no H100 peak is recorded for products in {name}")
    return _PEAK[name]


def bound_ms(nbytes: float, flops: float = 0.0, dtype=torch.bfloat16) -> float:
    """The least milliseconds one card takes to move ``nbytes`` through HBM
    and do ``flops`` in ``dtype``: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops(dtype)) * 1e3


@dataclasses.dataclass
class Roofline:
    """The reference's roofline terms on ``chips`` H100s. ``flops_by_dtype``
    (dtype name -> FLOPs, as ``StepCounter`` counts them) times each
    product at its own dtype's peak; without it all ``flops`` are taken in
    ``dtype``."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    dtype: object = torch.bfloat16
    flops_by_dtype: dict | None = None

    @property
    def compute_s(self) -> float:
        by = self.flops_by_dtype or {dtype_name(self.dtype): self.flops}
        return sum(f / peak_flops(d) for d, f in by.items() if f) / self.chips

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BYTES_PER_S)

    @property
    def collective_s(self) -> float | None:
        if LINK_BYTES_PER_S is None:
            return None
        return self.coll_bytes / (self.chips * LINK_BYTES_PER_S)

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "flops_by_dtype": self.flops_by_dtype or {dtype_name(self.dtype): self.flops},
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s if self.collective_s is not None else "not measured",
            "dominant": self.dominant,
        }
