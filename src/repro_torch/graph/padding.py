"""Shared shape-padding helpers (copy of ``repro.graph.padding``).

The degree-bucketed ELL layout rounds its widest bucket up to a multiple of
128 and its row counts up to a multiple of 8 with ``round_up``, and the
shard layout (``graph/partition.py``) rounds its blocks the same way; the
port keeps the reference's rules so both packages build the same layouts.
``next_pow2`` is the reference's power-of-two padding of the shard layout.
"""

from __future__ import annotations


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= x (identity when mult <= 0)."""
    return ((x + mult - 1) // mult) * mult if mult > 0 else x


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()
