"""Shared shape-padding helper (copy of ``repro.graph.padding``).

The degree-bucketed ELL layout rounds its widest bucket up to a multiple of
128 and its row counts up to a multiple of 8 with ``round_up``; the port
keeps the reference's rule so both packages build the same layout.
"""

from __future__ import annotations


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= x (identity when mult <= 0)."""
    return ((x + mult - 1) // mult) * mult if mult > 0 else x
