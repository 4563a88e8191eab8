"""Bytes on the wire of the mesh's collectives, from their shapes.

``compat.all_gather`` and ``compat.psum`` over a mesh of more than one shard
note each call here (``note_collective``), whether or not it crosses a
process. ``collective_bytes`` tallies them into the record that the
reference's ``repro.launch.hlo_analysis.collective_bytes`` parses out of HLO
text: ``{"bytes_by_kind", "counts", "total_bytes"}``, with its ring
multipliers (all-gather: result bytes x (n-1)/n; all-reduce: 2 x operand
bytes x (n-1)/n). ``launch/roofline.py`` and ``launch/dryrun.py`` read it.

Tallies are open per thread, as the step counter of ``launch/step_cost.py``
is. With none open on the calling thread, noting a collective checks one
list and does nothing else.
"""

from __future__ import annotations

import threading


class _Tallies(threading.local):
    def __init__(self):
        self.open: list = []


_tallies = _Tallies()


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes on the wire of one collective over ``group`` members, the
    reference's ring multipliers: ``nbytes`` is the all-gather's result and
    the all-reduce's operand."""
    ring = (group - 1) / max(group, 1)
    if kind == "all-gather":
        return nbytes * ring
    if kind == "all-reduce":
        return 2 * nbytes * ring
    raise ValueError(f"unknown collective {kind!r}")


def note_collective(kind: str, nbytes: float, group: int) -> None:
    """Add one collective to every ``collective_bytes`` tally open on this
    thread."""
    if not _tallies.open:
        return
    b = wire_bytes(kind, nbytes, group)
    for t in _tallies.open:
        t["bytes_by_kind"][kind] = t["bytes_by_kind"].get(kind, 0.0) + b
        t["counts"][kind] = t["counts"].get(kind, 0) + 1
        t["total_bytes"] += b


class collective_bytes:
    """Tally the collectives run inside on this thread: ``with
    collective_bytes() as tally`` gives the reference's record,
    ``{"bytes_by_kind", "counts", "total_bytes"}``, filled as they run."""

    def __enter__(self) -> dict:
        self.tally = {"bytes_by_kind": {}, "counts": {}, "total_bytes": 0.0}
        _tallies.open.append(self.tally)
        return self.tally

    def __exit__(self, *exc):
        _tallies.open.remove(self.tally)
