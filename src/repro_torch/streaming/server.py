"""The as-of store of the query server (the first part of the port of
``repro.streaming.server``).

``CoreCheckpointRing`` is a bounded ring of (t, core) snapshots pushed at
window boundaries (temporal replay, ``repro_torch.temporal``), answering
"core numbers at time t" in O(log capacity) for any retained boundary;
``AsofView`` is an immutable snapshot of it that reader threads can share.
``repro_torch.temporal`` re-exports the ring, as the reference does. The
server itself (``KCoreServer``, its request loop and metrics) is ROADMAP.md
Queue A item 7.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _asof_lookup(times, cores, t: float) -> tuple[float, np.ndarray]:
    """Shared as-of search over parallel (times, cores) sequences."""
    if not times:
        raise KeyError("no checkpoints retained")
    i = int(np.searchsorted(np.asarray(times), float(t),
                            side="right")) - 1
    if i < 0:
        raise KeyError(
            f"t={t} predates the oldest retained boundary "
            f"({times[0]}); increase the ring capacity")
    return times[i], cores[i]


@dataclasses.dataclass(frozen=True)
class AsofView:
    """Immutable as-of store: a frozen (times, cores) snapshot of a
    CoreCheckpointRing. Core arrays are the ring's read-only copies, so
    the view can be shared across reader threads freely."""

    times: tuple[float, ...]
    cores: tuple[np.ndarray, ...]

    def __len__(self) -> int:
        return len(self.times)

    def asof(self, t: float) -> tuple[float, np.ndarray]:
        return _asof_lookup(self.times, self.cores, t)


class CoreCheckpointRing:
    """Bounded ring of (t, core) snapshots for as-of queries.

    ``push`` records the core vector at a window boundary (a read-only
    copy — retained history cannot be corrupted through the returned
    references); ``asof(t)`` returns the snapshot at the latest retained
    boundary with boundary-time <= t — an O(log capacity) searchsorted
    plus an O(1) vector reference, independent of graph size or stream
    length. Callers that want to mutate the result must copy it."""

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._times: list[float] = []
        self._cores: list[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._times)

    @property
    def times(self) -> np.ndarray:
        """Retained boundary times, oldest first."""
        return np.asarray(self._times, np.float64)

    def push(self, t: float, core: np.ndarray) -> None:
        t = float(t)
        if self._times and t < self._times[-1]:
            raise ValueError("checkpoint times must be non-decreasing")
        snap = np.asarray(core, np.int32).copy()
        snap.setflags(write=False)
        self._times.append(t)
        self._cores.append(snap)
        if len(self._times) > self.capacity:
            del self._times[0], self._cores[0]

    def asof(self, t: float) -> tuple[float, np.ndarray]:
        """(boundary_time, core) at the latest boundary <= t."""
        return _asof_lookup(self._times, self._cores, t)

    def snapshot(self) -> "AsofView":
        """Immutable view of the currently retained boundaries.

        O(len) tuple copy of the (already read-only) snapshot references —
        the concurrent server freezes one of these into each published
        ``CoreSnapshot`` so as-of reads stay consistent with the core
        vector they were flipped with, no matter how far the writer's ring
        has advanced since."""
        return AsofView(tuple(self._times), tuple(self._cores))

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Checkpointable pytree: boundary times (k,) + cores stacked to
        (k, n). Fixed leaf COUNT regardless of occupancy, so a restore
        target's structure never depends on how full the ring was."""
        if self._cores:
            cores = np.stack([np.asarray(c, np.int32) for c in self._cores])
        else:
            cores = np.zeros((0, 0), np.int32)
        return {"times": np.asarray(self._times, np.float64), "cores": cores}

    def load_state(self, state: dict) -> None:
        """Restore retained boundaries in place (capacity is config)."""
        times = np.asarray(state["times"], np.float64).reshape(-1)
        cores = np.asarray(state["cores"], np.int32)
        keep = min(times.shape[0], self.capacity)
        times, cores = times[-keep:] if keep else times[:0], \
            cores[-keep:] if keep else cores[:0]
        self._times, self._cores = [], []
        for t, core in zip(times.tolist(), cores):
            snap = core.copy()
            snap.setflags(write=False)
            self._times.append(float(t))
            self._cores.append(snap)
