"""Temporal graph subsystem (the port of ``repro.temporal``): timestamped
event streams, sliding-window k-core maintenance, and as-of queries.

Layers (built on the port's streaming maintenance engine,
``repro_torch.streaming``):

  * ``events`` — columnar timestamped edge-event logs (add/remove with
    monotone timestamps), text/npz round-trip, and temporal trace
    generators (timestamped preferential attachment, contact bursts,
    temporal SNAP analogues); a copy of the reference's;
  * ``window`` — ``WindowedKCoreEngine``: slides a count- or time-based
    window over a stream, feeding window advances to the incremental
    engine as EdgeBatches (exact cores at every boundary), plus the
    ``CoreCheckpointRing`` as-of store;
  * ``replay`` — the replay loop, recording per-step stats into a
    core-evolution trajectory with periodic BZ-oracle cross-checks.

Window and replay run on the card unless the caller passes
``device="cpu"``; every segment sum of their re-convergence runs the
``segment_sum`` kernel there.
"""

from repro_torch.streaming.server import CoreCheckpointRing
from repro_torch.temporal.events import (ADD, REMOVE, EdgeEvent, EventLog, contact_bursts,
                                         load_event_log, parse_event_text,
                                         temporal_barabasi_albert, temporal_snap_analogue)
from repro_torch.temporal.replay import ReplayRecord, ReplayTrajectory, check_step, replay
from repro_torch.temporal.window import WindowedKCoreEngine, WindowStep

__all__ = [
    "ADD",
    "REMOVE",
    "EdgeEvent",
    "EventLog",
    "parse_event_text",
    "load_event_log",
    "temporal_barabasi_albert",
    "contact_bursts",
    "temporal_snap_analogue",
    "WindowedKCoreEngine",
    "WindowStep",
    "CoreCheckpointRing",
    "ReplayRecord",
    "ReplayTrajectory",
    "replay",
    "check_step",
]
