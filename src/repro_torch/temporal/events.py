"""Timestamped edge-event logs — the temporal input format (copy of
``repro.temporal.events``, numpy only).

The paper evaluates static snapshots, but real SNAP graphs arrive as
timestamped edge events (the streaming/parallel k-core line in PAPERS.md
studies exactly this regime). An ``EventLog`` is the columnar form of such
a stream: parallel numpy arrays (time, u, v, kind) sorted by time, where
kind is +1 (add) or -1 (remove).

dataCleanse rules at construction (mirroring graph/structs.Graph):

  * self-loop events are dropped — they can never affect any window;
  * endpoints are stored canonically as (min, max) — the stream is
    undirected;
  * duplicate events are KEPT (unlike Graph edges): an add of an edge that
    is already present, or a remove of one that is absent, is a legal
    no-op at materialization time. The graph of any event range is defined
    by replaying the range onto an empty graph under set semantics —
    equivalently, an edge is present iff its LAST event in the range is an
    add (``edges_between``).

On-disk formats (graph/io.py-style loaders):

  * text — one event per line, ``t u v +`` / ``t u v -``, ``#`` comments;
  * npz  — the columnar arrays verbatim plus the vertex universe ``n``.

Trace generators at the bottom produce realistic temporal workloads:
timestamped preferential attachment, contact-network bursts, and
``temporal_snap_analogue`` which assigns growth-ordered, heavy-tailed
inter-arrival times to the existing SNAP analogues (graph/generators.py).
Every generator gives the reference's log, array for array, for the same
arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph import generators as gen
from repro_torch.graph.structs import Graph

ADD = np.int8(1)
REMOVE = np.int8(-1)


@dataclasses.dataclass(frozen=True)
class EdgeEvent:
    """One timestamped edge event (scalar view into an EventLog)."""

    t: float
    u: int
    v: int
    kind: int                 # +1 add, -1 remove

    @property
    def is_add(self) -> bool:
        return self.kind > 0


@dataclasses.dataclass(frozen=True)
class EventLog:
    """Columnar timestamped edge-event stream, sorted by time."""

    time: np.ndarray          # (E,) float64 — monotone non-decreasing
    u: np.ndarray             # (E,) int64   — canonical u < v
    v: np.ndarray             # (E,) int64
    kind: np.ndarray          # (E,) int8    — +1 add, -1 remove
    n: int                    # vertex universe (fixed over the stream)

    # ------------------------------------------------------------------ #
    @classmethod
    def make(cls, time, u, v, kind, n: int | None = None) -> "EventLog":
        """dataCleanse + canonicalize a raw event stream.

        Events must already be in time order (monotone non-decreasing);
        self-loops are dropped, endpoints canonicalized to (min, max).
        """
        time = np.asarray(time, np.float64).reshape(-1)
        u = np.asarray(u, np.int64).reshape(-1)
        v = np.asarray(v, np.int64).reshape(-1)
        kind = np.asarray(kind, np.int8).reshape(-1)
        if not (time.shape == u.shape == v.shape == kind.shape):
            raise ValueError("event columns must have equal length")
        if time.size and (np.diff(time) < 0).any():
            raise ValueError("event timestamps must be non-decreasing")
        if u.size and min(u.min(), v.min()) < 0:
            raise ValueError("negative vertex id in event log")
        if not np.isin(kind, (ADD, REMOVE)).all():
            raise ValueError("event kind must be +1 (add) or -1 (remove)")
        keep = u != v
        time, u, v, kind = time[keep], u[keep], v[keep], kind[keep]
        uu, vv = np.minimum(u, v), np.maximum(u, v)
        nn = int(n) if n is not None else (int(vv.max()) + 1 if vv.size
                                           else 0)
        if vv.size and vv.max() >= nn:
            raise ValueError(f"vertex id {int(vv.max())} outside universe "
                             f"n={nn}")
        return cls(time=time, u=uu, v=vv, kind=kind, n=nn)

    @classmethod
    def from_events(cls, events, n: int | None = None) -> "EventLog":
        """Build from an iterable of EdgeEvent / (t, u, v, kind) tuples."""
        rows = [(e.t, e.u, e.v, e.kind) if isinstance(e, EdgeEvent) else e
                for e in events]
        arr = (np.asarray(rows, np.float64).reshape(-1, 4) if rows
               else np.zeros((0, 4)))
        return cls.make(arr[:, 0], arr[:, 1], arr[:, 2],
                        arr[:, 3].astype(np.int8), n=n)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return int(self.time.shape[0])

    def __getitem__(self, i: int) -> EdgeEvent:
        return EdgeEvent(t=float(self.time[i]), u=int(self.u[i]),
                         v=int(self.v[i]), kind=int(self.kind[i]))

    @property
    def t_min(self) -> float:
        return float(self.time[0]) if len(self) else 0.0

    @property
    def t_max(self) -> float:
        return float(self.time[-1]) if len(self) else 0.0

    @property
    def num_adds(self) -> int:
        return int((self.kind > 0).sum())

    def index_at_time(self, t: float) -> int:
        """Number of events with time < t (window boundaries use [lo, hi))."""
        return int(np.searchsorted(self.time, t, side="left"))

    # ------------------------------------------------------------------ #
    def edges_between(self, lo: int, hi: int) -> np.ndarray:
        """Canonical (k, 2) edge set of event range [lo, hi).

        Defined by replay-from-empty under set semantics; since an add
        forces presence and a remove forces absence regardless of prior
        state, an edge is present iff its last event in the range is an
        add.
        """
        lo, hi = max(int(lo), 0), min(int(hi), len(self))
        if hi <= lo:
            return np.zeros((0, 2), np.int64)
        uu, vv, kk = self.u[lo:hi], self.v[lo:hi], self.kind[lo:hi]
        key = uu * np.int64(self.n) + vv
        # stable sort by key keeps time order within a key; last wins
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        last = np.flatnonzero(np.append(key_s[1:] != key_s[:-1], True))
        sel = order[last][kk[order[last]] > 0]
        edges = np.stack([uu[sel], vv[sel]], axis=1)
        return edges[np.lexsort((edges[:, 1], edges[:, 0]))]

    def graph_between(self, lo: int, hi: int) -> Graph:
        """Materialize the Graph of event range [lo, hi) on the full
        vertex universe."""
        return Graph.from_edges(self.edges_between(lo, hi), n=self.n)

    # ------------------------------------------------------------------ #
    # IO — graph/io.py-style text + columnar npz
    # ------------------------------------------------------------------ #
    def to_text(self) -> str:
        lines = [f"# temporal edge-event log n={self.n} events={len(self)}"]
        for i in range(len(self)):
            mark = "+" if self.kind[i] > 0 else "-"
            lines.append(f"{self.time[i]:.6f}\t{self.u[i]}\t{self.v[i]}"
                         f"\t{mark}")
        return "\n".join(lines) + "\n"

    def save_npz(self, path: str) -> None:
        # np.savez appends .npz when missing; normalize up front so the
        # path handed back to load_event_log always takes the npz branch
        if not str(path).endswith(".npz"):
            path = f"{path}.npz"
        np.savez(path, time=self.time, u=self.u, v=self.v, kind=self.kind,
                 n=np.int64(self.n))


def parse_event_text(text: str, n: int | None = None) -> EventLog:
    """Parse the text format: ``t u v +|-`` per line, ``#`` comments.

    A missing kind column means add (a plain timestamped edge list is a
    valid all-arrivals log); a present one must be ``+`` or ``-`` — any
    other token is rejected rather than silently treated as an add."""
    time, u, v, kind = [], [], [], []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "%")):
            continue
        parts = line.replace(",", " ").split()
        time.append(float(parts[0]))
        u.append(int(parts[1]))
        v.append(int(parts[2]))
        if len(parts) > 3:
            if parts[3] not in ("+", "-"):
                raise ValueError(f"bad event kind {parts[3]!r} in line "
                                 f"{line!r} (want + or -)")
            kind.append(REMOVE if parts[3] == "-" else ADD)
        else:
            kind.append(ADD)
    return EventLog.make(time, u, v, kind, n=n)


def load_event_log(path: str, n: int | None = None) -> EventLog:
    """Load an event log from .npz (columnar) or text (edge-event lines)."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return EventLog.make(z["time"], z["u"], z["v"], z["kind"],
                                 n=int(z["n"]) if n is None else n)
    with open(path) as f:
        return parse_event_text(f.read(), n=n)


# ---------------------------------------------------------------------- #
# Temporal trace generators
# ---------------------------------------------------------------------- #

def _heavy_tail_dt(rng: np.random.Generator, size: int,
                   mean_dt: float) -> np.ndarray:
    """Lognormal inter-arrival times (sigma=1): bursty but integrable,
    normalized to the requested mean."""
    dt = rng.lognormal(mean=0.0, sigma=1.0, size=size)
    return dt * (mean_dt / max(dt.mean(), 1e-12))

def _with_removals(time, uu, vv, rng, remove_frac: float,
                   mean_lifetime: float):
    """Give a ``remove_frac`` subset of arrivals an exponential-lifetime
    removal event; merge and re-sort by time (stable, so an edge's remove
    stays after its add under equal timestamps)."""
    kind = np.full(time.shape[0], ADD, np.int8)
    if remove_frac <= 0 or time.size == 0:
        return time, uu, vv, kind
    sel = np.flatnonzero(rng.random(time.shape[0]) < remove_frac)
    rt = time[sel] + rng.exponential(mean_lifetime, size=sel.size)
    time = np.concatenate([time, rt])
    uu = np.concatenate([uu, uu[sel]])
    vv = np.concatenate([vv, vv[sel]])
    kind = np.concatenate([kind, np.full(sel.size, REMOVE, np.int8)])
    order = np.argsort(time, kind="stable")
    return time[order], uu[order], vv[order], kind[order]


def temporal_barabasi_albert(n: int, m_attach: int, seed: int = 0,
                             mean_dt: float = 1.0,
                             remove_frac: float = 0.0,
                             mean_lifetime: float | None = None) -> EventLog:
    """Timestamped preferential attachment.

    The BA analogue's edges already carry an arrival order (vertex v joins
    at step v and attaches); we realize it as an event stream with
    heavy-tailed inter-arrival times. ``remove_frac`` of the arrivals get
    an exponential-lifetime removal event (link decay)."""
    g = gen.barabasi_albert(n, m_attach, seed=seed)
    half = g.src < g.dst
    uu = g.src[half].astype(np.int64)
    vv = g.dst[half].astype(np.int64)
    # attachment order: the joining endpoint is the larger id
    order = np.argsort(np.maximum(uu, vv), kind="stable")
    uu, vv = uu[order], vv[order]
    rng = np.random.default_rng(seed + 1)
    time = np.cumsum(_heavy_tail_dt(rng, uu.shape[0], mean_dt))
    if mean_lifetime is None:
        mean_lifetime = 0.25 * float(time[-1]) if time.size else 1.0
    return EventLog.make(*_with_removals(time, uu, vv, rng, remove_frac,
                                         mean_lifetime), n=n)


def contact_bursts(n: int, n_bursts: int = 40, group_size: int = 12,
                   edges_per_burst: int = 30, burst_len: float = 5.0,
                   gap: float = 2.0, seed: int = 0) -> EventLog:
    """Contact-network bursts: a random group meets, its contact edges
    appear spread over the burst, and every contact is torn down at the
    burst's end — a heavily add/remove-churned stream with frequent
    re-insertion of recurring contacts."""
    rng = np.random.default_rng(seed)
    time, uu, vv, kind = [], [], [], []
    t0 = 0.0
    for _ in range(n_bursts):
        group = rng.choice(n, size=min(group_size, n), replace=False)
        a = group[rng.integers(0, group.size, size=edges_per_burst)]
        b = group[rng.integers(0, group.size, size=edges_per_burst)]
        keep = a != b
        a, b = a[keep], b[keep]
        at = t0 + np.sort(rng.random(a.size)) * burst_len
        time.append(at)
        uu.append(a)
        vv.append(b)
        kind.append(np.full(a.size, ADD, np.int8))
        # teardown: every contact of the burst removed at the burst end
        end = t0 + burst_len
        time.append(np.full(a.size, end))
        uu.append(a)
        vv.append(b)
        kind.append(np.full(a.size, REMOVE, np.int8))
        t0 = end + rng.exponential(gap)
    time = np.concatenate(time) if time else np.zeros(0)
    order = np.argsort(time, kind="stable")
    return EventLog.make(time[order], np.concatenate(uu)[order],
                         np.concatenate(vv)[order],
                         np.concatenate(kind)[order], n=n)


def temporal_snap_analogue(abbrev: str, scale: float = 1.0, seed: int = 0,
                           mean_dt: float = 1.0,
                           remove_frac: float = 0.0,
                           mean_lifetime: float | None = None) -> EventLog:
    """Temporal realization of a Table-I SNAP analogue.

    Takes the static analogue's edge set (graph/generators.snap_analogue)
    and assigns realistic arrival dynamics: growth order (an edge arrives
    roughly when its younger endpoint joins, with jitter, matching how the
    social/web originals accreted) and heavy-tailed inter-arrival times.
    ``remove_frac`` turns a subset into add+remove pairs (unfriend /
    link-decay events), exercising deletions inside windows."""
    g = gen.snap_analogue(abbrev, scale=scale, seed=seed)
    return _snap_events(g, seed=seed, mean_dt=mean_dt, remove_frac=remove_frac,
                        mean_lifetime=mean_lifetime)


def _snap_events(g: Graph, seed: int = 0, mean_dt: float = 1.0,
                 remove_frac: float = 0.0,
                 mean_lifetime: float | None = None) -> EventLog:
    """``temporal_snap_analogue``'s arrival dynamics over a graph already
    made (``gen.snap_analogue(abbrev, scale, seed)`` with the same ``seed``
    gives that function's log): a caller that holds the static analogue
    does not generate it again."""
    half = g.src < g.dst
    uu = g.src[half].astype(np.int64)
    vv = g.dst[half].astype(np.int64)
    rng = np.random.default_rng(seed + 2)
    # growth order with jitter: rank by younger endpoint, perturbed so the
    # stream is not a clean vertex-id sort (real timestamps are noisy)
    rank = np.maximum(uu, vv) + rng.normal(0.0, 0.05 * max(g.n, 1),
                                           size=uu.shape[0])
    order = np.argsort(rank, kind="stable")
    uu, vv = uu[order], vv[order]
    time = np.cumsum(_heavy_tail_dt(rng, uu.shape[0], mean_dt))
    if mean_lifetime is None:
        mean_lifetime = 0.25 * float(time[-1]) if time.size else 1.0
    return EventLog.make(*_with_removals(time, uu, vv, rng, remove_frac,
                                         mean_lifetime), n=g.n)
