"""Warm-started incremental k-core engine (the port of
``repro.streaming.engine``).

Correctness rests on the locality theorem the static engine is built on
(core/kcore.py, paper §II.B): iterating est'(u) = H({min(est(v), est(u))})
converges to the exact core numbers from ANY per-vertex seed that upper
bounds them. So after a churn batch the engine only has to produce a sound
upper-bound seed — then frontier-localized supersteps re-converge exactly.

Seeding rules (all sound; the reference's docstrings hold the proofs):

  * a vertex whose core number cannot have increased keeps
    ``min(old_core, new_deg)``;
  * vertices that MAY have increased — the insertion region R — are
    re-seeded from a tight upper-bound vector: +1 passes over level-set
    components anchored at inserted edges, pruned by a support peel
    (``_insertion_upper_bound_arrays``);
  * a per-batch cost model (``core.cost_model.choose_seed``) picks between
    the tight bound and a plain degree seed.

The graph lives in a slack-padded in-place CSR (``streaming/delta.py``
``PatchableCSR``). Each batch stages its live arcs — src-sorted, so a CSR
row pointer exists — on the device once (``stage_s``); the seed and every
round of the batch run on them.

Message accounting mirrors core/messages.py: round 0 of a batch charges
deg(u) for every vertex whose seed differs from its previously broadcast
value, plus 2 messages per inserted/deleted edge; every later round charges
deg(u) per vertex whose estimate decreased.

Frontier modes (all produce identical estimates and identical bills):

  * ``dense``   — the full-width masked superstep
    (``core.kcore.masked_round_segment``, the segment-sum binary search),
    frontier as a boolean mask, one read of the round's counts a round;
  * ``compact`` — each round extracts the active vertices' subproblem on
    the device and runs the h-index over it alone (``_compact_kernel``);
  * ``fused``   — the batch's re-convergence through the fused runtime
    (``core.runtime.fused_converge_dense``), per-round bills on the device;
  * ``sharded`` — the masked superstep over a mesh's shards
    (``core.kcore.make_sharded_superstep(..., masked=True)``): the live arcs
    laid out by ``graph.partition.shard_arc_arrays`` (already src-sorted,
    so no sort), one est all_gather plus one 1-bit changed all_gather a
    round;
  * ``fused``   — on a mesh, ``fused_sharded``: the batch's re-convergence
    through ``core.runtime.fused_converge_sharded``;
  * ``auto``    — ``compact`` below ``compact_threshold`` of the vertices
    in the initial frontier, else ``fused`` (``fused_sharded`` on a mesh).

With a mesh the initial decomposition is the sharded static engine's. The
shard blocks are padded to powers of two and the arc block never shrinks
over a stream (``shard_A_floor``), the reference's geometry, so a sharded
engine's checkpoint crosses between the packages with the same leaves. On
CUDA every segment sum of the seed and the rounds runs the ``segment_sum``
kernel; on the CPU its plain version. The segment-max and scatter-max of
the upper bound are plain PyTorch, as the reference's are XLA.

Each loop's stop test (the upper bound's passes, propagations and peels;
the rounds) is one value read back to the host: ``BatchResult.flag_reads``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.cost_model import SeedCostModel, choose_seed
from repro_torch.core.kcore import (KCoreConfig, _bs_iters, _hindex_by_bsearch, _receivers,
                                    kcore_decompose, kcore_decompose_sharded,
                                    make_sharded_superstep, masked_round_segment)
from repro_torch.core.messages import MessageStats
from repro_torch.core.runtime import fused_converge_dense, fused_converge_sharded
from repro_torch.distribution import compat
from repro_torch.graph.padding import next_pow2 as _next_pow2
from repro_torch.graph.padding import round_up as _round_up
from repro_torch.graph.partition import shard_arc_arrays
from repro_torch.graph.structs import Graph
from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum.ops import segment_sum
from repro_torch.obs import flight as _flight
from repro_torch.obs import trace as _trace
from repro_torch.platform import resolve_device
from repro_torch.streaming.delta import ChurnDelta, DeltaResult, EdgeBatch, PatchableCSR

FRONTIER_MODES = ("dense", "compact", "sharded", "fused", "auto")


# ---------------------------------------------------------------------- #
# Config / result
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    frontier: str = "dense"          # one of FRONTIER_MODES
    max_rounds: int | None = None    # None -> n + 1 per batch (worst case)
    # "auto" picks compact below this initial-frontier fraction, else fused
    compact_threshold: float = 0.02
    # in-place CSR knobs (see delta.PatchableCSR)
    slack: float = 0.3
    min_slack: int = 4
    compact_dead_frac: float = 0.25
    # per-batch seeding policy (core.cost_model.choose_seed)
    seed_model: SeedCostModel = SeedCostModel()


@dataclasses.dataclass
class BatchResult:
    """Outcome of one incremental batch (the reference's fields, then the
    port's ``stage_s`` and ``flag_reads``)."""

    core: np.ndarray          # exact core numbers after the batch
    rounds: int               # supersteps to re-converge (excl. seed round)
    converged: bool
    stats: MessageStats       # per-round accounting; [0] = seed broadcast
    delta: ChurnDelta         # what the batch actually changed
    region_size: int          # |R| — insertion region that was re-seeded up
    seed_changed: int         # vertices that had to rebroadcast at seed time
    mode: str = "dense"       # execution mode this batch actually ran in
    # per-phase walls, always measured; the boundaries of the trace spans
    patch_s: float = 0.0      # host seconds spent patching the CSR in place
    seed_s: float = 0.0       # warm-start seed + initial frontier
    converge_s: float = 0.0   # re-convergence
    reconstruct_s: float = 0.0  # host-side stats assembly
    # warm-start seeding decision (core.cost_model.choose_seed)
    seed_strategy: str = "tight"
    seed_est_passes: int = 0
    # kernel-library builds this batch caused (nvcc runs; 0 = every kernel
    # was already built), and the wall they took
    recompiles: int = 0
    compile_s: float = 0.0
    # PatchableCSR health after the batch
    csr_compactions: int = 0  # cumulative O(m) compactions so far
    csr_dead_frac: float = 0.0   # hole slots / capacity (fragmentation)
    csr_occupancy: float = 0.0   # live arc slots / capacity (slack usage)
    # the live arcs' extraction and host-to-device copy (inside seed_s)
    stage_s: float = 0.0
    # loop stop tests read back to the host: the upper bound's passes,
    # propagation and peel steps, and the rounds
    flag_reads: int = 0

    @property
    def total_messages(self) -> int:
        return self.stats.total_messages


# ---------------------------------------------------------------------- #
# Warm-start seeding
# ---------------------------------------------------------------------- #

def _ub_pass_body(U, cap, src, src64, dst, row_ptr, live, ins_u, ins_v):
    """One +1 pass of the insertion upper bound over device arcs.

    Returns ``(U', raised_any, reads)``. ``live`` is None when every arc is
    live. The reference's three steps:

      1. bottleneck propagation: T(x) = max(A(x), max_{y~x} min(U(y), T(y)))
         to its fixpoint, A the best incident inserted-edge level (a
         scatter-max seeded with -1; the segment-max of each step is a
         scatter-max seeded with T, which is the reference's
         ``max(T, segment_max)``: an empty row leaves T as it is);
      2. candidates: T(x) >= U(x) and deg(x) > U(x);
      3. synchronous support peel to the greatest fixpoint: survivors keep
         > U(x) live neighbors that are survivors at the same level or sit
         strictly above it (hit counts by ``segment_sum``).
    """
    reads = 0
    k_ins = torch.minimum(U.index_select(0, ins_u), U.index_select(0, ins_v))
    A = torch.full_like(U, -1).scatter_reduce(0, ins_u, k_ins, "amax") \
        .scatter_reduce(0, ins_v, k_ins, "amax")
    U_dst = U.index_select(0, dst)
    T = A
    while True:
        val = torch.minimum(U_dst, T.index_select(0, dst))
        if live is not None:
            val = torch.where(live, val, -1)
        T2 = T.scatter_reduce(0, src64, val, "amax")
        reads += 1
        grew = bool((T2 > T).any())
        T = T2
        if not grew:
            break

    cand = (T >= U) & (cap > U)
    U_src = U.index_select(0, src)
    above, same = U_dst > U_src, U_dst == U_src
    if live is not None:
        above, same = above & live, same & live
    while True:
        qual = above | (cand.index_select(0, dst) & same)
        s = segment_sum(qual.to(torch.int32), row_ptr)
        c2 = cand & (s > U)
        reads += 1
        moved = bool((c2 != cand).any())
        cand = c2
        if not moved:
            break
    return torch.where(cand, U + 1, U), cand.any(), reads


def _ub_converge(U, cap, src, dst, row_ptr, live, ins_u, ins_v):
    """All +1 passes of the insertion upper bound, each the identical
    ``_ub_pass_body``, until a pass raises nothing. Returns ``(U, reads)``."""
    src64 = src.to(torch.int64)
    reads = 0
    while True:
        U, raised, r = _ub_pass_body(U, cap, src, src64, dst, row_ptr, live, ins_u, ins_v)
        reads += r + 1
        if not bool(raised):
            return U, reads


def _upper_bound(arcs, live, deg, old_core_ext: np.ndarray, inserted: np.ndarray):
    """The insertion upper bound over arcs staged on the device
    (``dispatch.stage_arcs``). Returns ``(U, reads)``, U (n,) int64."""
    U = old_core_ext.astype(np.int64).copy()
    n = U.shape[0]
    if inserted.size == 0 or n == 0:
        return U, 0
    src, dst, row_ptr = arcs
    dev = src.device
    U_t, reads = _ub_converge(
        torch.as_tensor(U, dtype=torch.int32, device=dev),
        torch.as_tensor(deg, dtype=torch.int32, device=dev), src, dst, row_ptr, live,
        torch.as_tensor(inserted[:, 0], dtype=torch.int64, device=dev),
        torch.as_tensor(inserted[:, 1], dtype=torch.int64, device=dev))
    return U_t.cpu().numpy().astype(np.int64), reads


def _insertion_upper_bound_arrays(n: int, src, dst, live, deg,
                                  old_core_ext: np.ndarray,
                                  inserted: np.ndarray, *, device=None) -> np.ndarray:
    """Insertion upper bound over raw (masked) arc arrays.

    ``src`` must be sorted (CSR order) but may hold dead slots (``live``
    False), as ``PatchableCSR``'s slot arrays do. ``device`` defaults to
    CUDA (see ``platform.resolve_device``).
    """
    dev = resolve_device(device)
    arcs = _dispatch.stage_arcs(src, dst, n, dev)
    live_t = torch.as_tensor(live, dtype=torch.bool, device=dev)
    return _upper_bound(arcs, live_t, deg, old_core_ext, inserted)[0]


def _insertion_upper_bound(new_g: Graph, old_core_ext: np.ndarray,
                           inserted: np.ndarray, *, device=None) -> np.ndarray:
    """Pointwise upper bound U >= new core numbers, tight around insertions
    (the batch generalization of the single-edge subcore theorem; the
    reference's docstring holds the proof of soundness)."""
    return _insertion_upper_bound_arrays(
        new_g.n, new_g.src, new_g.dst, np.ones(new_g.num_arcs, bool),
        new_g.deg, old_core_ext, inserted, device=device)


def warm_start_seed(new_g: Graph, old_core: np.ndarray,
                    delta: ChurnDelta | DeltaResult, *, device=None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Sound upper-bound seed for the new graph's core numbers.

    Returns (seed, region): seed (n,) int32 with seed >= new core pointwise;
    region (n,) bool marks the insertion region that was re-seeded upward.
    Outside the region the seed is min(old_core, new_deg).
    """
    n = new_g.n
    old_core_ext = np.zeros(n, np.int64)
    old_core_ext[: old_core.shape[0]] = old_core  # new vertices: old core 0
    new_deg = new_g.deg.astype(np.int64)

    U = _insertion_upper_bound(new_g, old_core_ext, delta.inserted, device=device)
    seed = np.minimum(U, new_deg)
    region = U > old_core_ext
    return seed.astype(np.int32), region


# ---------------------------------------------------------------------- #
# Frontier-localized re-convergence
# ---------------------------------------------------------------------- #

def _compact_kernel(est_u, est_dst_masked, src, row_ptr, n_iters):
    """h-index over a pre-gathered compact frontier subproblem."""
    new = _hindex_by_bsearch(est_u, est_dst_masked, src, row_ptr, n_iters)
    return new, new < est_u


def compact_subproblem(est, active, src, dst):
    """The active vertices' h-index subproblem over src-sorted arcs: their
    arcs (still src-sorted) with sources renumbered 0..k-1 in vertex order.
    Returns ``(act_ids, sub_src, sub_ptr, est_u, est_dst)``, ``sub_ptr`` the
    (k+1,) row pointer of ``sub_src``."""
    act_ids = active.nonzero().squeeze(1)
    local = active.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    arc_sel = active.index_select(0, src)
    sub_src = local.index_select(0, src[arc_sel])
    sub_ptr = torch.searchsorted(
        sub_src, torch.arange(act_ids.numel() + 1, dtype=torch.int32, device=est.device))
    return (act_ids, sub_src, sub_ptr, est.index_select(0, act_ids),
            est.index_select(0, dst[arc_sel]))


def _resolve_mesh(config: StreamingConfig, mesh, axis_names, device):
    """The engine's ``(mesh, axis_names, device)``: ``frontier="sharded"``
    without a mesh gets a one-shard mesh, and a mesh's device is the
    engine's."""
    if config.frontier not in FRONTIER_MODES:
        raise ValueError(f"unknown frontier mode {config.frontier!r}")
    if mesh is None:
        dev = resolve_device(device)
        if config.frontier == "sharded":
            mesh, axis_names = compat.make_mesh((1,), ("data",), device=dev), ("data",)
        return mesh, tuple(axis_names), dev
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh, tuple(axis_names), mesh.device


# ---------------------------------------------------------------------- #
# The engine
# ---------------------------------------------------------------------- #

class StreamingKCoreEngine:
    """Maintains exact core numbers of a mutating graph.

    ``__init__`` pays one static decomposition (``kcore_config``, on
    ``device``); every ``apply_batch`` then re-converges incrementally from
    the previous fixpoint. ``self.core`` is exact after every batch.
    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` for the kernels' plain versions. With ``mesh`` (a
    ``distribution.compat.Mesh`` over ``axis_names``) the engine runs on the
    mesh's device, the initial decomposition is the sharded static engine's
    (for the ``sharded``, ``fused`` and ``auto`` frontiers), and batches
    run mesh-native; a mesh never changes an answer.
    """

    def __init__(self, g: Graph, config: StreamingConfig = StreamingConfig(),
                 kcore_config: KCoreConfig = KCoreConfig(),
                 mesh=None, axis_names=("data",), *, device=None):
        self.mesh, self.axis_names, self.device = _resolve_mesh(config, mesh, axis_names,
                                                                device)
        self.config = config
        self._csr = PatchableCSR(g, slack=config.slack,
                                 min_slack=config.min_slack,
                                 compact_dead_frac=config.compact_dead_frac)
        self._graph_cache: Graph | None = g
        # high-water marks, the reference's: the binary-search depth (see
        # apply_batch), the live-arc count padded to a power of two where the
        # reference pads its dense arrays, and the sharded modes' arc block
        self._n_iters_hwm = 0
        self._arc_pad_hwm = 1
        self._shard_A_floor = 0
        if self.mesh is not None and config.frontier in ("sharded", "fused", "auto"):
            init = kcore_decompose_sharded(g, self.mesh, self.axis_names,
                                           max_rounds=kcore_config.max_rounds)
        else:
            init = kcore_decompose(g, kcore_config, device=self.device)
        self.core = init.core.astype(np.int32)
        self.init_result = init
        self.batches_applied = 0

    # ------------------------------------------------------------------ #
    @property
    def graph(self) -> Graph:
        """The current graph, materialized lazily and cached (for callers:
        oracles, benchmarks, churn samplers; the engine runs on the CSR)."""
        if self._graph_cache is None:
            self._graph_cache = self._csr.to_graph()
        return self._graph_cache

    @property
    def csr(self) -> PatchableCSR:
        return self._csr

    @property
    def n(self) -> int:
        return self._csr.n

    @property
    def m(self) -> int:
        return self._csr.m

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """The engine's exact state as numpy arrays: cores, the full
        PatchableCSR slot state and the three high-water marks, under the
        reference engine's keys, so either package's engine restores it.
        ``from_state_dict`` continues the stream from it."""
        return {
            "core": np.asarray(self.core, np.int32),
            "batches_applied": np.asarray(self.batches_applied, np.int64),
            "csr": self._csr.state_dict(),
            "arc_pad_hwm": np.asarray(self._arc_pad_hwm, np.int64),
            "n_iters_hwm": np.asarray(self._n_iters_hwm, np.int64),
            "shard_A_floor": np.asarray(self._shard_A_floor, np.int64),
        }

    @classmethod
    def from_state_dict(cls, state: dict,
                        config: StreamingConfig = StreamingConfig(),
                        mesh=None, axis_names=("data",), *, device=None
                        ) -> "StreamingKCoreEngine":
        """Warm-restart an engine from ``state_dict`` output. No
        decomposition runs: the restored cores ARE the fixpoint of the
        restored CSR."""
        eng = cls.__new__(cls)
        eng.mesh, eng.axis_names, eng.device = _resolve_mesh(config, mesh, axis_names, device)
        eng.config = config
        eng._csr = PatchableCSR.from_state(
            {k: np.asarray(v) for k, v in state["csr"].items()},
            slack=config.slack, min_slack=config.min_slack,
            compact_dead_frac=config.compact_dead_frac)
        eng._graph_cache = None
        eng._n_iters_hwm = int(np.asarray(state.get("n_iters_hwm", 0)))
        eng._arc_pad_hwm = int(np.asarray(state.get("arc_pad_hwm", 1)))
        eng._shard_A_floor = int(np.asarray(state.get("shard_A_floor", 0)))
        eng.core = np.asarray(state["core"], np.int32)
        eng.init_result = None
        eng.batches_applied = int(np.asarray(state["batches_applied"]))
        return eng

    # ------------------------------------------------------------------ #
    def _resolve_mode(self, n: int, active: np.ndarray) -> str:
        """Config frontier -> the execution mode this batch runs in: ``auto``
        picks compact below the frontier-size threshold, else fused; fused
        is ``fused_sharded`` on a mesh."""
        mode = self.config.frontier
        if mode == "auto":
            frac = float(active.sum()) / max(n, 1)
            if frac <= self.config.compact_threshold:
                return "compact"
            mode = "fused"
        if mode == "fused" and self.mesh is not None:
            return "fused_sharded"
        return mode

    def _note_padded_arcs(self, k: int) -> None:
        """Raise ``arc_pad_hwm`` where the reference pads its ``k`` live arcs
        for a dense program (the tight seed, the dense and fused modes)."""
        self._arc_pad_hwm = max(self._arc_pad_hwm, _next_pow2(max(k, 1)))

    def _shard_slots(self, n: int, src_live: np.ndarray, dst_live: np.ndarray):
        """The live arcs laid over the mesh (src-sorted by construction — no
        sort), blocks padded to powers of two with the arc block's
        high-water floor applied."""
        sg = shard_arc_arrays(n, src_live, dst_live, np.ones(src_live.size, bool),
                              self._csr.deg, compat.shard_count(self.mesh, self.axis_names),
                              pow2=True, min_arcs_per_shard=self._shard_A_floor)
        self._shard_A_floor = max(self._shard_A_floor, sg.arcs_per_shard)
        return sg

    def _sharded_step(self, n: int, n_iters: int, src_live, dst_live):
        """The per-round step of the ``sharded`` mode: the masked sharded
        superstep over this process's shards, its outputs gathered back to
        (n,) vectors."""
        mesh = self.mesh
        sg = self._shard_slots(n, src_live, dst_live)
        superstep, _ = make_sharded_superstep(sg, mesh, self.axis_names, n_iters, masked=True)
        V, pad = sg.verts_per_shard, sg.n_pad - n
        lo, hi = mesh.shard_offset * V, (mesh.shard_offset + mesh.local_shards) * V

        def step(est, active):
            est_l = torch.cat([est, est.new_zeros(pad)])[lo:hi]
            act_l = torch.cat([active, active.new_zeros(pad)])[lo:hi]
            new_l, ch_l, recv_l, _msgs = superstep(est_l, act_l)
            return tuple(compat.all_gather(t, mesh)[:n] for t in (new_l, ch_l, recv_l))

        return step

    @staticmethod
    def _make_step(mode: str, arcs: tuple, n_iters: int):
        """The per-round ``step(est, active) -> (new_est, changed, recv)``
        of one batch over the staged live arcs (``dense`` or ``compact``);
        every mode is exact-equal."""
        src, dst, row_ptr = arcs
        if mode == "dense":
            return lambda est, active: masked_round_segment(est, src, dst, row_ptr, None, active,
                                                            n_iters)

        def step(est, active):
            act_ids, sub_src, sub_ptr, est_u, est_dst = compact_subproblem(est, active, src, dst)
            new_sub, ch_sub = _compact_kernel(est_u, est_dst, sub_src, sub_ptr, n_iters)
            new_est = est.index_copy(0, act_ids, new_sub)
            changed = torch.zeros_like(active).index_copy_(0, act_ids, ch_sub)
            return new_est, changed, _receivers(changed, dst, row_ptr)

        return step

    # ------------------------------------------------------------------ #
    def apply_batch(self, batch: EdgeBatch) -> BatchResult:
        """Apply one churn batch and re-converge to exact cores.

        When tracing is enabled (``obs.trace``) each batch emits a ``batch``
        span with ``csr-patch`` / ``seed`` / ``converge`` /
        ``host-reconstruct`` children (``fused`` nests the runtime's
        ``fused-converge`` tree under ``converge``). The same boundaries are
        always measured into ``BatchResult.patch_s`` / ``seed_s`` /
        ``converge_s`` / ``reconstruct_s``.
        """
        with _trace.span("batch", batch_id=self.batches_applied) as bsp:
            res, end_ns = self._apply_batch_body(batch, bsp.start_ns)
            bsp.set(mode=res.mode, rounds=res.rounds,
                    messages=res.stats.total_messages,
                    converged=res.converged,
                    seed_strategy=res.seed_strategy,
                    region=res.region_size,
                    recompiles=res.recompiles,
                    compile_s=round(res.compile_s, 6))
            bsp.end_at(end_ns)
        return res

    def _apply_batch_body(self, batch: EdgeBatch, start_ns) -> tuple:
        """The batch's phases: ``(result, end_ns)``, the last phase span's
        end. The four phase spans tile the batch span (``obs/trace.py``):
        each starts where the one before it ended, the first at the batch's
        ``start_ns``, and the batch ends at ``end_ns``. The host work between
        phases counts to the phase after it, so no stretch of the batch lies
        outside its phases however the thread is scheduled (a preemption, or
        another thread taking the interpreter between two phases)."""
        builds0, bsecs0 = _build.build_count(), _build.build_seconds()
        dev = self.device
        t0 = time.perf_counter()
        with _trace.span("csr-patch", start_ns=start_ns) as psp:
            delta = self._csr.apply_batch(batch)
        patch_s = time.perf_counter() - t0
        self._graph_cache = None
        csr = self._csr
        n = csr.n
        deg64 = csr.deg.astype(np.int64)
        reads = 0

        t_seed = time.perf_counter()
        with _trace.span("seed", start_ns=psp.end_ns) as ssp:
            old_core_ext = np.zeros(n, np.int64)
            old_core_ext[: self.core.shape[0]] = self.core
            seed_choice = choose_seed(delta.inserted, csr.deg, old_core_ext,
                                      model=self.config.seed_model)
            t_stage = time.perf_counter()
            # the live arcs only, still src-sorted: row-major slot order
            # survives boolean filtering
            src_live, dst_live = csr.src[csr.live], csr.dst[csr.live]
            arcs = _dispatch.stage_arcs(src_live, dst_live, n, dev)
            stage_s = time.perf_counter() - t_stage
            if seed_choice.strategy == "degree":
                U = deg64.copy()
            else:
                self._note_padded_arcs(src_live.size)
                U, reads = _upper_bound(arcs, None, csr.deg, old_core_ext, delta.inserted)
            seed = np.minimum(U, deg64).astype(np.int32)
            region = U > old_core_ext
            old_core32 = old_core_ext.astype(np.int32)

            # ---- round 0: seed broadcast + link handshakes ------------ #
            seed_changed = seed != old_core32
            msgs = [int(deg64[seed_changed].sum())
                    + 2 * int(delta.inserted.shape[0])
                    + 2 * int(delta.deleted.shape[0])]
            changed_counts = [int(seed_changed.sum())]

            # ---- initial frontier ------------------------------------- #
            # recompute u iff its h-index inputs changed: an incident edge
            # appeared/disappeared, or a neighbor's broadcast value changed.
            active = np.zeros(n, bool)
            touched = delta.touched[delta.touched < n]
            active[touched] = True
            active |= seed_changed
            if seed_changed.any():
                active |= _receivers(torch.as_tensor(seed_changed, device=dev), arcs[1],
                                     arcs[2]).cpu().numpy()
            ssp.set(strategy=seed_choice.strategy,
                    region=int(region.sum()),
                    frontier=int(active.sum()))
        seed_s = time.perf_counter() - t_seed
        # active_per_round follows the static engine's convention:
        # [r] = vertices recomputing/broadcasting in round r. Round 0 is the
        # seed rebroadcast; round 1's recomputers are the initial frontier.
        actives = [int(seed_changed.sum()), int(active.sum())]

        mode = self._resolve_mode(n, active)
        # flight: one run per churn batch; round 0 = seed rebroadcast +
        # link handshakes (no prev_est: the seed moves both ways)
        rec = _flight.recorder()
        if rec.active:
            rec.start_run("streaming", mode, batch=self.batches_applied, n=n)
            rec.record_round(actives[0], msgs[0], changed_counts[0], est=seed)
        rounds, converged = 0, False
        cap = (self.config.max_rounds if self.config.max_rounds is not None
               else n + 1)
        # the binary-search depth is the reference's: bucketed (multiple of
        # 4) and high-water-marked. Extra probes leave the h-index unchanged.
        n_iters = _round_up(_bs_iters(int(csr.deg.max()) if n else 0), 4)
        n_iters = self._n_iters_hwm = max(n_iters, self._n_iters_hwm)

        t_conv = time.perf_counter()
        with _trace.span("converge", start_ns=ssp.end_ns, mode=mode) as csp:
            if mode in ("fused", "fused_sharded"):
                if active.any():
                    if mode == "fused":
                        self._note_padded_arcs(src_live.size)
                        outcome = fused_converge_dense(
                            seed, active, arcs[0], arcs[1], None, csr.deg, row_ptr=arcs[2], n=n,
                            n_iters=n_iters, max_rounds=cap, device=dev)
                    else:
                        outcome = fused_converge_sharded(
                            seed, active, self._shard_slots(n, src_live, dst_live), self.mesh,
                            self.axis_names, n=n, n_iters=n_iters, max_rounds=cap)
                    core, rounds = outcome.est, outcome.rounds
                    converged = outcome.converged
                    reads += rounds
                    msgs.extend(outcome.msgs.tolist())
                    changed_counts.extend(outcome.changed.tolist())
                    actives.extend(outcome.recv.tolist())
                else:
                    core, converged = np.asarray(seed, np.int32), True
            else:
                if mode == "dense":
                    self._note_padded_arcs(src_live.size)
                step = (self._sharded_step(n, n_iters, src_live, dst_live) if mode == "sharded"
                        else self._make_step(mode, arcs, n_iters))
                est = torch.as_tensor(seed, device=dev)
                act = torch.as_tensor(active, device=dev)
                deg_t = torch.as_tensor(csr.deg, device=dev)
                n_active = actives[1]
                while rounds < cap and n_active:
                    t_r = time.perf_counter() if rec.active else 0.0
                    with _trace.span("kcore.round", round=rounds):
                        new_est, ch, recv = step(est, act)
                        rounds += 1
                        m_r, c_r, n_active = torch.stack(
                            [torch.where(ch, deg_t, 0).sum(), ch.sum(), recv.sum()]).tolist()
                        reads += 1
                        if not c_r:
                            converged = True
                            break
                        msgs.append(m_r)
                        changed_counts.append(c_r)
                        if rec.active:
                            rec.record_round(
                                actives[rounds], msgs[-1], changed_counts[-1],
                                est=new_est.cpu().numpy(), prev_est=est.cpu().numpy(),
                                host_s=time.perf_counter() - t_r)
                        act = recv
                        actives.append(n_active)
                        est = new_est
                if not n_active:
                    converged = True
                core = est.cpu().numpy().astype(np.int32)
        converge_s = time.perf_counter() - t_conv

        t_rec = time.perf_counter()
        with _trace.span("host-reconstruct", start_ns=csp.end_ns) as hsp:
            stats = MessageStats(
                messages_per_round=np.asarray(msgs, np.int64),
                active_per_round=np.asarray(actives[: len(msgs)], np.int64),
                changed_per_round=np.asarray(changed_counts[: len(msgs)],
                                             np.int64),
            )
            self.core = core
            self.batches_applied += 1
            cap_slots = max(csr.capacity, 1)
            if rec.active:
                rec.end_run(converged=converged,
                            messages=int(stats.total_messages))
            reconstruct_s = time.perf_counter() - t_rec
            res = BatchResult(core=core, rounds=rounds, converged=converged,
                              stats=stats, delta=delta,
                              region_size=int(region.sum()),
                              seed_changed=int(seed_changed.sum()),
                              mode=mode, patch_s=patch_s,
                              seed_s=seed_s, converge_s=converge_s,
                              reconstruct_s=reconstruct_s,
                              seed_strategy=seed_choice.strategy,
                              seed_est_passes=seed_choice.est_passes,
                              recompiles=_build.build_count() - builds0,
                              compile_s=_build.build_seconds() - bsecs0,
                              csr_compactions=int(csr.compactions),
                              csr_dead_frac=csr.dead / cap_slots,
                              csr_occupancy=2 * csr.m / cap_slots,
                              stage_s=stage_s, flag_reads=reads)
        return res, hsp.end_ns
