"""Out-of-core block-cycling k-core decomposition: bounded device memory.

The port of ``repro.core.outofcore``. The in-memory modes (host loop, fused)
put the full arc arrays on the device, so the largest graph they decompose is
capped by device memory. This module cycles ``graph.blockstore`` blocks
through the device one at a time, as Gao et al. cycle disk blocks through a
small compute tier (PAPERS.md). Three tiers hold the arcs:

  * the store on disk, memory-mapped (``BlockStore``);
  * on the host, a byte-budgeted LRU of materialized (padded) blocks
    (``BlockCache``);
  * on the device, one block's arcs at a time: the pow2 length bucket
    ``a_eff`` of its real run, sliced from the padded block and copied over.

The O(n) vertex vectors (estimates, the round-start copy, the frontier, the
changed and receiver flags: 11 bytes a padded vertex) live on the device, so
the halo ``where(mask, est_prev[dst], 0)`` is a device gather. Per round,
each block with an active vertex runs one masked Jacobi superstep over its
(V,) vertices and (a_eff,) arcs: ``core.kcore._hindex_by_bsearch``, whose
hit counts are the ``segment_sum`` kernel on CUDA (its plain version on the
CPU), then ``new = where(active, h, est)``. Blocks with no active vertex are
skipped without loading.

Exactness: every block reads the round-start estimates, so a sweep is one
synchronous Jacobi round; cores and the per-round bills equal every
in-memory mode's. Receivers come from the processed blocks only,
``recv[dst] |= mask & changed[src]``: the arc set is symmetric and a vertex
changes only inside a processed block. A round reads the device back twice:
the blocks' skip flags, and its bills with the stop test.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.dispatch import resolve_plan
from repro_torch.core.kcore import KCoreResult, _bs_iters, _hindex_by_bsearch
from repro_torch.core.messages import MessageStats
from repro_torch.graph.blockstore import ARC_SLOT_BYTES, Block, BlockCache, BlockStore, plan_blocks
from repro_torch.graph.structs import Graph
from repro_torch.kernels import _build
from repro_torch.obs import flight as _flight
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def peak_rss_bytes() -> int:
    """Process peak resident set size (ru_maxrss is KiB on Linux)."""
    import resource
    import sys

    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(ru) if sys.platform == "darwin" else int(ru) * 1024


@dataclasses.dataclass
class OutOfCoreStats:
    """Block-cycling telemetry for one decomposition."""

    n_blocks: int
    V: int
    A: int
    rounds: int
    blocks_loaded: int  # cache misses — blocks actually read from disk
    blocks_skipped: int  # block-rounds skipped via the frontier mask
    block_rounds: int  # block supersteps executed (loads + cache hits)
    cache_hits: int
    evictions: int
    cache_peak_bytes: int
    mem_budget: int | None
    device_block_bytes: int  # largest block shipped, in arc bytes (device peak)
    total_arc_bytes: int  # full arc arrays (the in-memory footprint)
    imbalance: float  # max/mean live arcs per block (straggler factor)
    peak_rss_bytes: int
    ms_per_round: float

    @property
    def skip_rate(self) -> float:
        total = self.block_rounds + self.blocks_skipped
        return self.blocks_skipped / max(total, 1)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["skip_rate"] = round(self.skip_rate, 4)
        return d


@dataclasses.dataclass
class OutOfCoreResult(KCoreResult):
    """KCoreResult plus the block-cycling telemetry."""

    block_stats: OutOfCoreStats | None = None


def _bucket(length: int, cap: int) -> int:
    """Smallest pow2 >= ``length`` (min 8), clamped to the store-wide A."""
    b = 8
    while b < length:
        b <<= 1
    return min(b, cap)


def ship_block(blk: Block, a_eff: int, device: torch.device):
    """The block's first ``a_eff`` arc slots on ``device``: (src, dst, mask)."""
    return tuple(torch.from_numpy(a[:a_eff]).to(device) for a in (blk.src, blk.dst, blk.mask))


def block_row_offsets(src_e: torch.Tensor, V: int) -> torch.Tensor:
    """(V+1,) int64 CSR offsets of the block's src-sorted local sources; the
    last is the slice's length, as ``segment_sum`` requires."""
    return torch.searchsorted(src_e, torch.arange(V + 1, dtype=src_e.dtype, device=src_e.device))


def block_superstep(est_prev, active, lo: int, V: int, src_e, dst_e, mask_e, row_off,
                    n_iters: int):
    """One masked Jacobi superstep over block [lo, lo+V): the halo gathered
    from the round-start estimates, the binary-search h-index of the active
    vertices. Returns the block's (new estimates, changed)."""
    est_u = est_prev[lo:lo + V]
    halo = torch.where(mask_e, est_prev.index_select(0, dst_e), 0)
    h = _hindex_by_bsearch(est_u, halo, src_e, row_off, n_iters)
    new = torch.where(active[lo:lo + V], h, est_u)
    return new, new < est_u


def mark_receivers(recv, ch_u, src_e, dst_e, mask_e) -> None:
    """``recv[dst] |= mask & changed[src]`` over the block's arcs with no
    host sync: an arc that marks no one writes ``recv``'s spare last slot."""
    sel = mask_e & ch_u.index_select(0, src_e)
    recv[torch.where(sel, dst_e, recv.numel() - 1)] = True


def _publish_metrics(stats: OutOfCoreStats) -> None:
    """Fold the block-cycling telemetry into the process metrics registry."""
    _metrics.counter("kcore_ooc_blocks_loaded_total").inc(stats.blocks_loaded)
    _metrics.counter("kcore_ooc_blocks_skipped_total").inc(stats.blocks_skipped)
    _metrics.counter("kcore_ooc_evictions_total").inc(stats.evictions)
    _metrics.gauge("kcore_ooc_device_block_bytes").set(stats.device_block_bytes)
    _metrics.gauge("kcore_ooc_total_arc_bytes").set(stats.total_arc_bytes)
    _metrics.gauge("kcore_ooc_cache_peak_bytes").set(stats.cache_peak_bytes)
    _metrics.gauge("kcore_ooc_peak_rss_bytes").set(stats.peak_rss_bytes)
    _metrics.gauge("kcore_block_imbalance").set(stats.imbalance)


def outofcore_decompose(source, *, mem_budget: int | None = None,
                        n_blocks: int | None = None,
                        max_rounds: int | None = None,
                        store_dir: str | None = None,
                        deg: np.ndarray | None = None,
                        keep_store: bool = False,
                        device: str | torch.device | None = None) -> OutOfCoreResult:
    """Decompose to the exact fixpoint with at most one block's arcs on the device.

    ``source`` is a ``Graph`` (a temporary ``BlockStore`` is written under
    ``store_dir`` or the system temp directory and deleted afterwards unless
    ``keep_store``), an opened ``BlockStore``, or a store directory path.
    ``mem_budget`` bounds the host LRU block cache in bytes; ``plan_blocks``
    picks the block count from it when ``n_blocks`` is not given. ``deg``
    (full (n,) int32) must be passed when the store was built from masked
    arrays whose degrees are not the live arcs' counts; otherwise it is
    rebuilt from the blocks in one pass. ``device`` defaults to CUDA and
    raises without a card; ``"cpu"`` runs the kernels' plain versions.

    The accounting equals every in-memory mode's: round 0 bills the degree
    broadcast (2m messages, n senders, every vertex active), round r >= 1
    bills the degrees of the vertices whose estimate dropped, and the active
    series is the receiver counts.
    """
    plan = resolve_plan(device)
    tmp = None
    if isinstance(source, Graph):
        g = source
        if n_blocks is None:
            n_blocks = plan_blocks(g.n, g.src, mem_budget)
        tmp = tempfile.mkdtemp(prefix="kcore_blocks_", dir=store_dir)
        store = BlockStore.create(f"{tmp}/store", g, n_blocks=n_blocks)
        deg = g.deg
    elif isinstance(source, BlockStore):
        store = source
    else:
        store = BlockStore.open(source)
    try:
        return _decompose_store(store, deg=deg, mem_budget=mem_budget,
                                max_rounds=max_rounds, plan=plan)
    finally:
        if tmp is not None and not keep_store:
            shutil.rmtree(tmp, ignore_errors=True)


def _store_degrees(store: BlockStore) -> np.ndarray:
    """(n_pad,) mask-weighted degrees from one streaming pass over the blocks."""
    deg = np.zeros(store.n_pad, np.int32)
    for b in range(store.n_blocks):
        raw_src, _raw_dst, raw_mask = store.block_raw(b)
        if raw_src.shape[0]:
            deg[b * store.V:(b + 1) * store.V] += np.bincount(
                np.asarray(raw_src)[np.asarray(raw_mask)], minlength=store.V).astype(np.int32)
    return deg


def _decompose_store(store: BlockStore, *, deg: np.ndarray | None,
                     mem_budget: int | None, max_rounds: int | None,
                     plan) -> OutOfCoreResult:
    builds0, bsecs0 = _build.build_count(), _build.build_seconds()
    dev = plan.device
    n, V, n_blocks = store.n, store.V, store.n_blocks
    n_pad = store.n_pad
    if n == 0:
        zero = MessageStats(*(np.zeros(0, np.int64),) * 3)
        return OutOfCoreResult(core=np.zeros(0, np.int32), rounds=0, converged=True,
                               stats=zero, dispatch=plan.kind)

    if deg is None:
        deg_pad = _store_degrees(store)
    else:
        deg_pad = np.zeros(n_pad, np.int32)
        deg_pad[:n] = np.asarray(deg, np.int32)
    deg64 = deg_pad[:n].astype(np.int64)
    n_iters = _bs_iters(int(deg_pad.max()) if n_pad else 0)
    cap = max_rounds if max_rounds is not None else n + 1

    msgs = [int(deg64.sum())]  # round 0: degree broadcast = 2m
    active = [n, int((deg64 > 0).sum())]
    changed_counts = [n]

    # the device's vertex tier; round 1's frontier is every vertex that got
    # the degree broadcast (deg-0 vertices hold est 0, a fixpoint), which
    # already skips all-isolated blocks
    est = torch.tensor(deg_pad, device=dev)
    deg_t = torch.from_numpy(deg64).to(dev)
    active_mask = est > 0

    cache = BlockCache(store, budget_bytes=mem_budget)
    skipped = block_rounds = 0
    rounds, converged = 0, False
    # each block ships only its pow2 length bucket of arc slots, and its row
    # offsets over them are computed once and kept on the device
    a_eff = [_bucket(int(store.arcs_per_block[b]), store.A) for b in range(n_blocks)]
    row_offs: dict[int, torch.Tensor] = {}
    dev_bytes_peak = 0

    rec = _flight.recorder()
    if rec.active:
        rec.start_run("static", "out_of_core", n=n)
        rec.record_round(active[0], msgs[0], changed_counts[0], est=deg_pad[:n])

    with _trace.span("kcore.decompose", n=n, m=int(deg64.sum()) // 2, mode="out_of_core",
                     n_blocks=n_blocks, mem_budget=mem_budget or 0, device=str(dev)) as _sp:
        t_conv = time.perf_counter()
        while rounds < cap:
            t_r = time.perf_counter() if rec.active else 0.0
            with _trace.span("kcore.round", round=rounds) as rsp:
                est_prev = est.clone()
                changed = torch.zeros(n_pad, dtype=torch.bool, device=dev)
                recv = torch.zeros(n_pad + 1, dtype=torch.bool, device=dev)
                live = active_mask.view(n_blocks, V).any(1).cpu().numpy()
                blocks_hit = 0
                for b in range(n_blocks):
                    lo = b * V
                    if not live[b]:
                        skipped += 1
                        continue
                    blocks_hit += 1
                    block_rounds += 1
                    ae = a_eff[b]
                    dev_bytes_peak = max(dev_bytes_peak, ae * ARC_SLOT_BYTES)
                    src_e, dst_e, mask_e = ship_block(cache.get(b), ae, dev)
                    if b not in row_offs:
                        row_offs[b] = block_row_offsets(src_e, V)
                    new_u, ch_u = block_superstep(est_prev, active_mask, lo, V, src_e, dst_e,
                                                  mask_e, row_offs[b], n_iters)
                    est[lo:lo + V] = new_u
                    changed[lo:lo + V] = ch_u
                    mark_receivers(recv, ch_u, src_e, dst_e, mask_e)
                    # free this block's arcs before the next block ships
                    del src_e, dst_e, mask_e, new_u, ch_u
                recv = recv[:n_pad]
                bills = torch.stack([torch.where(changed[:n], deg_t, 0).sum(), changed.sum(),
                                     recv.sum()]).tolist()
                rounds += 1
                if bills[1] == 0:
                    converged = True
                    rsp.set(blocks=blocks_hit, converged=True)
                    break
                msgs.append(bills[0])
                changed_counts.append(bills[1])
                active.append(bills[2])
                rsp.set(messages=msgs[-1], changed=changed_counts[-1], blocks=blocks_hit)
                if rec.active:
                    rec.record_round(active[rounds], msgs[-1], changed_counts[-1],
                                     est=est[:n].cpu().numpy(),
                                     prev_est=est_prev[:n].cpu().numpy(),
                                     host_s=time.perf_counter() - t_r)
                active_mask = recv
        wall = time.perf_counter() - t_conv
        _sp.set(rounds=rounds, converged=converged, blocks_loaded=cache.loads,
                blocks_skipped=skipped, evictions=cache.evictions)

    stats = MessageStats(
        messages_per_round=np.asarray(msgs, np.int64),
        active_per_round=np.asarray(active[: len(msgs)], np.int64),
        changed_per_round=np.asarray(changed_counts[: len(msgs)], np.int64),
    )
    block_stats = OutOfCoreStats(
        n_blocks=n_blocks, V=V, A=store.A, rounds=rounds,
        blocks_loaded=cache.loads, blocks_skipped=skipped,
        block_rounds=block_rounds, cache_hits=cache.hits,
        evictions=cache.evictions, cache_peak_bytes=cache.peak_bytes,
        mem_budget=mem_budget,
        device_block_bytes=dev_bytes_peak or store.block_arc_bytes,
        total_arc_bytes=store.total_arc_bytes,
        imbalance=store.balance()["imbalance"],
        peak_rss_bytes=peak_rss_bytes(),
        ms_per_round=1e3 * wall / max(rounds, 1),
    )
    _publish_metrics(block_stats)
    if rec.active:
        rec.end_run(converged=converged, messages=int(stats.total_messages),
                    blocks_loaded=block_stats.blocks_loaded,
                    blocks_skipped=block_stats.blocks_skipped,
                    device_block_bytes=block_stats.device_block_bytes,
                    peak_rss_bytes=block_stats.peak_rss_bytes)
    return OutOfCoreResult(
        core=est[:n].cpu().numpy().astype(np.int32), rounds=rounds, converged=converged,
        stats=stats, recompiles=_build.build_count() - builds0,
        compile_s=_build.build_seconds() - bsecs0, phase_s={"converge": wall},
        dispatch=plan.kind, block_stats=block_stats)
