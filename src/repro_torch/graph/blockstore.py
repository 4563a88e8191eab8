"""Spill-to-disk partitioned graph store: the out-of-core tier's bottom layer.

The port's copy of ``repro.graph.blockstore``, which has no JAX in it. The
source paper's premise is graphs too large for one machine's memory; Gao et
al. ("K-Core Decomposition on Super Large Graphs with Limited Resources",
PAPERS.md) cycle disk-resident graph *blocks* through a small compute tier.
This module is that disk tier:

  * ``BlockStore.create`` partitions src-sorted arc arrays into the exact
    ``partition.shard_arc_arrays`` layout (``shard_layout``'s geometry:
    contiguous vertex ranges of V, arc runs bounded by searchsorted, one
    store-wide padded arc length A) and writes each block's real arc run as
    raw little-endian ``.npy`` arrays keyed by partition id, with no padding
    on disk.
  * ``BlockStore.open`` memory-maps those arrays; opening a store reads the
    manifest only.
  * ``BlockStore.block(b)`` materializes one padded ``Block``, row for row
    what ``shard_arc_arrays`` stages for shard ``b``: the unit the
    out-of-core decomposition ships to the device.
  * ``BlockCache`` is an LRU over materialized blocks bounded by a byte
    budget.

The on-disk layout (``manifest.json`` version 1 and
``block_NNNNN.{src,dst,mask}.npy``) is the reference's, so a store written
by either package opens in the other.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
from collections import OrderedDict

import numpy as np

from repro_torch.graph.partition import balance_from_counts, shard_layout
from repro_torch.graph.structs import Graph

MANIFEST = "manifest.json"
FORMAT_VERSION = 1

# bytes per padded arc slot when a block is materialized: src int32 + dst
# int32 + mask bool — the unit every budget computation uses
ARC_SLOT_BYTES = 9


def _block_prefix(d: pathlib.Path, b: int) -> pathlib.Path:
    return d / f"block_{b:05d}"


@dataclasses.dataclass(frozen=True)
class Block:
    """One materialized (padded) partition — the device-resident unit.

    Rows are bit-identical to ``shard_arc_arrays``'s shard ``bid``: ``src``
    holds local vertex indices in [0, V), ``dst`` global indices, padding
    slots carry the same sentinels (src = V-1, dst = the owner's last
    padding vertex) with ``mask`` False.
    """

    bid: int
    src: np.ndarray  # (A,) int32 — local vertex index [0, V)
    dst: np.ndarray  # (A,) int32 — global vertex index
    mask: np.ndarray  # (A,) bool — True = real (live) arc
    arcs_real: int  # live arcs (mask.sum())

    @property
    def nbytes(self) -> int:
        return self.src.nbytes + self.dst.nbytes + self.mask.nbytes


class BlockStore:
    """Directory of mmap-able arc blocks in the shard_arc_arrays layout."""

    def __init__(self, path: str | pathlib.Path, manifest: dict):
        self.path = pathlib.Path(path)
        self.n = int(manifest["n"])
        self.n_blocks = int(manifest["n_blocks"])
        self.V = int(manifest["V"])
        self.A = int(manifest["A"])
        self.num_arcs = int(manifest["num_arcs"])
        self.arcs_per_block = np.asarray(manifest["arcs_per_block"], np.int64)
        self.live_per_block = np.asarray(manifest["live_per_block"], np.int64)
        self._manifest = manifest

    @classmethod
    def create(cls, path: str | pathlib.Path, g: Graph | None = None, *,
               n: int | None = None, src: np.ndarray | None = None,
               dst: np.ndarray | None = None,
               arc_mask: np.ndarray | None = None, n_blocks: int = 8,
               arc_multiple: int = 8, overwrite: bool = False) -> "BlockStore":
        """Write a store from a Graph or raw src-sorted arc arrays.

        Per block only the real arc run ``[bounds[b], bounds[b+1])`` is
        written (local src, global dst, mask); padding to the store-wide A
        happens at materialization, so peak memory is the inputs plus one
        block.
        """
        if g is not None:
            n, src, dst = g.n, g.src, g.dst
            arc_mask = np.ones(g.num_arcs, bool)
        if n is None or src is None or dst is None:
            raise ValueError("pass a Graph or n/src/dst arrays")
        if arc_mask is None:
            arc_mask = np.ones(src.shape[0], bool)
        n_blocks = max(int(n_blocks), 1)
        d = pathlib.Path(path)
        if d.exists():
            if not overwrite:
                raise FileExistsError(f"{d} exists (overwrite=False)")
            shutil.rmtree(d)
        d.mkdir(parents=True)
        V, A, bounds = shard_layout(n, src, n_blocks, arc_multiple=arc_multiple)
        live_per_block = []
        for b in range(n_blocks):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            p = _block_prefix(d, b)
            np.save(f"{p}.src.npy", (src[lo:hi] - b * V).astype(np.int32, copy=False))
            np.save(f"{p}.dst.npy", dst[lo:hi].astype(np.int32, copy=False))
            np.save(f"{p}.mask.npy", arc_mask[lo:hi].astype(bool, copy=False))
            live_per_block.append(int(arc_mask[lo:hi].sum()))
        manifest = {
            "version": FORMAT_VERSION,
            "n": int(n),
            "n_blocks": n_blocks,
            "V": V,
            "A": A,
            "num_arcs": int(src.shape[0]),
            "arcs_per_block": np.diff(bounds).astype(np.int64).tolist(),
            "live_per_block": live_per_block,
        }
        (d / MANIFEST).write_text(json.dumps(manifest))
        return cls(d, manifest)

    @classmethod
    def open(cls, path: str | pathlib.Path) -> "BlockStore":
        d = pathlib.Path(path)
        manifest = json.loads((d / MANIFEST).read_text())
        if manifest.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported blockstore version {manifest.get('version')!r}")
        return cls(d, manifest)

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.V

    @property
    def total_arc_bytes(self) -> int:
        """Bytes the arc arrays would occupy fully materialized (the
        in-memory modes' device footprint): src + dst + mask per real slot."""
        return int(self.num_arcs) * ARC_SLOT_BYTES

    @property
    def block_arc_bytes(self) -> int:
        """Bytes of one materialized (padded) block."""
        return int(self.A) * ARC_SLOT_BYTES

    def balance(self) -> dict:
        """``partition.balance_report`` twin over the stored blocks."""
        return balance_from_counts(self.live_per_block, self.A)

    def vertex_range(self, b: int) -> tuple[int, int]:
        return b * self.V, (b + 1) * self.V

    def block_raw(self, b: int):
        """Memory-mapped real-length (unpadded) arrays of block ``b``."""
        p = _block_prefix(self.path, b)
        return (np.load(f"{p}.src.npy", mmap_mode="r"),
                np.load(f"{p}.dst.npy", mmap_mode="r"),
                np.load(f"{p}.mask.npy", mmap_mode="r"))

    def block(self, b: int) -> Block:
        """Materialize block ``b`` padded to the store-wide A, with
        ``shard_arc_arrays``'s sentinels: local src V-1, dst the owner's last
        padding slot clamped to n_pad-1, mask False."""
        if not 0 <= b < self.n_blocks:
            raise IndexError(f"block {b} out of range [0, {self.n_blocks})")
        raw_src, raw_dst, raw_mask = self.block_raw(b)
        k = raw_src.shape[0]
        V, A = self.V, self.A
        src = np.full(A, V - 1, np.int32)
        dst = np.full(A, min(b * V + V - 1, self.n_pad - 1), np.int32)
        mask = np.zeros(A, bool)
        src[:k] = raw_src
        dst[:k] = raw_dst
        mask[:k] = raw_mask
        return Block(bid=b, src=src, dst=dst, mask=mask,
                     arcs_real=int(self.live_per_block[b]))

    def delete(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)


class BlockCache:
    """LRU cache of materialized blocks bounded by a byte budget.

    ``budget_bytes`` caps the sum of cached block bytes; loading past it
    evicts least-recently-used blocks first. The block being returned is
    always retained even when it alone exceeds the budget (no computation
    runs on less than one block); ``over_budget`` flags that case.
    ``budget_bytes=None`` means unbounded.
    """

    def __init__(self, store: BlockStore, budget_bytes: int | None = None):
        self.store = store
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self._lru: OrderedDict[int, Block] = OrderedDict()
        self.bytes = 0
        self.loads = 0
        self.hits = 0
        self.evictions = 0
        self.peak_bytes = 0
        self.over_budget = (self.budget_bytes is not None
                            and store.block_arc_bytes > self.budget_bytes)

    def get(self, b: int) -> Block:
        blk = self._lru.get(b)
        if blk is not None:
            self.hits += 1
            self._lru.move_to_end(b)
            return blk
        blk = self.store.block(b)
        self.loads += 1
        self._lru[b] = blk
        self.bytes += blk.nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes)
        if self.budget_bytes is not None:
            while self.bytes > self.budget_bytes and len(self._lru) > 1:
                _, victim = self._lru.popitem(last=False)
                self.bytes -= victim.nbytes
                self.evictions += 1
        return blk

    def stats(self) -> dict:
        return {
            "loads": self.loads,
            "hits": self.hits,
            "evictions": self.evictions,
            "resident_blocks": len(self._lru),
            "resident_bytes": self.bytes,
            "peak_bytes": self.peak_bytes,
            "budget_bytes": self.budget_bytes,
            "over_budget": self.over_budget,
        }


def plan_blocks(n: int, src: np.ndarray, mem_budget: int | None,
                arc_multiple: int = 8, resident_target: int = 2,
                max_blocks: int = 4096) -> int:
    """Pick a block count whose padded blocks fit the byte budget.

    Returns the smallest power-of-two ``n_blocks`` such that
    ``resident_target`` materialized blocks fit in ``mem_budget``, probing
    the real layout through ``shard_layout`` so that skew, which inflates
    the padded A, is accounted for. Falls back to the largest probed count
    when even it cannot fit (``BlockCache.over_budget`` then flags the
    budget). No budget: 8 blocks.
    """
    if mem_budget is None:
        return min(8, max_blocks)
    nb = 1
    while nb <= max_blocks:
        _V, A, _bounds = shard_layout(n, src, nb, arc_multiple=arc_multiple)
        if resident_target * A * ARC_SLOT_BYTES <= mem_budget:
            return nb
        if nb >= min(max_blocks, max(n, 1)):
            break
        nb *= 2
    return nb
