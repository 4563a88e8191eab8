"""Graph substrate of the port: CSR and ELL layouts, the seeded generators,
the spill-to-disk block store and the paper's dataCleanse IO, numpy only
(copies of ``repro.graph``'s modules)."""

from repro_torch.graph.structs import EllBucket, EllGraph, Graph, build_ell, from_reference
from repro_torch.graph.blockstore import Block, BlockCache, BlockStore, plan_blocks
from repro_torch.graph import io

__all__ = ["EllBucket", "EllGraph", "Graph", "build_ell", "from_reference",
           "Block", "BlockCache", "BlockStore", "plan_blocks", "io"]
