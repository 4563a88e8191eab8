"""Graph substrate of the port: CSR and ELL layouts and the seeded
generators, numpy only (copies of ``repro.graph``'s modules)."""

from repro_torch.graph.structs import EllBucket, EllGraph, Graph, build_ell, from_reference

__all__ = ["EllBucket", "EllGraph", "Graph", "build_ell", "from_reference"]
