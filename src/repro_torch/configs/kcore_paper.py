"""The paper's own workload configs (copy of ``repro.configs.kcore_paper``):
the 14 SNAP graphs of Table I (as synthetic analogues — see
graph/generators.py) plus the engine configs. ``CONFIG_BEYOND`` is the
beyond-paper block-Gauss-Seidel schedule that ``benchmarks/beyond_block_gs.py``
compares with the paper's Jacobi rounds."""

from repro_torch.core.kcore import KCoreConfig
from repro_torch.graph.generators import SNAP_TABLE

CONFIG = KCoreConfig(mode="jacobi", backend="segment")
CONFIG_BEYOND = KCoreConfig(mode="block_gs", backend="segment", n_blocks=16)
GRAPHS = tuple(e.abbrev for e in SNAP_TABLE)
