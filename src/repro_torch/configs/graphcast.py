"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN —
16 processor layers, d_hidden=512, icosahedral mesh refinement 6, 227 vars.

Grid resolution: 1° lat-lon (181 x 360 = 65,160 grid nodes) — GraphCast's
0.25° grid only changes input_spec constants; 1° keeps the CPU-hosted
dry-run compile tractable (documented deviation, DESIGN.md §6)."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="graphcast", kind="graphcast", n_layers=16, d_hidden=512,
    params={"mesh_refinement": 6, "n_vars": 227, "aggregator": "sum",
            "grid_lat": 181, "grid_lon": 360,
            "mesh_nodes": 40962, "mesh_edges": 327660,  # multimesh union M0..M6
            "grid2mesh_edges": 196608, "mesh2grid_edges": 195480},
)

SMOKE = GNNConfig(
    name="graphcast-smoke", kind="graphcast", n_layers=2, d_hidden=32,
    params={"mesh_refinement": 1, "n_vars": 8, "aggregator": "sum",
            "grid_lat": 7, "grid_lon": 12,
            "mesh_nodes": 42, "mesh_edges": 240,
            "grid2mesh_edges": 252, "mesh2grid_edges": 252},
)
