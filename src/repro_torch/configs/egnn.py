"""egnn [arXiv:2102.09844]: E(n)-equivariant GNN — 4 layers, d_hidden=64,
scalar-distance messages + coordinate updates."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="egnn", kind="egnn", n_layers=4, d_hidden=64,
    params={"n_species": 10},
)

SMOKE = GNNConfig(
    name="egnn-smoke", kind="egnn", n_layers=2, d_hidden=16,
    params={"n_species": 4},
)
