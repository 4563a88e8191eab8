"""mace [arXiv:2206.07697]: higher-order E(3)-equivariant message passing —
2 layers, 128 channels, l_max=2, correlation order 3, 8 radial Bessel fns."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="mace", kind="mace", n_layers=2, d_hidden=128,
    params={"l_max": 2, "correlation": 3, "n_rbf": 8, "cutoff": 5.0,
            "n_species": 10},
)

SMOKE = GNNConfig(
    name="mace-smoke", kind="mace", n_layers=2, d_hidden=16,
    params={"l_max": 2, "correlation": 3, "n_rbf": 4, "cutoff": 5.0,
            "n_species": 4},
)
