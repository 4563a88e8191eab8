"""schnet [arXiv:1706.08566]: continuous-filter convolutions — 3 interaction
blocks, d_hidden=64, 300 Gaussian RBFs, cutoff 10 Å."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="schnet", kind="schnet", n_layers=3, d_hidden=64,
    params={"n_rbf": 300, "cutoff": 10.0, "n_species": 10},
)

SMOKE = GNNConfig(
    name="schnet-smoke", kind="schnet", n_layers=2, d_hidden=16,
    params={"n_rbf": 16, "cutoff": 10.0, "n_species": 4},
)
