"""yi-34b [arXiv:2403.04652]: llama-arch GQA dense — 60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="yi-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, rope_theta=5_000_000.0,
    train_microbatches=4,
)

SMOKE = LMConfig(
    name="yi-34b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=192, vocab=512,
)
