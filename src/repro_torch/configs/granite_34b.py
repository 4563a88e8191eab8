"""granite-34b [arXiv:2405.04324]: llama-arch code model, MQA — 88L
d_model=6144 48H (kv=1) d_ff=24576 vocab=49152."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-34b",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab=49152, mlp_type="gelu",
    train_microbatches=4,
)

SMOKE = LMConfig(
    name="granite-34b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, d_head=8,
    d_ff=192, vocab=512, mlp_type="gelu",
)
