"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d_model=1024 16H (kv=16)
d_ff=2816 vocab=151936, QKV bias, tied embeddings."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=2816, vocab=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen1.5-0.5b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=160, vocab=512, qkv_bias=True, tie_embeddings=True,
)
