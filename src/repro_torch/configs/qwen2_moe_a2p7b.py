"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048 16H
(GQA kv=16) d_ff=1408 vocab=151936, MoE 60 routed top-4 + 4 shared."""

from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4,
                  pad_experts_to=64),  # 64 / 16-way model axis (4 dummies)
    qkv_bias=True, rope_theta=1_000_000.0,
    train_microbatches=2,
)

SMOKE = LMConfig(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=96, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=96, n_shared=2,
                  pad_experts_to=10),  # exercises the pad path
    qkv_bias=True,
)
