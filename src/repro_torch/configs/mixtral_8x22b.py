"""mixtral-8x22b [arXiv:2401.04088]: 56L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768, MoE 8 experts top-2, sliding-window attention."""

from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=32768,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384, n_shared=0,
                  virtual_split=2),   # 16 virtual experts / 16-way model axis
    swa_window=4096, rope_theta=1_000_000.0,
    train_microbatches=8,
)

SMOKE = LMConfig(
    name="mixtral-8x22b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=0,
                  virtual_split=2),
    swa_window=32,
)
