"""din [arXiv:1706.06978]: Deep Interest Network — embed_dim=18, history
seq_len=100, target-attention MLP 80-40, prediction MLP 200-80.

Tables: 10^6 items (matches retrieval_cand's candidate count), 10^4
categories."""

from repro_torch.configs.base import RecSysConfig

CONFIG = RecSysConfig(
    name="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40),
    mlp=(200, 80), n_items=1_000_000, n_cates=10_000,
)

SMOKE = RecSysConfig(
    name="din-smoke", embed_dim=8, seq_len=12, attn_mlp=(16, 8),
    mlp=(24, 12), n_items=1000, n_cates=50,
)
