"""Optimizer of the port (the counterpart of ``repro.optim``): AdamW with
global-norm clipping, the cosine-warmup schedule, and gradient compression
with error feedback (``compression``, which no training path calls, as in
the reference)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import int8_compress_decompress, topk_compress_decompress
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "cosine_warmup",
           "topk_compress_decompress", "int8_compress_decompress"]
