"""Optimizer of the port (the counterpart of ``repro.optim``): AdamW with
global-norm clipping, and the cosine-warmup schedule. Gradient compression
(``repro.optim.compression``) is not ported yet."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "cosine_warmup"]
