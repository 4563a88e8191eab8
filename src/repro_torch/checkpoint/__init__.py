"""Checkpointing of the port's state dicts (the port of ``repro.checkpoint``):
atomic step directories in the reference's on-disk layout."""

from repro_torch.checkpoint.checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]
