"""Deterministic synthetic data of the port (a copy of ``repro.data``)."""

from repro_torch.data.pipeline import lm_batch_stream, synth_lm_batch

__all__ = ["lm_batch_stream", "synth_lm_batch"]
