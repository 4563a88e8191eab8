"""Deterministic synthetic data pipeline (a copy of ``repro.data.pipeline``,
which is numpy; the port keeps its own copy).

Batches are a pure function of (seed, step), the property fault-tolerant
restarts rely on: a resumed run consumes byte-identical batches without any
data-service coordination. Token streams are Zipf-ish (power-law unigram)
with induced bigram structure, so the LM loss decreases in training. The
arrays are numpy int32, bit-equal to the reference's for every (seed, step).
"""

from __future__ import annotations

import numpy as np


def synth_lm_batch(vocab: int, batch: int, seq_len: int, *, seed: int,
                   step: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # power-law unigrams + deterministic "grammar": x_{t+1} depends on x_t
    base = rng.zipf(1.5, size=(batch, seq_len)).clip(max=vocab // 2)
    shift = (np.arange(seq_len) % 7)[None, :]
    tokens = ((base + shift * 31) % vocab).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return tokens, labels


def lm_batch_stream(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                    start_step: int = 0):
    step = start_step
    while True:
        yield synth_lm_batch(vocab, batch, seq_len, seed=seed, step=step)
        step += 1
