"""Synthetic token streams for LM training/serving.

A numpy copy of the JAX package's ``data/synthetic.py``: the same
``(seed, step)`` gives the same batch, byte for byte.

Deterministic, step-indexed generation: batch ``i`` is a pure function of
``(seed, i)`` so the pipeline is stateless and resumes exactly after a
restart (fault-tolerance requirement — no data-iterator checkpoint is
needed, just the step counter).

The stream is a mixture of a Zipfian unigram draw and short Markov
repeats, which gives the loss curve enough structure for the ~100M-model
example to visibly learn (pure uniform noise would pin loss at ln(V)).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.3       # Zipf exponent of the unigram mixture
    repeat_p: float = 0.35    # probability of copying token[t - period]
    period: int = 16

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Batch for ``step`` -> {tokens, labels} int32[B, T]."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, t, v = self.batch_size, self.seq_len, self.vocab_size
        # Zipf over a capped support for speed; modulo-fold into vocab.
        base = rng.zipf(self.zipf_a, size=(b, t)).astype(np.int64)
        toks = (base - 1) % v
        # Inject periodic repeats (learnable structure).
        rep = rng.random((b, t)) < self.repeat_p
        rep[:, : self.period] = False
        idx = np.arange(t)
        src = np.clip(idx - self.period, 0, t - 1)
        toks = np.where(rep, toks[:, src], toks)
        toks = toks.astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.zeros((b, 1), np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}
