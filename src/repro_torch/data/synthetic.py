"""Deterministic synthetic token pipeline: the port's copy of
``src/repro/data/synthetic.py`` (``SyntheticConfig``, ``SyntheticDataset``).

Batches are a pure function of ``(seed, step)`` via numpy's counter-based
Philox, so any step's batch can be regenerated after a restart, and the
port's batches are bit-identical to the reference's.  The stream is
Zipf-distributed tokens with a periodic copy structure, so the loss has a
learnable signal.  The multi-host loader comes with the distributed slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    markov_period: int = 16      # learnable periodic structure


class SyntheticDataset:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self._probs = p / p.sum()

    def batch(self, step: int) -> dict:
        """{tokens [GB, T] int32, labels [GB, T] int32} for this step."""
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=c.seed, counter=[0, 0, 0, step]))
        base = rng.choice(c.vocab_size, size=(c.global_batch, c.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # periodic copy structure: token t depends on token t-period
        period = c.markov_period
        if c.seq_len + 1 > period:
            mix = rng.random((c.global_batch, c.seq_len + 1)) < 0.5
            base[:, period:] = np.where(mix[:, period:],
                                        base[:, :-period], base[:, period:])
        return {"tokens": base[:, :-1], "labels": base[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
