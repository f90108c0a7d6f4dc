"""Deterministic synthetic token pipeline: the port's copy of
``src/repro/data/synthetic.py`` (``SyntheticConfig``, ``SyntheticDataset``).

Batches are a pure function of ``(seed, step)`` via numpy's counter-based
Philox, so any step's batch can be regenerated after a restart, and the
port's batches are bit-identical to the reference's.  The stream is
Zipf-distributed tokens with a periodic copy structure, so the loss has a
learnable signal.  ``HostShardedLoader`` (the reference's lines 60-77)
gives each data-parallel rank its rows of the global batch.
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


class HostShardedLoader:
    """Wraps a ``SyntheticDataset`` for data parallelism: host (or rank)
    ``host_id`` of ``num_hosts`` gets rows [host_id · GB / n, (host_id + 1)
    · GB / n) of each global batch, the reference's slicing.  ``batch`` is
    ``local_batch``, so the training loop takes it as a dataset."""

    def __init__(self, ds: SyntheticDataset, host_id: int = 0,
                 num_hosts: int = 1):
        if ds.cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {ds.cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.ds = ds
        self.cfg = ds.cfg
        self.host_id = host_id
        self.num_hosts = num_hosts

    def local_batch(self, step: int) -> dict:
        full = self.ds.batch(step)
        per = self.ds.cfg.global_batch // self.num_hosts
        lo = self.host_id * per
        return {k: v[lo:lo + per] for k, v in full.items()}

    batch = local_batch
