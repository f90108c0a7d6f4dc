"""Byte-level text corpus pipeline: the port's copy of
``src/repro/data/text.py`` (``TextConfig``, ``ByteCorpus``), the real-data
counterpart of ``synthetic.py``.

Same stateless contract: ``batch(step)`` is a pure function of (corpus,
seed, step) through numpy's counter-based Philox (stream 1, the synthetic
pipeline's being 0) and strided window addressing, so a restarted run
regenerates exactly the next batch and the port's batches are bit-identical
to the reference's.  Byte-level tokens (vocab 256 + BOS), no tokenizer.  As
in the reference, the train CLI does not read it.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

BOS = 256
VOCAB = 257


@dataclass
class TextConfig:
    path: str
    seq_len: int
    global_batch: int
    seed: int = 0


class ByteCorpus:
    def __init__(self, cfg: TextConfig):
        self.cfg = cfg
        with open(cfg.path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        if len(self.data) < cfg.seq_len + 2:
            raise ValueError(f"corpus too small: {len(self.data)} bytes")
        self.n_windows = len(self.data) - cfg.seq_len - 1

    def fingerprint(self) -> str:
        """The first 64 bits (hex) of the SHA-256 of the corpus's first
        MiB."""
        return hashlib.sha256(self.data[:1 << 20].tobytes()).hexdigest()[:16]

    def batch(self, step: int) -> dict:
        """{"tokens", "labels": int32 [global_batch, seq_len]}: windows at
        Philox-drawn starts; tokens are BOS then the window's bytes, labels
        the bytes one ahead."""
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(
            key=c.seed, counter=[0, 0, 1, step]))
        starts = rng.integers(0, self.n_windows, size=c.global_batch)
        tok = np.stack([self.data[s:s + c.seq_len + 1].astype(np.int32)
                        for s in starts])
        tokens = np.concatenate(
            [np.full((c.global_batch, 1), BOS, np.int32), tok[:, :-2]],
            axis=1)
        return {"tokens": tokens, "labels": tok[:, :-1].astype(np.int32)}
