"""Synthetic LM data (port of the reference package's ``training/data.py``;
deterministic, seeded, host-side numpy, so the same seed gives the
reference's batches byte for byte).

Next-token-prediction batches from a synthetic "corpus": a mixture of
repeated n-gram motifs and noise, so tiny models visibly learn (the loss
falls below the uniform-entropy floor within a few hundred steps), which
``repro_torch.examples.train_small`` asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    motif_len: int = 8
    num_motifs: int = 64
    noise_prob: float = 0.1


class SyntheticLM:
    """Iterator of {"tokens": [B, S], "labels": [B, S]} int32 batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.motifs = self.rng.integers(
            0, cfg.vocab_size, size=(cfg.num_motifs, cfg.motif_len),
            dtype=np.int32)

    def _sequence(self) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, np.int32)
        i = 0
        while i < cfg.seq_len + 1:
            m = self.motifs[self.rng.integers(cfg.num_motifs)]
            n = min(len(m), cfg.seq_len + 1 - i)
            out[i:i + n] = m[:n]
            i += n
        noise = self.rng.random(cfg.seq_len + 1) < cfg.noise_prob
        out[noise] = self.rng.integers(0, cfg.vocab_size, noise.sum())
        return out

    def batch(self) -> Dict[str, np.ndarray]:
        seqs = np.stack([self._sequence()
                         for _ in range(self.cfg.batch_size)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()
