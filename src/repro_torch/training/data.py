"""Deterministic, shardable synthetic data pipeline.

Batches are a pure function of (seed, step, shard) — no files, no state —
which gives exact resume-after-restart (the checkpoint stores only the step)
and host-sharded loading for multi-host meshes: each host materializes only
its slice of the global batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticTokens:
    """Zipf-ish token stream with document structure (deterministic)."""

    def __init__(self, cfg: DataConfig, num_shards: int = 1,
                 shard_id: int = 0):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shard_batch = cfg.global_batch // num_shards
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> np.ndarray:
        """(shard_batch, seq_len) int32 tokens for a given global step."""
        rng = np.random.default_rng(
            (self.cfg.seed, step, self.shard_id))
        return rng.choice(
            self.cfg.vocab_size, p=self._probs,
            size=(self.shard_batch, self.cfg.seq_len)).astype(np.int32)

    def labels_at(self, step: int, tokens: np.ndarray) -> np.ndarray:
        return np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
