"""Deterministic, shardable token batches (port of ``repro.data.tokens``).

A batch is a pure function of ``(seed, step, shard)`` through numpy's
counter-based Philox, so the pipeline's state is the integer step: a run
resumed at step k reads the batches an unbroken run reads, and the batches
are the reference's bit for bit. Shards slice one canonical global batch, so
a change of shard count on resume keeps the global batch's content.

``RepoTokenDataset`` (token shards committed in a repository) is not ported
yet: ROADMAP.md §A item 3.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def global_batch_at(self, step: int) -> np.ndarray:
        """The canonical global batch for ``step``: int32 [global_batch, seq_len]."""
        bit = np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))
        return bit.integers(0, self.vocab_size, size=(self.global_batch, self.seq_len), dtype=np.int32)

    def shard_batch_at(self, step: int, shard: int, shard_count: int) -> np.ndarray:
        if self.global_batch % shard_count:
            raise ValueError(f"global batch {self.global_batch} does not split into {shard_count} shards")
        per = self.global_batch // shard_count
        return self.global_batch_at(step)[shard * per : (shard + 1) * per]
