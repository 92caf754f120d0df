"""Deterministic, shardable token batches (port of ``repro.data.tokens``).

A batch is a pure function of ``(seed, step, shard)`` through numpy's
counter-based Philox, so the pipeline's state is the integer step: a run
resumed at step k reads the batches an unbroken run reads, and the batches
are the reference's bit for bit. Shards slice one canonical global batch, so
a change of shard count on resume keeps the global batch's content.

``RepoTokenDataset`` reads token shards committed as ``.npy`` files in a
version-store repository, pinned to a commit: the paper's §7 scenario, where
a commit hash names the training data exactly. Its batches are a function of
``(commit, seed, step)``: each shard's bytes come from the commit (the
verified annex content of its key, or its blob), never from the worktree.
"""
from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


class _Batches:
    """A dataset's shard of its canonical global batch."""

    def shard_batch_at(self, step: int, shard: int, shard_count: int) -> np.ndarray:
        if self.global_batch % shard_count:
            raise ValueError(f"global batch {self.global_batch} does not split into {shard_count} shards")
        per = self.global_batch // shard_count
        return self.global_batch_at(step)[shard * per : (shard + 1) * per]


@dataclass(frozen=True)
class SyntheticTokens(_Batches):
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def global_batch_at(self, step: int) -> np.ndarray:
        """The canonical global batch for ``step``: int32 [global_batch, seq_len]."""
        bit = np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))
        return bit.integers(0, self.vocab_size, size=(self.global_batch, self.seq_len), dtype=np.int32)


class RepoTokenDataset(_Batches):
    """Token shards stored as ``.npy`` files under ``prefix`` in a Repository,
    pinned to a commit; the reference's arithmetic: the sorted shards
    flattened and concatenated as int32, cut into ``n_seq = len // seq_len``
    sequences, and ``global_batch`` of them drawn with Philox ``key=seed,
    counter=[0, 0, 0, step]``. The reference reads each shard from the
    worktree after ``annex_get``, so a worktree rewritten after the commit
    changes its batches (ROADMAP.md §C5); this class reads the commit."""

    def __init__(self, repo, commit: str, prefix: str = "data/tokens",
                 seq_len: int = 256, global_batch: int = 8, seed: int = 0):
        self.repo = repo
        self.commit = repo.resolve(commit)
        self.prefix = prefix.rstrip("/")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        tree = repo.tree_of(self.commit)
        self.files = sorted(p for p in tree if p.startswith(self.prefix + "/") and p.endswith(".npy"))
        if not self.files:
            raise FileNotFoundError(f"no token shards under {prefix} at {commit[:12]}")
        self._entries = {p: tree[p] for p in self.files}
        self._tokens = None

    @property
    def manifest(self) -> dict:
        """What goes into the reproducibility record: the exact inputs."""
        return {"data_commit": self.commit, "files": self.files}

    def _shard_bytes(self, path: str) -> bytes:
        """A shard's bytes at the commit: an annexed file's content from the
        local annex (chunks reassembled, every key verified), else its blob."""
        entry = self._entries[path]
        if entry["t"] == "annex":
            return self.repo.annex_fetch_key(entry["key"]).read(entry["key"])
        return self.repo.objects.get_blob(entry["oid"])

    def _load(self) -> np.ndarray:
        if self._tokens is None:
            parts = [np.load(io.BytesIO(self._shard_bytes(f))).ravel() for f in self.files]
            self._tokens = np.concatenate(parts).astype(np.int32)
        return self._tokens

    def global_batch_at(self, step: int) -> np.ndarray:
        """The canonical global batch for ``step``: int32 [global_batch, seq_len]."""
        toks = self._load()
        n_seq = len(toks) // self.seq_len
        usable = toks[: n_seq * self.seq_len].reshape(n_seq, self.seq_len)
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))
        return usable[rng.integers(0, n_seq, size=self.global_batch)]
