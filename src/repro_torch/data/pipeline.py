"""Synthetic token data pipeline with shard-aware host loading.

Deterministic per-(step, host-shard) generation — every data-parallel host
draws only its shard of the global batch, so multi-host training needs no
data redistribution.  A real deployment swaps `_synthesize` for tokenized
file reads; the batching/sharding contract stays identical.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class TokenPipeline:
    """Markov-ish synthetic LM stream (so loss can actually decrease)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed bigram transition structure shared by every host
        self._next = rng.integers(0, cfg.vocab, size=cfg.vocab, dtype=np.int64)

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, labels) of shape [host_batch, seq_len]."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xD1CE)
        )
        b, s = cfg.host_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        noise = rng.random((b, s))
        for t in range(s):
            follow = self._next[toks[:, t]]
            rand = rng.integers(0, cfg.vocab, size=b)
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, follow, rand)
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
