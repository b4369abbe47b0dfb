"""Deterministic, skippable LM token pipeline (the port's copy of the JAX
package's ``data/tokens.py``; pure numpy, so it gives the reference's
tokens bit for bit).

  * ``batch_at(step)`` is a pure function of (seed, step): a restart or
    replay after a checkpoint restore regenerates the exact batch with no
    state (counter-based Philox, no sequential RNG);
  * shard-aware: ``batch_at(step, shard, n_shards)`` returns the rows a
    data-parallel host owns, so hosts never exchange input data.

The synthetic corpus is a fixed random BIGRAM chain per seed: token t+1 is
drawn from a sparse row distribution of token t.  This gives a learnable
signal (a trained LM beats the unigram entropy) with no corpus files.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    branching: int = 8      # successors per token in the bigram chain

    def __post_init__(self) -> None:
        rng = np.random.Generator(np.random.Philox(key=self.seed))
        # fixed sparse bigram structure: each token has `branching`
        # successors with Zipf-ish probabilities
        self._succ = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching),
            dtype=np.int32)
        w = 1.0 / np.arange(1, self.branching + 1)
        self._cum = np.cumsum(w / w.sum()).astype(np.float32)

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """The ``batch // n_shards`` rows of step ``step`` that shard
        ``shard`` owns: ``tokens`` (rows, seq_len) int32 and an all-ones
        ``loss_mask`` int8."""
        assert self.batch % n_shards == 0
        rows = self.batch // n_shards
        rng = np.random.Generator(np.random.Philox(
            key=self.seed + 1, counter=step * n_shards + shard))
        toks = np.empty((rows, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=rows)
        u = rng.random((rows, self.seq_len), dtype=np.float32)
        for t in range(1, self.seq_len):
            choice = np.searchsorted(self._cum, u[:, t])
            toks[:, t] = self._succ[toks[:, t - 1], choice]
        return {"tokens": toks,
                "loss_mask": np.ones((rows, self.seq_len), np.int8)}

    def bigram_entropy(self) -> float:
        """Entropy (nats/token) of the chain: the floor a perfect model
        reaches."""
        w = np.diff(np.concatenate([[0.0], self._cum]))
        return float(-(w * np.log(w)).sum())
