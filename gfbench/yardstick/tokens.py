"""The benchmark's token generator: a frozen copy of the port's
``data/synthetic.py`` (``SyntheticLM``), so that a change to the program
cannot change what the benchmark feeds it.

Tokens follow an order-1 Markov chain over a fixed random successor table
(each token has ``branching`` likely successors). Batch t is a pure
function of (seed, step, row), so any shard count sees the same global
sample set, and every row of every step differs. With ``num_codebooks``
K > 1 (an audio model's codec streams) tokens and labels are tiled over a
last axis of K.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, vocab_size: int, seed: int = 0,
                 num_codebooks: int = 0, branching: int = 4):
        self.vocab = vocab_size
        # RandomState takes seeds below 2**32; the generator of each row
        # takes the whole seed.
        self.seed = seed
        self.num_codebooks = num_codebooks
        self.branching = branching
        rng = np.random.RandomState(seed % 2 ** 32)
        self.succ = rng.randint(0, vocab_size, size=(vocab_size, branching))

    def batch_numpy(self, step: int, batch_size: int, seq_len: int,
                    shard: int = 0) -> Dict[str, np.ndarray]:
        """This shard's batch for global ``step`` as int64 numpy arrays."""
        rows = shard * batch_size + np.arange(batch_size)
        rngs = [np.random.default_rng([self.seed, step, int(r)])
                for r in rows]
        tok = np.array([g.integers(0, self.vocab) for g in rngs])
        choices = np.stack([g.integers(0, self.branching, seq_len + 1)
                            for g in rngs])
        toks = np.empty((batch_size, seq_len + 1), dtype=np.int64)
        for t in range(seq_len + 1):
            tok = self.succ[tok, choices[:, t]]
            toks[:, t] = tok
        tokens, labels = toks[:, :-1], toks[:, 1:]
        if self.num_codebooks > 1:
            k = self.num_codebooks
            tokens = np.repeat(tokens[..., None], k, axis=-1)
            labels = np.repeat(labels[..., None], k, axis=-1)
        return {"tokens": tokens, "labels": labels}

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0) -> Dict[str, torch.Tensor]:
        """The same batch as int64 CPU tensors."""
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.batch_numpy(step, batch_size, seq_len,
                                             shard).items()}
