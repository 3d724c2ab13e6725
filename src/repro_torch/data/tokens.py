"""Synthetic per-silo token streams for cross-silo federated pretraining,
a NumPy copy of the reference's ``src/repro/data/tokens.py``.

A Zipf-Markov generator: each silo has a Dirichlet-skewed mixture over latent
"topics"; each topic permutes a Zipfian distribution over the vocabulary.
Every draw is the reference's, so a seed gives its tokens bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SiloTokenStream:
    def __init__(
        self,
        vocab_size: int,
        num_silos: int,
        num_topics: int = 8,
        alpha: float = 0.3,
        zipf_a: float = 1.2,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.num_silos = num_silos
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        base = ranks ** (-zipf_a)
        base /= base.sum()
        # each topic permutes the Zipf mass
        self._topic_perm = [rng.permutation(vocab_size) for _ in range(num_topics)]
        self._base = base
        self._silo_topics = rng.dirichlet(np.full(num_topics, alpha), size=num_silos)
        self._seed = seed
        # a topic's token distribution, made on first use: the reference
        # argsorts the permutation for every sequence (about 15 ms at a
        # 262,144-token vocabulary) and gets the same array each time
        self._topic_probs: Dict[int, np.ndarray] = {}

    def _probs(self, topic: int) -> np.ndarray:
        if topic not in self._topic_probs:
            self._topic_probs[topic] = self._base[np.argsort(self._topic_perm[topic])]
        return self._topic_probs[topic]

    def batch(self, silo: int, batch_size: int, seq_len: int, step: int = 0) -> np.ndarray:
        """(batch, seq_len+1) int32 tokens; shift for inputs/labels."""
        # a tuple of ints hashes alike in every process (no hash seed)
        rng = np.random.default_rng(hash((self._seed, silo, step)) % (2**32))
        topics = rng.choice(
            len(self._topic_perm), size=batch_size, p=self._silo_topics[silo]
        )
        out = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        for i, topic in enumerate(topics):
            out[i] = rng.choice(self.vocab_size, size=seq_len + 1, p=self._probs(int(topic)))
        return out
