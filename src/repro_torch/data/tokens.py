"""Synthetic token pipeline for LM training / serving drivers, a copy of
``repro.data.tokens`` (pure numpy: the same seeds give the same arrays).

Deterministic, host-sharded synthetic corpora: a Zipf-ish unigram stream
with short-range Markov structure so small models have something learnable
(loss decreases measurably within a few hundred steps — used by the e2e
training example).  Each host process can carve out its slice via
(host_id, num_hosts) without coordination.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["TokenStream", "make_batches"]


class TokenStream:
    def __init__(
        self,
        vocab_size: int,
        seed: int = 0,
        zipf_a: float = 1.2,
        markov_strength: float = 0.7,
        order: int = 1,
    ):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.unigram = p / p.sum()
        self.markov_strength = markov_strength
        # deterministic successor table: each token has a preferred follower
        self.successor = self.rng.permutation(vocab_size)

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), dtype=np.int32)
        cur = self.rng.choice(self.vocab, size=batch, p=self.unigram)
        out[:, 0] = cur
        for t in range(1, seq):
            follow = self.rng.uniform(size=batch) < self.markov_strength
            fresh = self.rng.choice(self.vocab, size=batch, p=self.unigram)
            cur = np.where(follow, self.successor[cur], fresh)
            out[:, t] = cur
        return out


def make_batches(
    vocab_size: int,
    batch: int,
    seq: int,
    n_frontend_tokens: int = 0,
    d_model: int = 0,
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
) -> Iterator[dict]:
    """Infinite batch iterator; per-host slice is seeded independently."""
    stream = TokenStream(vocab_size, seed=seed * num_hosts + host_id)
    rng = np.random.default_rng(seed * num_hosts + host_id + 1)
    s_text = seq - n_frontend_tokens
    while True:
        b = {"tokens": stream.sample(batch, s_text)}
        if n_frontend_tokens:
            b["frontend"] = rng.normal(
                size=(batch, n_frontend_tokens, d_model)
            ).astype(np.float32)
        yield b
