"""Synthetic LM token pipeline: deterministic Zipf streams per client — a
numpy copy of ``repro/data/lm.py`` (the same tokens from the same seed).

Used by the LM training driver and its tests (no corpora ship offline).
Markov structure gives the model something learnable; per-client seeds give
federated non-IIDness (each client = its own topic mixture).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int, alpha: float = 1.2):
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(vocab, size=n, p=p).astype(np.int32)


def markov_tokens(rng: np.random.Generator, n: int, vocab: int,
                  order_bias: float = 0.7):
    """Learnable stream: next token = f(prev) w.p. order_bias else Zipf."""
    base = zipf_tokens(rng, n, vocab)
    perm = rng.permutation(vocab)
    out = base.copy()
    follow = rng.random(n) < order_bias
    out[1:][follow[1:]] = perm[out[:-1][follow[1:]]] % vocab
    return out


def lm_batches(seed: int, n_steps: int, global_batch: int, seq_len: int,
               vocab: int) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        toks = markov_tokens(rng, global_batch * (seq_len + 0), vocab)
        yield {"tokens": toks.reshape(global_batch, seq_len)}


def client_lm_batches(seed: int, client_id: int, steps: int, batch: int,
                      seq_len: int, vocab: int) -> Dict[str, np.ndarray]:
    """(steps, batch, seq) stack for one federated client."""
    rng = np.random.default_rng(seed * 100003 + client_id)
    toks = markov_tokens(rng, steps * batch * seq_len, vocab)
    return {"tokens": toks.reshape(steps, batch, seq_len)}
