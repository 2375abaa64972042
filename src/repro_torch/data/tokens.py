"""Synthetic token streams for the LM swarm (numpy only).

A copy of the reference package's ``repro.data.tokens`` generator.
Sequences follow a client-specific order-1 Markov chain over the vocab,
so (a) next-token prediction is learnable and (b) clients have
non-IID token distributions, as the DR clinics do. For the same
arguments it yields bitwise the arrays the reference yields.
"""
from __future__ import annotations

import numpy as np


def _client_transition(vocab: int, client: int, sharpness: float = 8.0):
    rng = np.random.default_rng(7_000 + client)
    logits = rng.normal(size=(vocab, vocab)) * sharpness / np.sqrt(vocab)
    # favour a client-specific cyclic structure => learnable + non-IID
    shift = 1 + (client % 7)
    for i in range(vocab):
        logits[i, (i + shift) % vocab] += sharpness
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


def sample_tokens(vocab: int, n_seqs: int, seq_len: int, client: int = 0,
                  seed: int = 0) -> np.ndarray:
    P = _client_transition(vocab, client)
    rng = np.random.default_rng(seed * 977 + client)
    out = np.empty((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, size=n_seqs)
    cdf = P.cumsum(axis=1)
    for t in range(seq_len):
        out[:, t] = state
        u = rng.random(n_seqs)
        state = (cdf[state] > u[:, None]).argmax(axis=1)
    return out


def make_lm_batches(vocab: int, batch: int, seq_len: int, n_batches: int,
                    client: int = 0, seed: int = 0):
    for b in range(n_batches):
        toks = sample_tokens(vocab, batch, seq_len + 1, client, seed + b)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_token_swarm_data(n_clients: int, vocab: int, n_seqs: int,
                          seq_len: int, seed: int = 0):
    """Per-client LM datasets mirroring the DR swarm-data structure."""
    clients = []
    for c in range(n_clients):
        toks = sample_tokens(vocab, n_seqs + 4, seq_len + 1, c, seed)
        tr, va, te = toks[:n_seqs], toks[n_seqs:n_seqs + 2], toks[n_seqs + 2:]
        clients.append({
            "train": (tr[:, :-1], tr[:, 1:]),
            "val": (va[:, :-1], va[:, 1:]),
            "test": (te[:, :-1], te[:, 1:]),
            "n_train": n_seqs,
        })
    return clients
