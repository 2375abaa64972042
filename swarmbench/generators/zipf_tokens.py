"""Token clients for the LM swarm, drawn on the device from the seed.

Ids are i.i.d. Zipf over the whole vocabulary, ``P(rank r) ~ r ** -a``,
through a permutation of the ids a domain: client ``c`` is in domain
``c % domains``, so clients of one domain share their frequent tokens
and clients of different domains do not (the non-IID split the
coordinator's clusters are for). Each sequence is ``seq_len + 1`` ids:
tokens are the first ``seq_len``, labels the last ``seq_len`` (next
token). Not the program's ``data/tokens.py`` generator, which builds a
dense float64 (vocab, vocab) transition matrix a client.

Parameters (the ``data`` section of a cell's file): ``vocab``,
``seq_len``, ``n_clients``, ``train_seqs``, ``val_seqs``, ``test_seqs``,
``zipf_a``, ``domains``."""
from __future__ import annotations

import torch

from swarmbench.harness.seeds import generator


def make_clients(seed: int, params: dict, device) -> list:
    """A list of ``{"train": (tokens, labels), "val": ..., "test": ...,
    "n_train": n}`` with int32 (n, seq_len) numpy arrays."""
    V, S = params["vocab"], params["seq_len"]
    n_tr, n_val, n_te = params["train_seqs"], params["val_seqs"], params["test_seqs"]
    gen = generator(seed, "data", device)
    ranks = torch.arange(1, V + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -params["zipf_a"], 0)
    cdf = cdf / cdf[-1]
    perms = [torch.randperm(V, generator=gen, device=device) for _ in range(params["domains"])]
    n_seq = n_tr + n_val + n_te
    u = torch.rand((params["n_clients"], n_seq, S + 1), generator=gen, device=device,
                   dtype=torch.float64)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=V - 1)
    out = []
    for c in range(params["n_clients"]):
        ids = perms[c % params["domains"]][rank[c]].to(torch.int32).cpu().numpy()
        parts = (ids[:n_tr], ids[n_tr:n_tr + n_val], ids[n_tr + n_val:])
        out.append({"train": (parts[0][:, :-1], parts[0][:, 1:]),
                    "val": (parts[1][:, :-1], parts[1][:, 1:]),
                    "test": (parts[2][:, :-1], parts[2][:, 1:]),
                    "n_train": n_tr})
    return out
