"""Sub-seeds of a run's ``--seed``: one independent stream a purpose
(data, weights, draws), so that adding draws to one leaves the others
where they were."""
from __future__ import annotations

import numpy as np

TAGS = {"data": 1, "weights": 2, "draws": 3}


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from any whole ``seed`` (negative or
    above 64 bits included), through numpy's SeedSequence."""
    words = [int(w) for w in np.frombuffer(int(seed).to_bytes(16, "little", signed=True),
                                           dtype=np.uint32)]
    state = np.random.SeedSequence(words + [TAGS[purpose]]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def generator(seed: int, purpose: str, device) -> "torch.Generator":  # noqa: F821
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, purpose))
    return gen
