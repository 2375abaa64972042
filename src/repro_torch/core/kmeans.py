"""k-means over client distribution summaries, paper §III.B
(counterpart of ``repro.core.kmeans``).

The plain static-``k`` path of the swarm round: k-means++ seeding,
Lloyd iterations whose assign step is
:func:`repro_torch.kernels.ops.kmeans_assign` (the ``kmeans_assign``
kernel on the card), and empty clusters re-seeded to *distinct* far
points: the j-th empty cluster takes the j-th farthest point from its
assigned centroid. The masked, weighted and ``k_active`` paths of the
reference are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _pairwise_sq_dists(X, C):
    """(N, K) squared euclidean distances, clamped at 0."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * X @ C.T, min=0.0)


def kmeans_pp_init(X, k: int, *, generator: torch.Generator = None,
                   init_idx=None) -> torch.Tensor:
    """k-means++ seeding -> (k, F) initial centroids.

    ``init_idx`` (k,) injects the seed rows (how a test hands over the
    reference's draws). Without it the first seed is uniform and each
    further seed is drawn with probability proportional to its squared
    distance from the nearest chosen seed, from ``generator``."""
    if init_idx is not None:
        return X[torch.as_tensor(init_idx, device=X.device).long()]
    N = X.shape[0]
    idx = [torch.randint(0, N, (1,), generator=generator, device=X.device)]
    for _ in range(1, k):
        d = torch.min(_pairwise_sq_dists(X, X[torch.cat(idx)]), dim=1).values
        total = d.sum()
        # all points on the seeds: fall back to uniform (multinomial
        # refuses an all-zero distribution)
        p = torch.where(total > 0, d / torch.clamp(total, min=1e-12),
                        torch.full_like(d, 1.0 / N))
        idx.append(torch.multinomial(p, 1, generator=generator))
    return X[torch.cat(idx)]


def lloyd_step(X, C, k: int) -> torch.Tensor:
    """One Lloyd iteration: assign, recompute means, reseed empties."""
    a = ops.kmeans_assign(X, C).long()
    onehot = torch.nn.functional.one_hot(a, k).to(X.dtype)       # (N, K)
    counts = onehot.sum(dim=0)                                   # (K,)
    newC = (onehot.T @ X) / torch.clamp(counts[:, None], min=1.0)
    # empty clusters -> distinct far points, farthest first; argsort is
    # stable so equal distances keep index order, as jnp.argsort does
    diff = X - C[a]
    d = torch.sum(diff * diff, dim=1)
    far_order = torch.argsort(-d, stable=True)
    empty = counts == 0
    rank = torch.clamp(torch.cumsum(empty.int(), dim=0) - 1, 0, X.shape[0] - 1)
    return torch.where(empty[:, None], X[far_order[rank]], newC)


def kmeans(X, k: int, iters: int = 20, *, generator: torch.Generator = None,
           init_idx=None):
    """Returns (centroids (k, F), assignments (N,) int32)."""
    C = kmeans_pp_init(X, k, generator=generator, init_idx=init_idx)
    for _ in range(iters):
        C = lloyd_step(X, C, k)
    return C, ops.kmeans_assign(X, C)
