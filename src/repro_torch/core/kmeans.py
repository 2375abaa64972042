"""k-means over client distribution summaries, paper §III.B
(counterpart of ``repro.core.kmeans``).

k-means++ seeding, Lloyd iterations whose assign step is
:func:`repro_torch.kernels.ops.kmeans_assign` (the ``kmeans_assign``
kernel on the card), and empty clusters re-seeded to *distinct* far
points: the j-th empty cluster takes the j-th farthest point from its
assigned centroid.

**Masked static-max clusters** (the grid axis): :func:`lloyd_step` and
:func:`kmeans` take an optional ``k_active`` (a () integer tensor on
X's device), so the static ``k`` is a pad and only clusters
``< k_active`` can be assigned to or re-seeded. The assign step passes
it to the kernel as a device operand; nothing reads it on the host. The
seeding fills all ``k`` slots, as the reference's does, so with the
first ``j`` uniforms of a ``k``-slot draw a ``k_active=j`` run is a
native ``k=j`` run: the same assignments, and live centroids equal up
to the mean step's matmul tiling.

**Masked points** (the churn axis): every entry point also takes an
optional ``mask`` (an (N,) bool tensor on X's device). Absent points
are still assigned, through the same kernel, but they are left out of
the seeding, the centroid means and the reseed targets, and a cluster
whose members are all absent counts as empty. An all-ones mask is
bitwise the unmasked run.

**Weighted points** (the two-tier coordinator's global tier): every
entry point also takes an optional ``weights`` (an (N,) non-negative
tensor on X's device), for rows that are themselves lower-tier
centroids carrying member counts. The first seed is the
``floor(u * n_pos)``-th positive-weight row, the ++ probabilities scale
to ``d * w``, the means are weight-weighted (denominator floor 1e-9,
1.0 without weights), and a zero-weight row has no vote in the means
and is never a reseed target, so a cluster of zero-weight rows only is
empty. ``weights`` composes multiplicatively with ``mask`` (an absent
point keeps weight 0); ``weights=None`` is bitwise the unweighted run.
The assign step does not read the weights.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _pairwise_sq_dists(X, C):
    """(N, K) squared euclidean distances, clamped at 0."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    return torch.clamp(x2 + c2 - 2.0 * X @ C.T, min=0.0)


def assign(X, C, k_active=None) -> torch.Tensor:
    """(N,) int32 nearest-centroid ids of X (N, F) against C (K, F), ties
    to the first; with ``k_active`` (an int or a () integer tensor) only
    centroids ``< k_active`` are eligible. A CUDA tensor takes the
    ``kmeans_assign`` kernel, a CPU tensor its plain version."""
    if k_active is not None and not isinstance(k_active, torch.Tensor):
        k_active = torch.tensor(int(k_active), dtype=torch.int32, device=X.device)
    return ops.kmeans_assign(X.float(), C.float(), k_active)


def _point_weights(X, mask, weights):
    """(wf, pos): the float scale of distances and means and the bool
    eligibility of seeds and reseed targets, from the participation
    ``mask`` and the point ``weights`` (each (N,) or None); (None, None)
    when both are None. The mask alone gives its 0/1 floats, as the
    masked path always has; with weights they are multiplied."""
    if weights is None and mask is None:
        return None, None
    if weights is None:
        return mask.to(X.dtype), mask.bool()
    w = weights.to(X.dtype)
    if mask is not None:
        w = w * mask.to(X.dtype)
    return w, w > 0


def kmeans_pp_init(X, k: int, *, generator: torch.Generator = None, init_idx=None,
                   u=None, mask=None, weights=None) -> torch.Tensor:
    """k-means++ seeding -> (k, F) initial centroids.

    ``init_idx`` (k,) injects the seed rows (how a test hands over the
    reference's draws). Otherwise seed i is picked by the uniform
    ``u[i]`` ((k,) in [0, 1), drawn from ``generator`` when not given):
    the first uniformly, each further one by inverting the cumulative
    squared distances to the nearest chosen seed, so a point is taken
    with probability proportional to that distance. The draws do not
    depend on X, so a round can take them before it has X.

    ``mask`` makes the uniform pick one over the present points (the
    ``floor(u * n_present)``-th of them) and zeroes the absent points'
    distances. With all ones both are identities: the same rows as the
    unmasked seeding, bitwise. ``weights`` makes the uniform pick one
    over the positive-weight points (of the present ones, with ``mask``)
    and scales the distances to ``d * w``."""
    if init_idx is not None:
        return X[torch.as_tensor(init_idx, device=X.device).long()]
    N = X.shape[0]
    if u is None:
        u = torch.rand((k,), generator=generator, device=X.device, dtype=torch.float64)
    u = torch.as_tensor(u, device=X.device).double()
    wf, pos = _point_weights(X, mask, weights)
    if pos is None:
        uniform = torch.clamp((u * N).long(), max=N - 1)         # (k,)
    else:
        cum_pos = torch.cumsum(pos.long(), dim=0)
        n_pos = torch.clamp(cum_pos[-1], min=1)
        rank = torch.minimum((u * n_pos.double()).long(), n_pos - 1)
        uniform = torch.clamp(torch.searchsorted(cum_pos, rank + 1), max=N - 1)
    idx = [uniform[:1]]
    for i in range(1, k):
        d = torch.min(_pairwise_sq_dists(X, X[torch.cat(idx)]), dim=1).values
        if wf is not None:
            d = d * wf
        cum = torch.cumsum(d.double(), dim=0)
        pick = torch.searchsorted(cum, (u[i] * cum[-1])[None], right=True)
        # all points on the seeds: fall back to the uniform pick
        idx.append(torch.where(cum[-1] > 0, torch.clamp(pick, max=N - 1), uniform[i:i + 1]))
    return X[torch.cat(idx)]


def lloyd_step(X, C, k: int, k_active=None, mask=None, weights=None) -> torch.Tensor:
    """One Lloyd iteration: assign, recompute means, reseed empties.
    With ``k_active`` only clusters ``< k_active`` are assigned to and
    count as re-seedable empties, so the dead pad slots never take a far
    point that a live empty cluster would get. With ``mask`` absent
    points weigh nothing in the means and are never reseed targets, so
    a cluster of absent points only is empty. With ``weights`` the means
    are weighted and zero-weight points act as absent ones; the
    denominator's floor drops from 1.0 to 1e-9 so that fractional weight
    sums still give true means (an empty cluster is reseeded either
    way), which keeps ``weights=None`` bitwise as it was."""
    a = ops.kmeans_assign(X, C, k_active).long()
    wf, pos = _point_weights(X, mask, weights)
    onehot = torch.nn.functional.one_hot(a, k).to(X.dtype)       # (N, K)
    if wf is not None:
        onehot = onehot * wf[:, None]
    counts = onehot.sum(dim=0)                                   # (K,)
    floor = 1.0 if weights is None else 1e-9
    newC = (onehot.T @ X) / torch.clamp(counts[:, None], min=floor)
    # empty clusters -> distinct far points, farthest first; argsort is
    # stable so equal distances keep index order, as jnp.argsort does
    diff = X - C[a]
    d = torch.sum(diff * diff, dim=1)
    if pos is not None:
        d = torch.where(pos, d, -torch.inf)
    far_order = torch.argsort(-d, stable=True)
    empty = counts == 0
    if k_active is not None:
        empty = empty & (torch.arange(k, device=X.device) < k_active)
    rank = torch.clamp(torch.cumsum(empty.int(), dim=0) - 1, 0, X.shape[0] - 1)
    return torch.where(empty[:, None], X[far_order[rank]], newC)


def kmeans(X, k: int, iters: int = 20, *, generator: torch.Generator = None,
           init_idx=None, u=None, k_active=None, mask=None, weights=None):
    """Returns (centroids (k, F), assignments (N,) int32). The seeding
    takes ``init_idx`` or ``u`` (see :func:`kmeans_pp_init`). With
    ``k_active`` the assignments lie in ``[0, k_active)`` and centroid
    rows ``>= k_active`` are dead pad. With ``mask`` every point is
    assigned and only present points seed, move and reseed centroids.
    With ``weights`` the seeding and the means are weighted (the rows
    of X may be lower-tier centroids, ``weights`` their member counts)
    and every point is still assigned."""
    C = kmeans_pp_init(X, k, generator=generator, init_idx=init_idx, u=u, mask=mask,
                       weights=weights)
    for _ in range(iters):
        C = lloyd_step(X, C, k, k_active, mask, weights)
    return C, ops.kmeans_assign(X, C, k_active)
