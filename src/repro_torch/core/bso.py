"""Brain Storm Aggregation, paper §III.C (counterpart of
``repro.core.bso``).

Two versions of one decision procedure. :func:`brain_storm` is the
reference's ``brain_storm_jax``, on the device (below). The fleet's host
coordinator runs :func:`brain_storm_host`, a copy of the reference's
numpy ``brain_storm`` (named apart because ``brain_storm`` is taken
here); given the same ``numpy.random.Generator`` its plan is bitwise the
reference's.

The coordinator's per-round decision in fixed shapes over a static
``k``: centers are the best validation score of each cluster (masked
argmax); with r1 > p1 a cluster's center is replaced by a uniformly
random member (masked Gumbel-argmax); then, cluster by cluster, with
r2 > p2 its center swaps with the center of a uniformly random other
occupied cluster, and the two clients trade cluster membership. The
swaps run in order, unrolled over ``k``, so later swaps see earlier
ones. Nothing leaves the device.

The random inputs are injectable: ``BSODraws`` holds r1 (k,), the
member gumbels g (k, N), r2 (k,) and the partner gumbels g2 (k, k).
By default they are drawn from a ``torch.Generator``.

On the grid axis ``k`` is the static pad and ``p1`` / ``p2`` are ()
tensors of the row. A pad slot no client is assigned to is unoccupied,
so it never replaces, swaps or counts an event: the live slots act as
in a native ``k`` run on the first slices of the same draws.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch


class BSODraws(NamedTuple):
    r1: torch.Tensor                 # (k,) uniform: replace if r1 > p1
    g: torch.Tensor                  # (k, N) gumbel: random member
    r2: torch.Tensor                 # (k,) uniform: swap if r2 > p2
    g2: torch.Tensor                 # (k, k) gumbel: swap partner


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def draw_bso(k: int, n: int, generator: torch.Generator, device) -> BSODraws:
    return BSODraws(
        r1=torch.rand((k,), generator=generator, device=device),
        g=_gumbel((k, n), generator, device),
        r2=torch.rand((k,), generator=generator, device=device),
        g2=_gumbel((k, k), generator, device))


@dataclass
class BSAPlan:
    """The host coordinator's per-round output."""
    assignments: np.ndarray            # (N,) effective cluster of each client
    centers: np.ndarray                # (K,) client index of each cluster center
    events: List[str] = field(default_factory=list)


def brain_storm_host(rng: np.random.Generator, assignments: np.ndarray,
                     val_scores: np.ndarray, k: int, p1: float, p2: float) -> BSAPlan:
    """The brain storm on the host, in numpy: a copy of the reference's
    ``repro.core.bso.brain_storm`` (the on-device version is
    :func:`brain_storm`). ``assignments`` come from k-means on the
    distribution summaries, ``val_scores`` are the clients' local
    validation accuracies. ``rng`` is drawn in the reference's order: a
    uniform for each occupied cluster's replacement (r1 > p1, then a
    member by ``rng.choice``), then one for each occupied cluster's swap
    (r2 > p2, then a partner)."""
    assignments = np.asarray(assignments).copy()
    val_scores = np.asarray(val_scores)
    events: List[str] = []

    # 1. centers = best validation score per cluster
    centers = np.full((k,), -1, dtype=np.int64)
    for c in range(k):
        members = np.where(assignments == c)[0]
        if len(members) == 0:
            continue
        centers[c] = members[np.argmax(val_scores[members])]

    # 2a. random center replacement (r1 > p1)
    for c in range(k):
        members = np.where(assignments == c)[0]
        if len(members) == 0:
            continue
        r1 = rng.uniform()
        if r1 > p1:
            new_center = int(rng.choice(members))
            if new_center != centers[c]:
                events.append(f"replace: cluster {c} center "
                              f"{centers[c]} -> {new_center} (r1={r1:.3f})")
            centers[c] = new_center

    # 2b. cross-cluster center swap (r2 > p2); the swapped clients also
    # trade aggregation membership
    occupied = [c for c in range(k) if centers[c] >= 0]
    for c in occupied:
        r2 = rng.uniform()
        if r2 > p2 and len(occupied) > 1:
            other = int(rng.choice([o for o in occupied if o != c]))
            ci, oi = centers[c], centers[other]
            centers[c], centers[other] = oi, ci
            assignments[ci], assignments[oi] = assignments[oi], assignments[ci]
            events.append(f"swap: centers of clusters {c} and {other} "
                          f"(clients {ci} <-> {oi}, r2={r2:.3f})")

    return BSAPlan(assignments=assignments, centers=centers, events=events)


def brain_storm(assignments, val_scores, k: int, p1, p2, *,
                draws: BSODraws = None, generator: torch.Generator = None):
    """The on-device brain storm (the reference's ``brain_storm_jax``;
    the host's numpy version is :func:`brain_storm_host`). ``p1`` /
    ``p2`` are floats or () tensors on the assignments' device. Returns
    ``(assignments, centers, n_replaced, n_swapped)``: post-swap (N,)
    int32 assignments, (k,) int32 center client ids (-1 for an empty
    cluster) and the round's event counts."""
    a = assignments.to(torch.int32)
    dev = a.device
    val = val_scores.float()
    N = a.shape[0]
    if draws is None:
        draws = draw_bso(k, N, generator, dev)
    r1, g, r2, g2 = (t.to(dev) for t in draws)
    ks = torch.arange(k, dtype=torch.int32, device=dev)
    member = a[None, :] == ks[:, None]                             # (k, N)
    occupied = member.any(dim=1)
    n_occ = occupied.sum()
    neg_inf = torch.tensor(float("-inf"), device=dev)

    # 1. centers = best validation score per cluster
    centers = torch.argmax(torch.where(member, val[None, :], neg_inf), dim=1).int()
    centers = torch.where(occupied, centers, -1)

    # 2a. random center replacement (r1 > p1)
    rand_member = torch.argmax(torch.where(member, g, neg_inf), dim=1).int()
    do_rep = (r1 > p1) & occupied
    n_replaced = (do_rep & (rand_member != centers)).sum().int()
    centers = torch.where(do_rep, rand_member, centers)

    # 2b. sequential cross-cluster center swaps (r2 > p2)
    n_swapped = torch.zeros((), dtype=torch.int32, device=dev)
    for c in range(k):
        valid_other = occupied & (ks != c)
        other = torch.argmax(torch.where(valid_other, g2[c], neg_inf))
        do_swap = (r2[c] > p2) & occupied[c] & (n_occ > 1)
        ci, oi = centers[c].long(), centers[other].long()
        swapped_centers = centers.clone()
        swapped_centers[c] = centers[other]
        swapped_centers[other] = centers[c]
        swapped_a = a.clone()
        swapped_a[ci] = a[oi]
        swapped_a[oi] = a[ci]
        centers = torch.where(do_swap, swapped_centers, centers)
        a = torch.where(do_swap, swapped_a, a)
        n_swapped = n_swapped + do_swap.int()
    return a, centers, n_replaced, n_swapped
