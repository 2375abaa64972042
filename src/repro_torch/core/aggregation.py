"""Parameter aggregation, paper Eq. 2 (counterpart of
``repro.core.aggregation``).

Sim regime: clients live on one device as a stacked tree; cluster
FedAvg is a weighted segment sum over the client axis (``index_add_``)
followed by a gather back to every member. :func:`cluster_fedavg_masked`
is the churn axis's variant.

Fleet regime: a rank holds a contiguous slice of the client axis, and
Eq. 2 is the same functions given the mesh's ``group``: the cluster
totals and each leaf's segment sums are all-reduced over it
(:func:`cluster_fedavg_psum` and its masked variant are the reference's
names for that, :func:`cluster_psum_fedavg` the case of one client a
rank). ``group`` stands where the reference takes ``axis_name``. An
Eq. 2 is then 1 + #leaves collectives, as the reference's one psum a
leaf, each recorded in :data:`repro_torch.utils.collectives.CENSUS`
under the tag ``"eq2"``.

A placed leaf (a DTensor whose client axis is whole, the fleet's
``spmd="auto"`` layout) is summed on this rank's shard and placed back
as it was: each rank all-reduces its own shard's sums over ``group``
(the pod group), and no leaf is gathered.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import on_shard
from repro_torch.utils.collectives import all_reduce_sum
from repro_torch.utils.tree import tree_leaves, tree_map, tree_weighted_sum


def fedavg(params_list, n_samples):
    """Classic FedAvg over an explicit list of client trees."""
    w = torch.as_tensor(n_samples, dtype=torch.float32)
    w = w / torch.clamp(w.sum(), min=1e-9)
    return tree_weighted_sum(params_list, w)


def singleton_assignments(n: int, device=None) -> torch.Tensor:
    """Every client in its own cluster: :func:`cluster_fedavg` with
    ``k >= n`` is then the identity (each weight normalises to w/w)."""
    return torch.arange(n, dtype=torch.int32, device=device)


def _eq2(stacked_params, a, w, k: int, take=None, group=None):
    """Eq. 2 with weights ``w`` normalised by their cluster totals:
    every leaf's weighted (k, ...) segment sum, read back by every
    member. ``take`` (N,) bool gates who receives (None: every client),
    and a cluster whose total is zero aggregates nothing. With ``group``
    the totals and each leaf's sums are all-reduced over it, one
    collective each (the reference's one psum a leaf)."""
    cluster_tot = torch.zeros((k,), dtype=torch.float32, device=a.device).index_add_(0, a, w)
    if group is not None:
        all_reduce_sum(cluster_tot, group, "eq2")
    wn = w / torch.clamp(cluster_tot[a], min=1e-9)
    if take is not None:
        # receive = participated and the cluster aggregated something
        take = take & (cluster_tot[a] > 0.0)

    def agg_shard(leaf):
        lf = leaf.float()
        weighted = lf * wn.reshape((-1,) + (1,) * (lf.dim() - 1))
        sums = torch.zeros((k,) + lf.shape[1:], dtype=torch.float32,
                           device=lf.device).index_add_(0, a, weighted)
        if group is not None:
            all_reduce_sum(sums, group, "eq2")
        agg = sums[a].to(leaf.dtype)
        if take is None:
            return agg
        return torch.where(take.reshape((-1,) + (1,) * (leaf.dim() - 1)), agg, leaf)

    # a placed leaf's client axis is whole on every rank, so its segment
    # sums are this rank's shard of the whole leaf's
    return tree_map(lambda leaf: on_shard(agg_shard, leaf), stacked_params)


def cluster_fedavg(stacked_params, assignments, n_samples, k: int, group=None):
    """Eq. 2 within every cluster at once.

    stacked_params: tree with leading client axis N.
    assignments:    (N,) int cluster ids (post brain storm), < k.
    n_samples:      (N,) training set sizes |D_h|.
    Returns the stacked tree where client i holds its cluster's
    aggregate (the redistribution step).

    ``group`` makes this a rank's local slice of the client axis (the
    fleet regime): ``assignments`` and ``n_samples`` are the local
    (n_local,) slices carrying global cluster ids below ``k``, and the
    cluster totals and segment sums are all-reduced over ``group``."""
    a = torch.as_tensor(assignments).long()
    w = torch.as_tensor(n_samples, dtype=torch.float32, device=a.device)
    return _eq2(stacked_params, a, w, k, group=group)


def cluster_fedavg_masked(stacked_params, assignments, weights, present, k: int, group=None):
    """Churn-aware Eq. 2: :func:`cluster_fedavg`'s op sequence with two
    churn semantics on top.

    - ``weights`` (N,) are the effective Eq. 2 weights, participation
      folded in by the caller: 0 for a hard-masked absent client,
      ``|D_h| * decay**staleness`` for the staleness-weighted option.
    - ``present`` (N,) bool gates who receives: an absent client keeps
      its own params.

    A cluster whose total weight is zero (every member absent under the
    hard mask) aggregates nothing: its members keep their own params and
    no NaN comes of the zero total. With ``present`` all ones and
    ``weights = n_samples * 1.0`` this is bitwise :func:`cluster_fedavg`
    (``x * 1.0`` is exact and ``where(True, agg, own)`` the identity).
    ``group`` as in :func:`cluster_fedavg`; the guard and the receive
    mask then apply on each rank, which all see the same totals."""
    a = torch.as_tensor(assignments).long()
    w = torch.as_tensor(weights, dtype=torch.float32, device=a.device)
    present = torch.as_tensor(present, device=a.device).bool()
    return _eq2(stacked_params, a, w, k, take=present, group=group)


def cluster_fedavg_psum(stacked_params, assignments, n_samples, k: int, group):
    """The reference's name for :func:`cluster_fedavg` over ``group``.
    On one rank it is the sim Eq. 2 bitwise on the CPU (a sum of one
    addend, an all-reduce over one rank)."""
    return cluster_fedavg(stacked_params, assignments, n_samples, k, group=group)


def cluster_fedavg_psum_masked(stacked_params, assignments, weights, present, k: int, group):
    """The reference's name for :func:`cluster_fedavg_masked` over
    ``group``."""
    return cluster_fedavg_masked(stacked_params, assignments, weights, present, k, group=group)


def cluster_psum_fedavg(params, weight, my_cluster, k: int, group):
    """Eq. 2 with one client a rank: ``params`` is this rank's (unstacked)
    tree, ``weight`` its () |D_h| and ``my_cluster`` its () cluster id.
    It is :func:`cluster_fedavg` over ``group`` on a local slice of one
    client (the reference's k masked psums a leaf as one (k, ...) sum)."""
    dev = tree_leaves(params)[0].device
    one = cluster_fedavg(tree_map(lambda x: x.unsqueeze(0), params),
                         torch.as_tensor(my_cluster, device=dev).reshape(1),
                         torch.as_tensor(weight, dtype=torch.float32, device=dev).reshape(1),
                         k, group=group)
    return tree_map(lambda x: x[0], one)
