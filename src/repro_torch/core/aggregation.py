"""Parameter aggregation, paper Eq. 2 (counterpart of
``repro.core.aggregation``).

Sim regime: clients live on one device as a stacked tree; cluster
FedAvg is a weighted segment sum over the client axis (``index_add_``)
followed by a gather back to every member. The masked and collective
variants are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map, tree_weighted_sum


def fedavg(params_list, n_samples):
    """Classic FedAvg over an explicit list of client trees."""
    w = torch.as_tensor(n_samples, dtype=torch.float32)
    w = w / torch.clamp(w.sum(), min=1e-9)
    return tree_weighted_sum(params_list, w)


def singleton_assignments(n: int, device=None) -> torch.Tensor:
    """Every client in its own cluster: :func:`cluster_fedavg` with
    ``k >= n`` is then the identity (each weight normalises to w/w)."""
    return torch.arange(n, dtype=torch.int32, device=device)


def cluster_fedavg(stacked_params, assignments, n_samples, k: int):
    """Eq. 2 within every cluster at once.

    stacked_params: tree with leading client axis N.
    assignments:    (N,) int cluster ids (post brain storm), < k.
    n_samples:      (N,) training set sizes |D_h|.
    Returns the stacked tree where client i holds its cluster's
    aggregate (the redistribution step)."""
    a = torch.as_tensor(assignments).long()
    w = torch.as_tensor(n_samples, dtype=torch.float32, device=a.device)
    cluster_tot = torch.zeros((k,), dtype=torch.float32, device=a.device).index_add_(0, a, w)
    wn = w / torch.clamp(cluster_tot[a], min=1e-9)

    def agg_leaf(leaf):
        lf = leaf.float()
        weighted = lf * wn.reshape((-1,) + (1,) * (lf.dim() - 1))
        sums = torch.zeros((k,) + lf.shape[1:], dtype=torch.float32,
                           device=lf.device).index_add_(0, a, weighted)
        return sums[a].to(leaf.dtype)

    return tree_map(agg_leaf, stacked_params)
