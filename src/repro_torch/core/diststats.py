"""Parameter-distribution summaries, paper §III.B (counterpart of
``repro.core.diststats``).

Each client uploads only per-tensor (mean, variance) of its parameters,
never the parameters: O(#tensors) features. The feature pair of a
floating leaf is ``[mean, log1p(var)]``, leaves in sorted path order.
The per-leaf reduction is :func:`repro_torch.kernels.ops.param_stats_batched`:
on the card the ``param_stats`` kernel, launched once per leaf over the
whole client stack.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.utils.tree import tree_map, tree_paths_and_leaves


def _floating_leaves(tree):
    pairs = sorted(tree_paths_and_leaves(tree), key=lambda kv: kv[0])
    return [leaf for _, leaf in pairs if leaf.is_floating_point()]


def swarm_distribution_matrix(stacked_params, n_clients: int = None) -> torch.Tensor:
    """Feature matrix (N, 2*T) from a client-stacked tree: what the
    coordinator receives each round."""
    leaves = _floating_leaves(stacked_params)
    if n_clients is not None and leaves and leaves[0].shape[0] != n_clients:
        raise ValueError(
            f"stacked_params has client axis {leaves[0].shape[0]} but n_clients="
            f"{n_clients}; slice the tree to the requested subset")
    cols = []
    for leaf in leaves:
        m, v = ops.param_stats_batched(leaf.contiguous())
        cols.append(m)
        cols.append(torch.log1p(v))
    return torch.stack(cols, dim=1)


def param_distribution(params) -> torch.Tensor:
    """One client's feature vector (2*T,): row 0 of the swarm matrix of
    a singleton-stacked tree."""
    return swarm_distribution_matrix(tree_map(lambda x: x[None], params))[0]


def upload_bytes(params) -> int:
    """Bytes a client uploads per round under BSO-SL (the stats)."""
    return 2 * len(_floating_leaves(params)) * 4


def full_params_bytes(params) -> int:
    """Bytes a client would upload under FedAvg / blockchain SL."""
    return int(sum(leaf.numel() * leaf.element_size()
                   for _, leaf in tree_paths_and_leaves(params)))
