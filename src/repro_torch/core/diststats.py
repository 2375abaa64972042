"""Parameter-distribution summaries, paper §III.B (counterpart of
``repro.core.diststats``).

Each client uploads only per-tensor (mean, variance) of its parameters,
never the parameters: O(#tensors) features. The feature pair of a
floating leaf is ``[mean, log1p(var)]``, leaves in sorted path order.
The reduction is :func:`repro_torch.kernels.ops.param_stats_leaves`: on
the card the ``param_stats`` kernel, one launch over every leaf of the
whole client stack.

A placed stack (DTensor leaves whose client axis is whole, the fleet's
``spmd="auto"`` layout) runs the same one call on this rank's shards,
then merges each leaf's shard statistics over the leaf's mesh
(:func:`placed_param_stats`, :func:`merge_shard_stats`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.rules import is_placed, mesh_group
from repro_torch.utils.collectives import all_gather_stack
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
    if leaves and is_placed(leaves[0]):
        stats = placed_param_stats(leaves)
    else:
        stats = ops.param_stats_leaves([leaf.contiguous() for leaf in leaves])   # (N, T, 2)
    stats[:, :, 1].log1p_()
    return stats.view(stats.shape[0], -1)


def merge_shard_stats(stats: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The (mean, var) of a whole from its parts' (Chan's rule): ``stats``
    (P, ..., 2) the parts' fp32 [mean, var], ``counts`` (P, ...) their
    element counts. mean = sum(n_i * mean_i) / n and var = sum(n_i *
    (var_i + (mean_i - mean)^2)) / n, in float64, var clamped at 0; a part
    of 0 elements adds nothing (its NaN row included), and a whole of 0
    elements gives NaN, as the plain version's empty row. Returns (...,
    2) fp32."""
    n_i = counts.double()
    live = n_i > 0
    m_i = torch.where(live, stats[..., 0].double(), 0.0)
    v_i = torch.where(live, stats[..., 1].double(), 0.0)
    n = n_i.sum(0)
    mean = (n_i * m_i).sum(0) / n
    var = (n_i * (v_i + torch.square(m_i - mean))).sum(0) / n
    return torch.stack([mean, torch.clamp(var, min=0.0)], dim=-1).float()


def placed_param_stats(leaves) -> torch.Tensor:
    """(N, T, 2) fp32 [mean, var] of T placed client-stacked leaves of
    one mesh: one ``ops.param_stats_leaves`` call over this rank's shards
    (the ``param_stats`` kernel on the card), one all-gather of each
    shard's (count, mean, var) over every rank of the mesh (census tag
    ``"stats_merge"``), then :func:`merge_shard_stats`. A replicated
    copy counts once: a rank's shard is counted only where its
    coordinate is 0 on every mesh dimension that does not split the
    leaf."""
    from torch.distributed.tensor import Shard
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    shards = [leaf.to_local().contiguous() for leaf in leaves]
    stats = ops.param_stats_leaves(shards)                              # (N, T, 2)
    counts = [shard[0].numel() if all(c == 0 for c, p in zip(coord, leaf.placements)
                                       if not isinstance(p, Shard)) else 0
              for shard, leaf in zip(shards, leaves)]
    n = torch.tensor(counts, dtype=torch.float64, device=stats.device)
    triples = torch.cat([n.expand(stats.shape[0], -1)[..., None], stats.double()], dim=-1)
    parts = all_gather_stack(triples, mesh_group(mesh), "stats_merge")  # (P, N, T, 3)
    return merge_shard_stats(parts[..., 1:], parts[..., 0])


def swarm_distribution_matrix_loop(stacked_params, n_clients: int) -> torch.Tensor:
    """The per-client oracle of :func:`swarm_distribution_matrix`: a loop
    over clients and their leaves, one ``ops.param_stats_batched`` call
    (on the card a one-leaf launch) a (client, leaf). It shares no code
    with the batched matrix, so a fault in the one shows against the
    other."""
    pairs = sorted(tree_paths_and_leaves(stacked_params), key=lambda kv: kv[0])
    rows = []
    for i in range(n_clients):
        feats = []
        for _, leaf in pairs:
            if not leaf.is_floating_point():
                continue
            m, v = ops.param_stats_batched(leaf[i:i + 1].contiguous())
            feats += [m[0], torch.log1p(v[0])]
        rows.append(torch.stack(feats))
    return torch.stack(rows)


def tensor_stats(x: torch.Tensor):
    """(mean, var) of one tensor in fp32, the plain two-pass form (the
    reference's ``jnp.mean`` / ``jnp.var``)."""
    xf = x.float().reshape(-1)
    mean = torch.mean(xf)
    return mean, torch.mean(torch.square(xf - mean))


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
