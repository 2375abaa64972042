"""Tree utilities over nested dicts of tensors (counterpart of
``repro.utils.tree``).

A parameter tree is a nested ``dict`` whose leaves are tensors. Leaves
are visited in sorted key order at every level, the order in which JAX
flattens a dict, so the port's ``"a/b/c"`` paths and leaf order match
the reference's.
"""
from __future__ import annotations

import torch


def tree_paths_and_leaves(tree, prefix: str = ""):
    """List of ("a/b/c", leaf) pairs, dict keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths_and_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_paths_and_leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(total)


def tree_weighted_sum(trees, weights):
    """sum_i w_i * tree_i, the FedAvg primitive (paper Eq. 2)."""
    if len(trees) == 0:
        raise ValueError("tree_weighted_sum needs at least one tree")

    def combine(*leaves):
        acc = leaves[0] * weights[0]
        for i in range(1, len(leaves)):
            acc = acc + leaves[i] * weights[i]
        return acc

    return tree_map(combine, trees[0], *trees[1:])


def tree_stack(trees):
    """Stack identical-structure trees along a new leading client axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), trees[0], *trees[1:])
