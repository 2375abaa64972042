"""Tree utilities over nested dicts and lists of tensors (counterpart
of ``repro.utils.tree``).

A parameter tree is nested ``dict``s and ``list``s whose leaves are
tensors (LM trees hold lists: ``params["blocks"]``, the scanned
layout's ``"prefix"``, the KV cache's per-layer list). Leaves are
visited in sorted key order at every dict and in index order at every
list, the order in which JAX flattens them, so the port's ``"a/0/c"``
paths and leaf order match the reference's.
"""
from __future__ import annotations

import torch


def tree_paths_and_leaves(tree, prefix: str = ""):
    """List of ("a/0/c", leaf) pairs, dict keys sorted at every level and
    list items in order, named by their index."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, sub in items:
        out.extend(tree_paths_and_leaves(sub, f"{prefix}{k}/"))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_paths_and_leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
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


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_unstack(tree, n: int):
    """Inverse of :func:`tree_stack`: ``n`` trees, one a client."""
    return [tree_index(tree, i) for i in range(n)]


def tree_index(tree, i):
    return tree_map(lambda x: x[i], tree)


def tree_cast(tree, dtype):
    """Floating leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_num_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_size_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
