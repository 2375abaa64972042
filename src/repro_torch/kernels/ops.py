"""Device dispatch for the port's kernels (counterpart of
``repro.kernels.ops``).

A tensor on the CPU goes to the plain PyTorch version; a CUDA tensor
goes to the hand-written kernel, which launches or raises. There is no
switch and no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kmeans_assign as _assign
from repro_torch.kernels import param_stats as _stats
from repro_torch.kernels import ref


def param_stats_batched(x: torch.Tensor):
    """Per-client fp32 (mean, var) of a client-stacked (N, ...) tensor."""
    if x.device.type == "cpu":
        return ref.param_stats_batched(x)
    return _stats.param_stats_batched(x)


def kmeans_assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(N,) int32 nearest-centroid ids of X (N, F) against C (K, F)."""
    if X.device.type == "cpu":
        return ref.kmeans_assign(X, C)
    return _assign.kmeans_assign(X, C)
