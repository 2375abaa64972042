"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

The CPU path of :mod:`repro_torch.kernels.ops` runs these, and the
card's kernels are held against them on the same inputs.
"""
from __future__ import annotations

import math

import torch


def param_stats_batched(x: torch.Tensor):
    """Per-client (mean, var) over the trailing axes of ``x`` (N, ...),
    both fp32 of shape (N,): two passes, the mean and then the mean
    squared deviation from it. An empty trailing extent gives NaN."""
    flat = x.float().reshape(x.shape[0], math.prod(x.shape[1:]))
    mean = flat.mean(dim=1)
    var = torch.square(flat - mean[:, None]).mean(dim=1)
    return mean, var


def kmeans_assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids: X (N,F), C (K,F) -> (N,) int32, with
    ``d = |x|^2 + |c|^2 - 2 x.c`` in fp32, unclamped; ties go to the
    first index."""
    X = X.float()
    C = C.float()
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    d = x2 + c2 - 2.0 * X @ C.T
    return torch.argmin(d, dim=1).to(torch.int32)
