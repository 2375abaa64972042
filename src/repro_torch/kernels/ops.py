"""Device dispatch for the port's kernels (counterpart of
``repro.kernels.ops``).

A tensor on the CPU goes to the plain PyTorch version; a CUDA tensor
goes to the hand-written kernel, which launches or raises. There is no
switch and no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _attn
from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import kmeans_assign as _assign
from repro_torch.kernels import param_stats as _stats
from repro_torch.kernels import ref


def param_stats_batched(x: torch.Tensor):
    """Per-client fp32 (mean, var) of a client-stacked (N, ...) tensor."""
    if x.device.type == "cpu":
        return ref.param_stats_batched(x)
    return _stats.param_stats_batched(x)


def param_stats_leaves(leaves) -> torch.Tensor:
    """(N, T, 2) fp32 per-client [mean, var] of T client-stacked leaves
    of one client axis: a list on the CPU takes the plain version, any
    other list the kernel (which refuses all but one CUDA device)."""
    leaves = list(leaves)
    if leaves and all(x.device.type == "cpu" for x in leaves):
        return ref.param_stats_leaves(leaves)
    return _stats.param_stats_leaves(leaves)


def kmeans_assign(X: torch.Tensor, C: torch.Tensor, k_active=None) -> torch.Tensor:
    """(N,) int32 nearest-centroid ids of X (N, F) against C (K, F);
    with ``k_active`` (a () integer tensor on X's device) only centroids
    ``< k_active`` are eligible."""
    if X.device.type == "cpu":
        return ref.kmeans_assign(X, C, k_active)
    return _assign.kmeans_assign(X, C, k_active)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 window: int = 0) -> torch.Tensor:
    """One-query GQA attention of q (B,H,1,D) against k, v (B,KV,S,D):
    keys 0..pos valid per row, optional sliding window."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, pos, window)
    return _decode.flash_decode(q, k, v, pos, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0) -> torch.Tensor:
    """Forward GQA attention of q (B,H,Sq,D) against k, v (B,KV,Sk,D),
    causal and / or windowed, query row 0 at position ``q_offset``.
    Raises ValueError where the reference does: unless each sequence
    length is a multiple of ``min(block, S)``."""
    if q.device.type == "cpu":
        _attn.check_blocks(q.shape[2], k.shape[2], block_q, block_k)
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return _attn.flash_attention(q, k, v, causal=causal, window=window, block_q=block_q,
                                 block_k=block_k, q_offset=q_offset)


def flash_attention_bsh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    """:func:`flash_attention` in the model's (B,S,H,D) layout."""
    if q.device.type == "cpu":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
        return out.transpose(1, 2)
    return _attn.flash_attention_bsh(q, k, v, **kw)
