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


def param_stats_leaves(leaves) -> torch.Tensor:
    """:func:`param_stats_batched` of each of ``leaves`` (T tensors of a
    common client axis N), stacked: (N, T, 2) fp32 with ``[..., 0]`` the
    mean and ``[..., 1]`` the var."""
    return torch.stack([torch.stack(param_stats_batched(x), dim=1) for x in leaves], dim=1)


def kmeans_assign(X: torch.Tensor, C: torch.Tensor, k_active=None) -> torch.Tensor:
    """Nearest-centroid ids: X (N,F), C (K,F) -> (N,) int32, with
    ``d = |x|^2 + |c|^2 - 2 x.c`` in fp32, unclamped; ties go to the
    first index. With ``k_active`` (an int or a () integer tensor) only
    centroids ``< k_active`` are eligible: the others get distance
    ``+inf``, so ``k_active <= 0`` gives id 0 everywhere."""
    X = X.float()
    C = C.float()
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(C * C, dim=1)[None, :]
    d = x2 + c2 - 2.0 * X @ C.T
    if k_active is not None:
        live = torch.arange(C.shape[0], device=d.device) < torch.as_tensor(k_active,
                                                                            device=d.device)
        d = torch.where(live[None, :], d, torch.inf)
    return torch.argmin(d, dim=1).to(torch.int32)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                     window: int = 0) -> torch.Tensor:
    """One-query GQA attention against a KV cache: q (B,H,1,D), k,v
    (B,KV,S,D) of any float dtype (an fp8 cache included; read in fp32)
    with H % KV == 0, query head h reading kv head h // G.
    ``pos`` is a scalar or a (B,) vector: keys 0..pos are valid in each
    row, and ``window > 0`` keeps only ``cols > pos - window``. fp32
    softmax scaled by 1/sqrt(D), masked scores at -1e30, the output in
    q's dtype."""
    B, H, _, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) / math.sqrt(D)
    cols = torch.arange(S, device=q.device)[None, :]
    posb = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)[:, None]
    mask = cols <= posb                                        # (B, S)
    if window > 0:
        mask = mask & (cols > posb - window)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(B, H, 1, D).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Forward GQA attention: q (B,H,Sq,D), k, v (B,KV,Sk,D) with
    H % KV == 0, query head h reading kv head h // G. Query row i sits
    at global position ``q_offset + i``; ``causal`` keeps cols <= that
    position and ``window > 0`` keeps cols > position - window. fp32
    softmax scaled by 1/sqrt(D), masked scores at -1e30, the output in
    q's dtype.

    A query row with no valid key gives 0, as the reference's Pallas
    kernel does (its ``acc / max(l, 1e-30)`` with l = 0); the
    reference's own oracle ``ref_attention`` gives the mean of v there
    (a softmax over all -1e30 scores is uniform). Every other row is
    ``ref_attention``'s."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(D)
    rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = cols <= rows
    if window > 0:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    o = torch.where(mask.any(dim=1)[:, None], o, 0.0)
    return o.reshape(B, H, Sq, D).to(q.dtype)
