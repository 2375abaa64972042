"""Device dispatch for the port's kernels (counterpart of
``repro.kernels.ops``).

A tensor on the CPU goes to the plain PyTorch version; a CUDA tensor
goes to the hand-written kernel, which launches or raises. There is no
switch and no fallback from the kernel to the plain version.

The two attention kernels are also dispatcher ops,
``torch.ops.repro_torch.flash_decode`` and ``.flash_attention``, which
every tensor but a CPU one goes through: a CUDA tensor launches the
kernel, a ``meta`` tensor (the dry-run's) gets its output's shape, and
a DTensor is placed by :func:`register_sharding_rules`. Each op has a
``torch.utils.flop_counter`` formula (:func:`decode_flops`,
:func:`attention_flops`), so a FLOP count of a step on the card and on
``meta`` see the same op with the same count.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

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


def param_stats(x: torch.Tensor):
    """fp32 (mean, var) of one tensor, each of shape (): the N = 1 case
    of :func:`param_stats_batched` (one launch of the kernel on the card)."""
    m, v = param_stats_batched(x.reshape((1,) + tuple(x.shape)))
    return m[0], v[0]


def param_stats_leaves(leaves) -> torch.Tensor:
    """(N, T, 2) fp32 per-client [mean, var] of T client-stacked leaves
    of one client axis: a list on the CPU takes the plain version, a list
    on ``meta`` (the dry-run's) gets its output's shape from it, any
    other list the kernel (which refuses all but one CUDA device)."""
    leaves = list(leaves)
    if leaves and (all(x.device.type == "cpu" for x in leaves)
                   or all(x.device.type == "meta" for x in leaves)):
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
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.int32, device=q.device)
    return torch.ops.repro_torch.flash_decode(q, k, v, pos, int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0) -> torch.Tensor:
    """Forward GQA attention of q (B,H,Sq,D) against k, v (B,KV,Sk,D),
    causal and / or windowed, query row 0 at position ``q_offset``.
    Raises ValueError where the reference does: unless each sequence
    length is a multiple of ``min(block, S)``."""
    _attn.check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), int(window),
                                                 int(q_offset))


def flash_attention_bsh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    """:func:`flash_attention` in the model's (B,S,H,D) layout."""
    if q.device.type == "cpu":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
        return out.transpose(1, 2)
    return _attn.flash_attention_bsh(q, k, v, **kw)


# ---------------------------------------------------------------------------
# the attention kernels as dispatcher ops


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def _flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                     window: int) -> torch.Tensor:
    if q.device.type == "cuda":
        return _decode.flash_decode(q, k, v, pos, window)
    return ref.decode_attention(q, k, v, pos, window)


@_flash_decode_op.register_fake
def _(q, k, v, pos, window):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: int, q_offset: int) -> torch.Tensor:
    if q.device.type == "cuda":
        # check_blocks ran in flash_attention; the op's blocks only carry that rule
        Sq, Sk = q.shape[2], k.shape[2]
        return _attn.flash_attention(q, k, v, causal=causal, window=window, block_q=Sq,
                                     block_k=Sk, q_offset=q_offset)
    return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, q_offset):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def decode_flops(q_shape, k_shape, v_shape, pos_shape, window, *args, out_shape=None,
                 **kwargs) -> int:
    """2·D for q·k and 2·D for p·v, a query head and a key it reads:
    the keys a query at the cache's last position reads, all S of them or
    the window's ``min(S, window)`` (on ``meta`` the positions are not
    known; the dry-run decodes at position S - 1)."""
    B, H, _, D = q_shape
    S = k_shape[2]
    keys = min(S, window) if window > 0 else S
    return 4 * B * H * D * keys


def valid_pairs(Sq: int, Sk: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the causal / window mask keeps: query row i at
    position ``q_offset + i`` reads keys ``j <= q_offset + i`` (causal)
    and ``j > q_offset + i - window`` (window > 0)."""
    total = 0
    for i in range(Sq):
        p = q_offset + i
        hi = min(Sk - 1, p) if causal else Sk - 1
        lo = max(0, p - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def attention_flops(q_shape, k_shape, v_shape, causal, window, q_offset, *args,
                    out_shape=None, **kwargs) -> int:
    """4·D a query head and a key it reads (q·k and p·v), over the pairs
    the mask keeps (:func:`valid_pairs`): the tiles the kernel skips are
    not counted."""
    B, H, Sq, D = q_shape
    return 4 * B * H * D * valid_pairs(Sq, k_shape[2], causal, window, q_offset)


@functools.cache
def register_sharding_rules() -> None:
    """DTensor placements of the two attention ops (once a process):
    replicated, split by batch row, or split by head where the kv heads
    split with the query heads. A cache split over its positions has no
    rule (a split softmax needs a merge): DTensor gathers it first."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def rules(q, k, v, *rest, pos_batched=False):
        extra = [None] * len(rest)
        pos = [Shard(0) if pos_batched else Replicate()] if pos_batched is not None else []
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()]
                + ([Replicate()] if pos else []) + extra)]
        out.append(([Shard(0)], [Shard(0), Shard(0), Shard(0)] + pos + extra))
        if q.shape[1] == k.shape[1]:
            # one kv head a query head: a head split maps q's heads to k's
            # (with G > 1 an uneven split of the kv heads would not)
            out.append(([Shard(1)], [Shard(1), Shard(1), Shard(1)]
                        + ([Replicate()] if pos else []) + extra))
        return out

    @register_sharding(torch.ops.repro_torch.flash_decode.default)
    def _decode_rule(q, k, v, pos, window):
        return rules(q, k, v, window, pos_batched=len(pos.shape) == 1)

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _attention_rule(q, k, v, causal, window, q_offset):
        return rules(q, k, v, causal, window, q_offset, pos_batched=None)
