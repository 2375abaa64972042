"""Mixture-of-Experts layer: a top-k router and sort-based capacity
dispatch (counterpart of ``repro.models.moe``).

Tokens are sorted by expert id and scattered into a static
``(experts, capacity, d)`` buffer, so every expert runs dense
``(C, d) x (d, ff)`` products (``torch.bmm``; the reference has no
Pallas kernel here). The port keeps the reference's math and adds what
eager PyTorch on a card needs:

- **No host syncs**, so that a CUDA graph can capture the layer: the
  per-expert counts are a ``scatter_add`` into ``zeros(E)`` (a CUDA
  ``bincount`` reads its max on the host), the scatter into the buffer
  an ``index_add``, the unsort an ``index_copy``.
- **Tie order.** ``jax.lax.top_k`` returns the lower index first among
  equal values; ``torch.topk`` does not promise an order among ties, so
  the router takes the first K of a stable descending sort, which does.
  The dispatch's ``argsort`` is stable, as ``jnp.argsort`` is.
- **The router stays fp32** (``xt.float() @ w`` with an fp32 ``w``);
  the serve engine leaves it out of its cast to the activation dtype.
- **Sliced init.** The expert tensors are drawn a slice of experts at a
  time (:func:`_expert_init`), so an fp32 transient never holds a whole
  ``(E, d, ff)`` tensor: at kimi-k2's width one is 22.5 GB.
- The grouped path (``moe_grouped_dispatch``) runs every group's
  dispatch at once: group g's capacity slots are ``g*C .. g*C+C-1`` of
  each expert, so the expert products stay one ``bmm`` an expert
  weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, dense_init, dtype_of, init_mlp
from repro_torch.sharding import shard_act

EXPERT_INIT_SLICE = 8                  # experts drawn at a time in fp32


def _expert_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """:func:`dense_init` of ``(*lead, E, a, b)`` (fan-in ``a``), drawn
    ``EXPERT_INIT_SLICE`` experts at a time into the ``dtype`` tensor."""
    E = shape[-3]
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    for e in range(0, E, EXPERT_INIT_SLICE):
        n = min(EXPERT_INIT_SLICE, E - e)
        out[..., e:e + n, :, :] = dense_init(gen, (*shape[:-3], n, *shape[-2:]), dtype=dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead=()):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pd = dtype_of(cfg.param_dtype)
    p = {"router": {"w": dense_init(gen, (*lead, d, E), dtype=torch.float32)},
         "experts": {"wi": _expert_init(gen, (*lead, E, d, ff), pd),
                     "wg": _expert_init(gen, (*lead, E, d, ff), pd),
                     "wo": _expert_init(gen, (*lead, E, ff, d), pd)}}
    if cfg.n_shared_experts > 0:
        p["shared_expert"] = init_mlp(gen, cfg, lead)
    return p


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _route(p, xt, cfg: ModelConfig):
    """The fp32 router: (gate (T,K) fp32 renormalised, expert_idx (T,K)
    int64, Switch aux loss ())."""
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.float() @ p["router"]["w"]                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[:, :K], expert_idx[:, :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # aux (Switch): E * sum_e f_e * p_e, f_e the share of (token, k)
    # choices of expert e over T
    me = probs.mean(dim=0)
    counts = torch.zeros(E, dtype=torch.float32, device=xt.device).scatter_add(
        0, expert_idx.reshape(-1), torch.ones(expert_idx.numel(), device=xt.device))
    ce = counts / xt.shape[0]
    return gate, expert_idx, E * torch.sum(me * ce) * cfg.router_aux_weight


def _dispatch_compute_combine(p, xt, gate, expert_idx, C: int, cfg: ModelConfig):
    """Sort-based dispatch, per-expert products, combine, for G groups at
    once: xt (G,T,d), gate and expert_idx (G,T,K); each group has C slots
    an expert. Returns (G,T,d)."""
    E, K = cfg.n_experts, cfg.top_k
    G, T, d = xt.shape
    dt = xt.dtype
    dev = xt.device
    flat_expert = expert_idx.reshape(G, T * K).long()
    sort_idx = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, sort_idx)
    counts = torch.zeros((G, E), dtype=torch.long, device=dev).scatter_add(
        1, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(counts, dim=1) - counts                 # exclusive
    rank = torch.arange(T * K, device=dev) - torch.gather(offsets, 1, sorted_expert)
    keep = rank < C

    token_of = sort_idx // K                                       # source token a slot
    scat_e = torch.where(keep, sorted_expert, 0)
    scat_c = torch.where(keep, rank, 0)
    groups = torch.arange(G, device=dev)[:, None]
    # expert e's rows: group g's slots at g*C .. g*C+C-1
    slot = (scat_e * G + groups) * C + scat_c                      # (G, T*K)
    src = torch.gather(xt, 1, token_of[..., None].expand(G, T * K, d))
    src = torch.where(keep[..., None], src, 0).to(dt)
    buf = torch.zeros((E * G * C, d), dtype=dt, device=dev).index_add(
        0, slot.reshape(-1), src.reshape(-1, d)).view(E, G * C, d)
    buf = shard_act(buf, "act_experts", None, None)

    ex = p["experts"]
    h = torch.bmm(buf, ex["wi"].to(dt))
    g = torch.bmm(buf, ex["wg"].to(dt))
    out_buf = shard_act(torch.bmm(F.silu(g) * h, ex["wo"].to(dt)), "act_experts", None, None)
    out_buf = out_buf.view(E * G * C, d)

    gathered = out_buf.index_select(0, slot.reshape(-1)).view(G, T * K, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    flat_sort = (sort_idx + groups * (T * K)).reshape(-1)
    unsorted = torch.empty((G * T * K, d), dtype=dt, device=dev).index_copy(
        0, flat_sort, gathered.reshape(-1, d))
    per_k = unsorted.view(G, T, K, d)
    return torch.einsum("gtkd,gtk->gtd", per_k, gate.to(dt))


def apply_moe(p, x, cfg: ModelConfig):
    """x (B,S,d) -> ((B,S,d), aux). One global dispatch over all T = B*S
    tokens, or, under ``cfg.moe_grouped_dispatch`` when T splits into
    ``moe_groups`` groups of at least E tokens, a dispatch within each
    group at capacity ``max(8, ceil8(C / G))``."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gate, expert_idx, aux = _route(p, xt, cfg)
    C = expert_capacity(cfg, T)
    G = cfg.moe_groups
    if cfg.moe_grouped_dispatch and T % G == 0 and T >= G * cfg.n_experts:
        Cg = max(8, ((C // G + 7) // 8) * 8)
        xg = shard_act(xt.reshape(G, T // G, d), "batch", None, None)   # groups ride "data"
        y = _dispatch_compute_combine(p, xg, gate.reshape(G, T // G, -1),
                                      expert_idx.reshape(G, T // G, -1), Cg, cfg)
    else:
        y = _dispatch_compute_combine(p, xt[None], gate[None], expert_idx[None], C, cfg)
    y = y.reshape(T, d)
    if "shared_expert" in p:
        y = y + apply_mlp(p["shared_expert"], xt, cfg)
    return y.reshape(B, S, d), aux
