"""GQA attention: training/prefill (causal, optional sliding window) and
single-token decode against a KV cache (counterpart of
``repro.models.attention``).

- Decode reads the cache through :func:`repro_torch.kernels.ops.flash_decode`:
  the plain version for a CPU tensor, the CUDA kernel on the card. That
  is the reference's ``cfg.use_pallas=True`` branch; its jnp branch is
  not ported, and ``use_pallas`` is ignored.
- Cache writes are in place. The reference returns a new cache; the port
  writes into the cache tensors it is given and returns them, so a
  caller that must keep the old cache passes a copy (the serve engine
  prefills into a gathered copy of the admitted slots).
- XLA's ``dynamic_update_slice`` clamps its start index so that the
  update fits; the port clamps the same way where torch indexing would
  raise.
- An fp8 cache (``cfg.cache_dtype`` ``"float8_e4m3fn"`` or
  ``"float8_e5m2"``) stores what the reference's ``astype`` stores
  (:func:`to_cache_dtype`), and is written
  through a ``uint8`` view (:func:`raw_view`): indexed writes and
  copies of float8 tensors are not implemented on every device. Decode
  hands the fp8 cache to the kernel as it is; prefill upcasts it to the
  activation dtype, as the reference does.
- Score products run in the activation dtype and only then go to fp32;
  masks use -1e30; probabilities return to the activation dtype before
  the product with v. Prefill scores in fp32 would be another function.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import apply_rope, dense_init, dtype_of
from repro_torch.sharding import shard_act
from repro_torch.sharding.rules import places, sharding_active


def init_attention(gen: torch.Generator, cfg: ModelConfig, d_model: Optional[int] = None,
                   lead=()):
    d = d_model or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (*lead, d, H * hd), dtype=pd),
        "wk": dense_init(gen, (*lead, d, KV * hd), dtype=pd),
        "wv": dense_init(gen, (*lead, d, KV * hd), dtype=pd),
        "wo": dense_init(gen, (*lead, H * hd, d), dtype=pd),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd), ("bo", d)):
            p[name] = torch.zeros((*lead, n), dtype=pd, device=gen.device)
    return p


def _project_qkv(p, x, x_kv, cfg: ModelConfig):
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x_kv @ p["wk"].to(dt)
    v = x_kv @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    return _heads(q, B, H, hd), _heads(k, B, KV, hd), _heads(v, B, KV, hd)


def _merge_heads(t, B: int, S: int, width: int):
    """(B, S, n, hd) -> (B, S, n*hd), placed under a placement context as
    the heads are: the gradient's reshape back to heads then splits no
    dimension over more ranks than it has heads."""
    out = t.reshape(B, S, width)
    if sharding_active():
        out = shard_act(out, "batch", "seq",
                        "act_heads" if places("act_heads", t.shape[2]) else None)
    return out


def _heads(t, B: int, n: int, hd: int):
    """(B, S, n*hd) -> (B, S, n, hd). Under a placement context the flat
    projection is first placed as its heads will be: a DTensor split over
    more ranks than it has heads cannot be unflattened."""
    if sharding_active():
        t = shard_act(t, "batch", "seq", "act_heads" if places("act_heads", n) else None)
    return t.reshape(B, -1, n, hd)


@functools.lru_cache(maxsize=None)
def _root_in(hd: int, dtype: torch.dtype) -> float:
    """sqrt(hd) rounded to fp32 and then to ``dtype``, the divisor the
    reference uses (``jnp.sqrt(hd).astype(q.dtype)``)."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def _gqa_scores(q, k):
    """q (B,S,H,hd), k (B,T,KV,hd) -> scores (B,KV,G,S,T), G = H/KV, in
    the activation dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / _root_in(hd, q.dtype)


def _repeat_kv(t, G: int):
    """(B,T,KV,hd) -> (B,T,KV*G,hd), kv head j at heads j*G .. j*G+G-1."""
    idx = torch.arange(t.shape[2] * G, device=t.device) // G
    return torch.index_select(t, 2, idx)


def _gqa_out(probs, v, B, S, H, hd):
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H, hd)


# q-chunked attention above this q length: score buffers of O(chunk * S)
# instead of O(S^2)
CHUNK_THRESHOLD = 8192
CHUNK_Q = 1024


def _attention_math(q, k, v, positions, kv_positions, causal, sliding_window, B, S, H, hd):
    KV = k.shape[2]
    if sharding_active() and not places("act_heads", KV) and places("act_heads", H):
        # the (KV, G) view cannot split heads that split while kv heads do
        # not; each query head gets its own copy of its kv head (G = 1)
        k, v = (shard_act(_repeat_kv(t, H // KV), "batch", "seq", "act_heads", None)
                for t in (k, v))
    scores = _gqa_scores(q, k).float()                     # (B,KV,G,S,T)
    if causal or sliding_window > 0:
        qpos = positions[:, None, None, :, None]
        kpos = kv_positions[:, None, None, None, :]
        mask = kpos <= qpos if causal else torch.ones((), dtype=torch.bool, device=q.device)
        if sliding_window > 0:
            mask = mask & (kpos > qpos - sliding_window)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out(probs, v, B, S, H, hd)


def attend_full(p, x, cfg: ModelConfig, *, positions=None, causal=True, x_kv=None,
                kv_positions=None, sliding_window: int = 0):
    """Training / prefill attention. x: (B, S, d)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    self_attn = x_kv is None
    x_kv = x if self_attn else x_kv
    T = x_kv.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if kv_positions is None:
        kv_positions = positions if self_attn else torch.arange(T, device=x.device)[None, :]

    q, k, v = _project_qkv(p, x, x_kv, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, kv_positions, cfg.rope_theta)
    q = shard_act(q, "batch", "seq", "act_heads", None)
    k = shard_act(k, "batch", "seq", "act_heads", None)
    v = shard_act(v, "batch", "seq", "act_heads", None)

    chunk_q = cfg.attn_chunk_q or CHUNK_Q
    if S > CHUNK_THRESHOLD and S % chunk_q == 0:
        pos_b = positions.expand(B, S)
        out = torch.cat([
            _attention_math(q[:, i:i + chunk_q], k, v, pos_b[:, i:i + chunk_q], kv_positions,
                            causal, sliding_window, B, chunk_q, H, hd)
            for i in range(0, S, chunk_q)], dim=1)
    else:
        out = _attention_math(q, k, v, positions, kv_positions, causal, sliding_window,
                              B, S, H, hd)
    out = shard_act(out, "batch", "seq", "act_heads", None)
    out = _merge_heads(out, B, S, H * hd) @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out


# ---------------------------------------------------------------------------
# decode (one new token against a cache)


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """KV-cache storage dtype: ``cfg.cache_dtype`` by torch's name for
    it (e.g. ``float8_e4m3fn``), else the activation dtype."""
    if cfg.cache_dtype:
        return getattr(torch, cfg.cache_dtype)
    return dtype_of(cfg.dtype)


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the cache's ``dtype`` as the reference's ``astype``
    casts it (:func:`repro_torch.kernels.ref.astype`): round to nearest
    even and, for float8_e4m3fn (max 448, no inf), NaN where ``|x|``
    rounds past the max (above 464, the midpoint to the next step), where
    torch's cast saturates to 448; into float8_e5m2 inf from 61,440 on."""
    return ref.astype(x, dtype)


def raw_view(t: torch.Tensor) -> torch.Tensor:
    """A one-byte float tensor seen as ``uint8`` (same shape and
    strides), any other tensor as it is."""
    return t.view(torch.uint8) if t.is_floating_point() and t.element_size() == 1 else t


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, device, lead=()):
    """Zeros of (*lead, batch, max_seq, KV, hd) for k and v. A ring cache
    (``cache_ring`` with a sliding window) keeps only the window."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    if cfg.cache_ring and cfg.sliding_window:
        max_seq = min(max_seq, cfg.sliding_window)
    shape = (*lead, batch, max_seq, KV, hd)
    dt = cache_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _write_cache_rows(cache, new, write_pos):
    """Per-row write in place: cache (B,Smax,KV,hd), new (B,1,KV,hd),
    write_pos (B,) — row b at its own position, clamped into range as
    ``dynamic_update_slice`` clamps it."""
    write_pos = write_pos.clamp(0, cache.shape[1] - 1)
    if sharding_active():
        # an indexed write into a cache split over rows and positions has
        # no placement rule; a select over the positions splits with it
        at = torch.arange(cache.shape[1], device=cache.device)[None, :] == write_pos[:, None]
        cache.copy_(torch.where(at[..., None, None], to_cache_dtype(new, cache.dtype), cache))
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    raw_view(cache)[rows, write_pos] = raw_view(to_cache_dtype(new[:, 0], cache.dtype))
    return cache


def attend_decode(p, x, cache, pos, cfg: ModelConfig, *, sliding_window: int = 0,
                  update_cache: bool = True):
    """One-token decode. x (B,1,d); cache k, v (B,Smax,KV,hd); pos a
    scalar (every row at the same position) or (B,) (one position per
    row, the continuous-batching layout): the new token sits at ``pos``
    and keys 0..pos are valid. Returns (out (B,1,d), cache), the cache
    written in place."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    Smax = cache["k"].shape[1]
    ring = bool(cfg.cache_ring and cfg.sliding_window and cfg.sliding_window >= Smax)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    posb = pos[:, None] if pos.dim() == 1 else pos.expand(B, 1)
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    if update_cache:
        write_pos = (posb[:, 0] % Smax) if ring else posb[:, 0]
        _write_cache_rows(k, k_new, write_pos)
        _write_cache_rows(v, v_new, write_pos)
    k = shard_act(k, "batch", "cache_seq", "act_heads", None)
    v = shard_act(v, "batch", "cache_seq", "act_heads", None)
    # the kernel reads the (B,Smax,KV,hd) cache through strides as
    # (B,KV,Smax,hd); a ring cache's window is structural (window=0)
    o = ops.flash_decode(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pos,
                         window=0 if ring else sliding_window)
    out = o.transpose(1, 2).reshape(B, 1, H * hd) @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out, cache


def attend_prefill(p, x, cache, pos0: int, cfg: ModelConfig, *, sliding_window: int = 0):
    """Chunked-prefill attention: x (B,C,d) holds positions
    ``pos0 .. pos0+C-1`` in lock step across the batch. The chunk's k, v
    are written into the cache at ``pos0`` (in place) and q attends to the
    whole cache under the causal (+ window) mask. Returns (out (B,C,d),
    cache)."""
    B, C, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    Smax = cache["k"].shape[1]
    if C > Smax:
        raise ValueError(f"prefill chunk of {C} positions does not fit a cache of {Smax}")
    q, k_new, v_new = _project_qkv(p, x, x, cfg)
    positions = (pos0 + torch.arange(C, device=x.device))[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    start = min(max(int(pos0), 0), Smax - C)
    raw_view(k)[:, start:start + C] = raw_view(to_cache_dtype(k_new, k.dtype))
    raw_view(v)[:, start:start + C] = raw_view(to_cache_dtype(v_new, v.dtype))
    kv_positions = torch.arange(Smax, device=x.device)[None, :]
    out = _attention_math(q, k.to(x.dtype), v.to(x.dtype), positions, kv_positions, True,
                          sliding_window, B, C, H, hd)
    out = out.reshape(B, C, H * hd) @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out, cache
