"""Shared layer primitives: inits, norms, RoPE, sinusoidal positions,
MLPs, embeddings (counterpart of ``repro.models.layers``).

Models are functional: ``init_*`` builds parameter dicts with the
reference's key names and layouts, the ``apply``-style functions
consume them. Every ``init_*`` takes ``lead``, a shape prefix for the
stacked per-layer leaves of the scanned layout (``(L,)``); fan-ins are
read from the trailing axes, so a stacked init draws each layer as the
unstacked one would.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import shard_act

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(generator: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """LeCun-normal on the fan-in axis, drawn on the generator's device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = scale / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# norms


def init_norm(gen: torch.Generator, cfg: ModelConfig, d: int, lead=()):
    pd = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones((*lead, d), dtype=pd, device=gen.device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=pd, device=gen.device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm (``x / sqrt(mean(x^2) + eps) * scale``) or LayerNorm, in
    fp32 with the scale read in fp32, cast back to ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        rms = torch.sqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + cfg.norm_eps)
        out = xf / rms * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) / torch.sqrt(var + cfg.norm_eps) * p["scale"].float()
        if "bias" in p:
            out = out + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float):
    """x (..., S, H, hd), positions (..., S) int. Split-half rotation
    (``x[..., :half]`` against ``x[..., half:]``, not interleaved pairs),
    in fp32, cast back."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) fp32 table ``[sin(p / 10000^(2i/d)), cos(...)]`` over
    positions p < n and i < d/2, sines in the first half (whisper's)."""
    return sinusoidal_at(torch.arange(n, dtype=torch.float32, device=device)[:, None], d)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """pos (..., 1), any numeric dtype -> (..., d) fp32 rows of
    :func:`sinusoidal_positions`, computed on ``pos``'s device."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead=()):
    pd = dtype_of(cfg.param_dtype)
    d, ff = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, (*lead, d, ff), dtype=pd),
         "wo": dense_init(gen, (*lead, ff, d), dtype=pd)}
    if cfg.act == "swiglu":
        p["wg"] = dense_init(gen, (*lead, d, ff), dtype=pd)
    if cfg.mlp_bias:
        p["bi"] = torch.zeros((*lead, ff), dtype=pd, device=gen.device)
        p["bo"] = torch.zeros((*lead, d), dtype=pd, device=gen.device)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    """swiglu ``(silu(x @ wg) * (x @ wi)) @ wo`` or gelu, weights cast to
    the activation dtype."""
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if "bi" in p:
        h = h + p["bi"].to(dt)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")            # jax.nn.gelu's default
    h = shard_act(h, *(("batch",) + ("seq",) * (h.dim() - 2) + ("act_mlp",)))
    out = h @ p["wo"].to(dt)
    if "bo" in p:
        out = out + p["bo"].to(dt)
    return out


# ---------------------------------------------------------------------------
# embeddings


def init_embedding(gen: torch.Generator, vocab: int, d: int, cfg: ModelConfig):
    return {"table": dense_init(gen, (vocab, d), in_axis=-1, dtype=dtype_of(cfg.param_dtype))}


def apply_embedding(p, tokens, cfg: ModelConfig):
    return p["table"].to(dtype_of(cfg.dtype))[tokens]


def logits_from_embedding(p, x):
    """Tied read-out ``x @ table.T``."""
    return x @ p["table"].to(x.dtype).T
