"""Plain float32 decoder-only LM of the dense family (granite-3-2b's
equations as the program states them): token embedding; per layer
RMSNorm, grouped-query attention with split-half RoPE (theta from the
configuration) and a causal mask, the output projection, a residual,
RMSNorm, a SwiGLU MLP ``(silu(x Wg) * (x Wi)) Wo`` and a residual; a
final RMSNorm and the read-out through the tied embedding. No biases.
Query head ``j`` reads key/value head ``j // (H / KV)``.

Leaves (the layers stacked on a leading axis): ``embedding/table`` (V,
d), ``final_norm/scale`` (d,), and under ``layers/period0/``:
``attn_norm/scale``, ``attn/wq`` (L, d, H*hd), ``attn/wk``, ``attn/wv``
(L, d, KV*hd), ``attn/wo`` (L, H*hd, d), ``mlp_norm/scale``, ``mlp/wg``,
``mlp/wi`` (L, d, ff), ``mlp/wo`` (L, ff, d).

Granite's published multipliers (embedding, residual, attention and
logits scaling) are not applied: the program's dense family has none,
and the benchmark's configuration file notes the departure."""
from __future__ import annotations

import math

import torch

from swarmbench.reference.precision import product

INPUT = "tokens"
PRE = "layers/period0/"


def rms_norm(x, scale, eps: float):
    return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (B, S, n, hd), positions 0..S-1: split-half rotation."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mm(a, b, precision):
    return product(torch.matmul, a, b, precision)


def forward(p: dict, tokens: torch.Tensor, cfg: dict, precision: str = "float32"):
    """(B, S, V) logits of (B, S) token ids."""
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = cfg["head_dim"], cfg["rms_norm_eps"], cfg["rope_theta"]
    B, S = tokens.shape
    table = p["embedding/table"]
    x = table[tokens.long()]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    for i in range(p[PRE + "attn/wq"].shape[0]):
        def w(name):
            return p[PRE + name][i]
        h = rms_norm(x, w("attn_norm/scale"), eps)
        q = rope(mm(h, w("attn/wq"), precision).reshape(B, S, H, hd), theta)
        k = rope(mm(h, w("attn/wk"), precision).reshape(B, S, KV, hd), theta)
        v = mm(h, w("attn/wv"), precision).reshape(B, S, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        scores = product(lambda a, b: torch.einsum("bshd,bthd->bhst", a, b), q, k,
                         precision) / math.sqrt(hd)
        probs = torch.softmax(torch.where(causal, scores, float("-inf")), dim=-1)
        o = product(lambda a, b: torch.einsum("bhst,bthd->bshd", a, b), probs, v, precision)
        x = x + mm(o.reshape(B, S, H * hd), w("attn/wo"), precision)
        h = rms_norm(x, w("mlp_norm/scale"), eps)
        g = torch.nn.functional.silu(mm(h, w("mlp/wg"), precision))
        x = x + mm(g * mm(h, w("mlp/wi"), precision), w("mlp/wo"), precision)
    x = rms_norm(x, p["final_norm/scale"], eps)
    return mm(x, table.T, precision)
