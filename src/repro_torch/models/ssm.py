"""Mamba2 / SSD block (state-space duality, arXiv:2405.21060), the
counterpart of ``repro.models.ssm``.

Training uses the chunked SSD algorithm: attention-like products inside
chunks of ``cfg.ssm_chunk`` positions and a linear recurrence over the
chunk states. Decode is the O(1) recurrent update on a cache of the
last ``ssm_conv_width - 1`` conv frames and the (B, H, P, N) state.

Dtypes follow the reference: ``in_proj`` and the conv run in the
activation dtype; ``dt``, ``A``, the chunk tensors, the state and the
gated norm in fp32; the cast back comes before ``out_proj``. The
reference has no Pallas kernel here: this is plain PyTorch.

- The intra-chunk decay masks *before* the exp: for t < s the exponent
  is positive, and a mask after the exp would give the backward pass
  0 * inf = NaN.
- ``softplus`` is ``logaddexp(x, 0)``, exact as ``jax.nn.softplus`` is
  (``torch.nn.functional.softplus`` is the identity past 20).
- Decode writes the cache in place, as the port's attention decode does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of
from repro_torch.sharding import shard_act

# group count of the B/C projections (1 in the small mamba2 models)
G = 1


def _dims(cfg: ModelConfig):
    d_inner = cfg.d_inner
    H = cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return d_inner, H, P, N, conv_dim, d_in_proj


def init_ssm(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    d_inner, H, P, N, conv_dim, d_in_proj = _dims(cfg)
    pd = dtype_of(cfg.param_dtype)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (d, d_in_proj), dtype=pd),
        "conv_w": dense_init(gen, (cfg.ssm_conv_width, conv_dim), in_axis=0, dtype=pd),
        "conv_b": torch.zeros((conv_dim,), dtype=pd, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(pd),
        "dt_bias": torch.zeros((H,), dtype=pd, device=dev),
        "D": torch.ones((H,), dtype=pd, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=pd, device=dev),
        "out_proj": dense_init(gen, (d_inner, d), dtype=pd),
    }


def _split_proj(proj, cfg: ModelConfig):
    d_inner, _, _, _, conv_dim, _ = _dims(cfg)
    return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_dim],
            proj[..., d_inner + conv_dim:])


def _gated_norm(p, y, z, cfg: ModelConfig):
    y = y * F.silu(z.float())
    rms = torch.sqrt(torch.mean(torch.square(y), dim=-1, keepdim=True) + cfg.norm_eps)
    return y / rms * p["norm_scale"].float()


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _dt_and_A(p, dt_raw):
    """(dt = softplus(dt_raw + dt_bias), A = -exp(A_log)), in fp32."""
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def apply_ssm(p, x, cfg: ModelConfig, initial_state=None, initial_conv=None,
              return_carry: bool = False):
    """Chunked SSD forward. x: (B, S, d) with S % min(ssm_chunk, S) == 0.

    Returns (y (B,S,d), final_state (B,H,P,N)); with ``return_carry`` the
    second element is (final_state, conv_frames (B,w-1,conv_dim)), which
    with ``initial_state`` / ``initial_conv`` makes a prefill in pieces
    equal to the whole sequence's."""
    Bsz, S, _ = x.shape
    d_inner, H, P, N, conv_dim, _ = _dims(cfg)
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by ssm_chunk {L}")
    nc = S // L
    dt_ = x.dtype
    f32 = torch.float32

    proj = x @ p["in_proj"].to(dt_)                           # (B,S,d_in_proj)
    z, xBC, dt_raw = _split_proj(proj, cfg)

    # causal depthwise conv over the (x, B, C) channels; the boundary
    # frames come from the previous piece's carry when prefilling in pieces
    w = cfg.ssm_conv_width
    if initial_conv is None:
        initial_conv = torch.zeros((Bsz, w - 1, conv_dim), dtype=dt_, device=x.device)
    pad = torch.cat([initial_conv.to(dt_), xBC], dim=1)
    final_conv = pad[:, -(w - 1):, :] if w > 1 else initial_conv
    conv = sum(pad[:, i:i + S, :] * p["conv_w"][i].to(dt_) for i in range(w))
    xBC = F.silu(conv + p["conv_b"].to(dt_))

    xs = xBC[..., :d_inner].reshape(Bsz, S, H, P)
    Bm = xBC[..., d_inner:d_inner + G * N]
    Cm = xBC[..., d_inner + G * N:]

    dt, A = _dt_and_A(p, dt_raw)                              # (B,S,H), (H,)
    dA = dt * A                                               # log-decay

    # chunk views
    xs_c = xs.reshape(Bsz, nc, L, H, P).to(f32)
    B_c = Bm.reshape(Bsz, nc, L, G, N).to(f32)
    C_c = Cm.reshape(Bsz, nc, L, G, N).to(f32)
    dt_c = dt.reshape(Bsz, nc, L, H)
    cum = torch.cumsum(dA.reshape(Bsz, nc, L, H), dim=2)      # (B,nc,L,H)

    # intra-chunk: decay[t, s] = exp(cum[t] - cum[s]) for t >= s, masked
    # before the exp
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], rel, -1e30))
    cb = torch.einsum("bclgn,bcsgn->bcls", C_c, B_c)          # (B,nc,L,L)
    scores = cb[..., None] * decay * dt_c[:, :, None, :, :]   # (B,nc,L,L,H)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, xs_c)

    # chunk states, decayed to the chunk's end
    seg = torch.exp(cum[:, :, -1:, :] - cum)
    weighted = xs_c * (seg * dt_c)[..., None]                 # (B,nc,L,H,P)
    states = torch.einsum("bclgn,bclhp->bchpn", B_c, weighted)  # (B,nc,H,P,N)

    # the recurrence over chunks keeps the state *before* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # inter-chunk contribution, decayed from the chunk's start
    y_inter = torch.einsum("bclgn,bchpn->bclhp", C_c, prev_states) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + xs.to(f32) * p["D"].to(f32)[None, None, :, None]
    y = shard_act(_gated_norm(p, y.reshape(Bsz, S, d_inner), z, cfg), "batch", "seq", "act_heads")
    out = y.to(dt_) @ p["out_proj"].to(dt_)
    if return_carry:
        return out, (state, final_conv)
    return out, state


# ---------------------------------------------------------------------------
# decode


def init_ssm_cache(cfg: ModelConfig, batch: int, device):
    """The conv frames in the activation dtype, the state in fp32."""
    _, H, P, N, conv_dim, _ = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype_of(cfg.dtype), device=device),
            "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device)}


def apply_ssm_decode(p, x, cache, cfg: ModelConfig):
    """One-token recurrent step. x: (B, 1, d). Returns (out (B,1,d),
    cache), the cache written in place."""
    Bsz = x.shape[0]
    d_inner, H, P, N, _, _ = _dims(cfg)
    dt_ = x.dtype

    proj = x[:, 0, :] @ p["in_proj"].to(dt_)                 # (B, d_in_proj)
    z, xBC, dt_raw = _split_proj(proj, cfg)

    # the conv ring: shift in the new frame
    frames = torch.cat([cache["conv"].to(dt_), xBC[:, None, :]], dim=1)  # (B,w,conv)
    conv = torch.einsum("bwc,wc->bc", frames, p["conv_w"].to(dt_))
    xBC = F.silu(conv + p["conv_b"].to(dt_))

    xh = xBC[:, :d_inner].reshape(Bsz, H, P).float()
    Bm = xBC[:, d_inner:d_inner + G * N].reshape(Bsz, G, N).float()
    Cm = xBC[:, d_inner + G * N:].reshape(Bsz, G, N).float()

    dt, A = _dt_and_A(p, dt_raw)
    dec = torch.exp(dt * A)                                   # (B,H)
    outer = torch.einsum("bgn,bhp->bhpn", Bm, xh * dt[..., None])
    state = dec[:, :, None, None] * cache["state"] + outer
    y = torch.einsum("bgn,bhpn->bhp", Cm, state)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(p, y.reshape(Bsz, d_inner), z, cfg)
    out = y.to(dt_) @ p["out_proj"].to(dt_)
    cache["conv"].copy_(frames[:, 1:, :])
    cache["state"].copy_(state)
    return out[:, None, :], cache
