"""flash_decode on the card: one-query GQA attention against a KV cache,
the serve path's decode hot spot.

Wraps ``csrc/flash_decode.cu``, the port of the Pallas kernel
``repro/kernels/flash_decode.py`` (``flash_decode``). The source note
there says what bounds it, how a CTA keeps its tiles in flight and how
the last split of a (row, kv head) merges the partials in the same
launch. Its plain version is :func:`repro_torch.kernels.ref.decode_attention`.

The cache may be q's type or fp8 (``float8_e4m3fn``), which the kernel
converts to fp32 in registers, as the Pallas kernel upcasts any cache
dtype. D = 112 runs on rows padded to 128 dims in shared memory
(:func:`padded_dims`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FP8 = {torch.float8_e4m3fn: 3}       # cache types beside q's own
_KV_DTYPES = {**_DTYPES, **_FP8}
HEAD_DIMS = (32, 64, 112, 128, 256)
MAX_GROUP = 32                        # query rows a CTA holds, one warp each
MAX_GROUP_ELEMS = 2048                # G * D floats of q in shared memory
TILE_ELEMS = 2048                     # keys x D of one shared-memory tile
_CTAS_PER_SM = 4
MAX_SPLITS = 64                       # partials the last CTA of a (row, kv head) merges

# the merge counters, one int32 per (row, kv head), by (device index,
# stream): zeroed once at first use; every launch leaves them at 0
_counters: dict = {}
_retired: list = []                   # outgrown buffers a captured CUDA graph may still use


def _lib():
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def padded_dims(D: int) -> int:
    """The dims a cache row holds in shared memory and in a partial: D,
    or 128 for D = 112 (the kernel's D = 128 layout, pad dims zero)."""
    return 128 if D == 112 else D


def split_plan(B: int, KV: int, S: int, D: int, n_sms: int):
    """(chunk, n_split): the cache's S columns cut into ``n_split``
    ranges of ``chunk`` columns (a multiple of the tile), enough to give
    the card ``_CTAS_PER_SM`` CTAs an SM across the B*KV (row, kv head)
    pairs, never more ranges than tiles nor more than ``MAX_SPLITS``.

    Short ranges keep a CTA's whole range in its ring of copies (at the
    serve shape 4 tiles of 32 keys, all in flight at once) and spread
    the bytes in flight over every SM; the cap bounds the partials the
    last CTA merges."""
    tile = TILE_ELEMS // padded_dims(D)
    n_tiles = math.ceil(S / tile)
    want = max(1, math.ceil(_CTAS_PER_SM * n_sms / (B * KV)))
    chunk_tiles = max(math.ceil(n_tiles / min(want, n_tiles)), math.ceil(n_tiles / MAX_SPLITS))
    chunk = chunk_tiles * tile
    return chunk, math.ceil(S / chunk)


def merge_counter(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The (device, stream)'s merge counters, at least ``n`` of them,
    zeroed with ``torch.zeros`` at first use; the kernel leaves them at 0,
    so replays of a captured graph and later calls find them so. A
    buffer that is outgrown is kept alive, as a graph may hold it."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = _counters[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return buf


def _aligned16(t: torch.Tensor) -> bool:
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in t.stride()[:3])


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 window: int = 0) -> torch.Tensor:
    """q (B,H,1,D) fp32, bf16 or fp16, and k and v (B,KV,S,D) of q's type
    or both float8_e4m3fn, on one CUDA device; k and v may be strided
    views (the serve cache's (B,S,KV,D) seen as (B,KV,S,D)) but D must be
    unit-stride.
    ``pos`` is an int or a () / (B,) integer tensor; ``window >= 0``.
    Returns (B,H,1,D) in q's type. One CUDA launch a call (the split pass
    with its merge fused in), counted in ``flash_decode.launches``; a call
    inside a CUDA graph capture launches nothing and is counted in
    ``flash_decode.captured`` instead, and whoever replays the graph
    counts its launches (:func:`count_replay`)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_decode kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != v.dtype or k.dtype not in (q.dtype, *_FP8):
        raise TypeError(f"flash_decode takes q of float32, bfloat16 or float16 and k, v of "
                        f"one type, q's or float8_e4m3fn; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode wants q (B,H,1,D) and k, v (B,KV,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV or S < 1:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)} (H % KV == 0, S >= 1)")
    G = H // KV
    if D not in HEAD_DIMS or G > MAX_GROUP or G * padded_dims(D) > MAX_GROUP_ELEMS:
        raise ValueError(f"flash_decode takes D in {HEAD_DIMS}, H/KV <= {MAX_GROUP} and "
                         f"H/KV*D <= {MAX_GROUP_ELEMS} (D = 112 counts as 128); got D={D}, "
                         f"H/KV={G}")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_decode reads k and v with a unit stride on D")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.stride(3) != 1:
        q = q.contiguous()
    if isinstance(pos, torch.Tensor):
        if pos.numel() not in (1, B):
            raise ValueError(f"pos must be a scalar or (B,)={B} positions, got {tuple(pos.shape)}")
        pos_t = pos.to(device=q.device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    else:
        pos_t = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    out = torch.empty((B, H, 1, D), dtype=q.dtype, device=q.device)
    chunk, n_split = split_plan(B, KV, S, D, _build.sm_count(q.device.index))
    part = torch.empty((B * H * n_split * (padded_dims(D) + 2),), dtype=torch.float32,
                       device=q.device)
    vec = int(_aligned16(k) and _aligned16(v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counter = merge_counter(q.device, stream, B * KV)
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
                     out.data_ptr(), part.data_ptr(), counter.data_ptr(), _DTYPES[q.dtype],
                     _KV_DTYPES[k.dtype], B, H, KV, S, D,
                     window, chunk, n_split, q.stride(0), q.stride(1), k.stride(0),
                     k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2), vec,
                     stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        flash_decode.captured += 1
    else:
        flash_decode.launches += 1
    return out


flash_decode.launches = 0
flash_decode.captured = 0


def count_replay(n_captured: int) -> None:
    """One replay of a CUDA graph that captured ``n_captured`` calls of
    :func:`flash_decode`: that many launches."""
    flash_decode.launches += n_captured
