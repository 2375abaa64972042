"""flash_decode on the card: one-query GQA attention against a KV cache,
the serve path's decode hot spot.

Wraps ``csrc/flash_decode.cu``, the port of the Pallas kernel
``repro/kernels/flash_decode.py`` (``flash_decode``). The source note
there says what bounds it, how a CTA keeps its tiles in flight and how
the last split of a (row, query chunk) merges the partials in the same
launch. Its plain version is :func:`repro_torch.kernels.ref.decode_attention`.

q, k and v may each be any of the storage types
(``_build.STORAGE_CODES``, fp8 e4m3 and e5m2 included), which the
kernel converts to fp32, as the Pallas kernel upcasts any dtype; the
output is in q's type, an fp8 one rounded as the reference's ``astype``
(:func:`repro_torch.kernels.ref.astype`). Any D up to ``MAX_LAYOUT``
runs on rows padded to the next of ``LAYOUTS`` in shared memory
(:func:`padded_dims`); a larger D runs the wide kernel, whose CTAs each
own one ``WIDE_SLICE``-dim slice of the output and compute the scores
over all of D. Any G = H / KV runs in chunks of at most ``MAX_GROUP``
query rows a CTA (:func:`query_chunks`). fp64 is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAYOUTS = (32, 64, 128, 256)          # dims a row holds in shared memory
MAX_LAYOUT = LAYOUTS[-1]
WIDE_SLICE = 256                      # output dims a CTA of the wide kernel owns (kWideSlice)
WIDE_TILE = 32                        # keys a tile of the wide kernel (kWideTile)
MAX_GROUP = 8                         # query rows a CTA holds, one warp each (kMaxGroup)
TILE_ELEMS = 2048                     # keys x padded dims of one shared-memory tile
_CTAS_PER_SM = 4
MAX_SPLITS = 64                       # partials the last CTA of a (row, query chunk) merges

# the merge counters, one int32 per (row, kv head, query chunk), by
# (device index, stream): zeroed once at first use; every launch leaves
# them at 0
_counters: dict = {}
_retired: list = []                   # outgrown buffers a captured CUDA graph may still use


def _lib():
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def type_codes(q_dtype: torch.dtype, k_dtype: torch.dtype, v_dtype: torch.dtype) -> tuple:
    """The launcher's codes of q's, k's and v's types, each of any
    storage type; any other (fp64) raises TypeError."""
    return tuple(_build.storage_code(dt, f"flash_decode's {n}")
                 for n, dt in (("q", q_dtype), ("k", k_dtype), ("v", v_dtype)))


def padded_dims(D: int) -> int:
    """The dims a partial holds: up to ``MAX_LAYOUT``, the first of
    ``LAYOUTS`` at or above D, which a cache row also holds in shared
    memory (kimi-k2's 112 on 128; pad dims zero); above it, D rounded up
    to whole ``WIDE_SLICE`` slices (:func:`slices`). A D below 1 raises."""
    if D < 1:
        raise ValueError(f"flash_decode takes a head dim D >= 1, got {D}")
    if D > MAX_LAYOUT:
        return slices(D) * WIDE_SLICE
    return next(dp for dp in LAYOUTS if D <= dp)


def slices(D: int) -> int:
    """Output slices a (row, kv head, query chunk) is cut into: 1 up to
    ``MAX_LAYOUT``, else ``ceil(D / WIDE_SLICE)``, one wide-kernel CTA
    each a split."""
    return 1 if D <= MAX_LAYOUT else math.ceil(D / WIDE_SLICE)


def query_chunks(G: int) -> tuple:
    """(rows a CTA, chunks): a kv head's G query rows in the fewest chunks
    of at most ``MAX_GROUP`` rows, all of one size (the last may hold rows
    past G, which compute on q = 0 and write nothing)."""
    n_chunk = math.ceil(G / MAX_GROUP)
    return math.ceil(G / n_chunk), n_chunk


def split_plan(B: int, KV: int, S: int, D: int, n_sms: int, G: int = 1):
    """(chunk, n_split): the cache's S columns cut into ``n_split``
    ranges of ``chunk`` columns (a multiple of the tile: 2,048 / padded
    dims keys, ``WIDE_TILE`` above ``MAX_LAYOUT``), enough to give the
    card ``_CTAS_PER_SM`` CTAs an SM across the B*KV*chunks*slices (row,
    kv head, query chunk, output slice) CTAs of a split
    (:func:`query_chunks` of G, :func:`slices` of D), never more ranges
    than tiles nor more than ``MAX_SPLITS``.

    Short ranges keep a CTA's whole range in its ring of copies (at the
    serve shape 4 tiles of 32 keys, all in flight at once) and spread
    the bytes in flight over every SM; the cap bounds the partials the
    last CTA merges."""
    tile = TILE_ELEMS // padded_dims(D) if D <= MAX_LAYOUT else WIDE_TILE
    n_tiles = math.ceil(S / tile)
    want = max(1, math.ceil(_CTAS_PER_SM * n_sms / (B * KV * query_chunks(G)[1] * slices(D))))
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


def stages_by_cp_async(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel stages k and v by 16-byte ``cp.async``: every
    base and stride, and each row's D elements, are whole 16-byte
    chunks; else it stages with ordinary loads."""
    D = k.shape[3]
    return all(_aligned16(t) and D * t.element_size() % 16 == 0 for t in (k, v))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
                 window: int = 0) -> torch.Tensor:
    """q (B,H,1,D), k and v (B,KV,S,D), each of any storage type, on one
    CUDA device, any D >= 1; k and v may be strided views (the serve
    cache's (B,S,KV,D) seen as (B,KV,S,D)) but D must be unit-stride.
    ``pos`` is an int or a () / (B,) integer tensor; ``window >= 0``.
    Returns (B,H,1,D) in q's type. One CUDA launch a call (the split pass
    with its merge fused in), counted in ``flash_decode.launches``; a call
    inside a CUDA graph capture launches nothing and is counted in
    ``flash_decode.captured`` instead, and whoever replays the graph
    counts its launches (:func:`count_replay`)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_decode kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    codes = type_codes(q.dtype, k.dtype, v.dtype)
    if q.dim() != 4 or q.shape[2] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode wants q (B,H,1,D) and k, v (B,KV,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV or S < 1:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)} (H % KV == 0, S >= 1)")
    DP = padded_dims(D)
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
    G = H // KV
    GC, n_chunk = query_chunks(G)
    n_slice = slices(D)
    chunk, n_split = split_plan(B, KV, S, D, _build.sm_count(q.device.index), G)
    part = torch.empty((B * H * n_slice * n_split * (DP // n_slice + 2),), dtype=torch.float32,
                       device=q.device)
    vec = int(stages_by_cp_async(k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counter = merge_counter(q.device, stream, B * KV * n_chunk * n_slice)
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
                     out.data_ptr(), part.data_ptr(), counter.data_ptr(), *codes,
                     B, H, KV, GC, n_chunk, S, D,
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
