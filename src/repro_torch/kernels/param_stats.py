"""param_stats_batched on the card: per-client (mean, var) of a
client-stacked tensor, the paper's §III.B distribution summary.

Wraps ``csrc/param_stats.cu``, the port of the Pallas kernel
``repro/kernels/param_stats.py`` (``param_stats_batched``). The source
note there says what bounds it and how the two passes are laid out.
Its plain version is :func:`repro_torch.kernels.ref.param_stats_batched`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_THREADS = 256
_MIN_PER_CTA = _THREADS * 8           # elements a CTA should have at least
_CTAS_PER_SM = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("param_stats")
    fn = lib.param_stats_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return fn


def n_slices(N: int, n: int, n_sms: int) -> int:
    """CTAs per client in pass 1: enough to give the card
    ``_CTAS_PER_SM`` CTAs an SM, but no CTA with fewer than
    ``_MIN_PER_CTA`` elements."""
    want = max(1, math.ceil(_CTAS_PER_SM * n_sms / max(N, 1)))
    return max(1, min(math.ceil(n / _MIN_PER_CTA), want))


def param_stats_batched(x: torch.Tensor):
    """Per-client fp32 (mean, var) over the trailing axes of ``x``
    (N, ...), fp32 or bf16, contiguous, on a CUDA device. Returns two
    (N,) fp32 tensors; an empty trailing extent gives NaN."""
    if x.device.type != "cuda":
        raise ValueError(f"param_stats_batched kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"param_stats_batched takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("param_stats_batched needs a leading client axis")
    if not x.is_contiguous():
        raise ValueError("param_stats_batched needs a contiguous tensor")
    N = x.shape[0]
    n = math.prod(x.shape[1:])
    if N > 65535:
        raise ValueError(f"param_stats_batched takes at most 65535 clients, got {N}")
    out = torch.empty((2, N), dtype=torch.float32, device=x.device)     # mean, var
    if N == 0:
        return out[0], out[1]
    with torch.cuda.device(x.device):
        S = n_slices(N, n, _build.sm_count(x.device.index))
        # pass-1 partials in one buffer: (N, S) int64 counts, then
        # (N, S) fp32 means, then (N, S) fp32 M2
        scratch = torch.empty((N * S * 16,), dtype=torch.uint8, device=x.device)
        base = scratch.data_ptr()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(x.data_ptr(), _DTYPES[x.dtype], N, n, S, base, base + N * S * 8,
                     base + N * S * 12, out[0].data_ptr(), out[1].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"param_stats_batched launch failed: CUDA error {err}")
    param_stats_batched.launches += 1
    return out[0], out[1]


param_stats_batched.launches = 0
