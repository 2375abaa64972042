"""kmeans_assign on the card: nearest-centroid ids for the coordinator.

Wraps ``csrc/kmeans_assign.cu``, the port of the Pallas kernel
``repro/kernels/kmeans_assign.py`` (``kmeans_assign``). The source note
there says what bounds it and how it is laid out. Its plain version is
:func:`repro_torch.kernels.ref.kmeans_assign`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ROWS = 128
SMEM_LIMIT = 48 * 1024                # static launch limit, no opt-in


def _lib():
    lib = _build.load("kmeans_assign")
    fn = lib.kmeans_assign_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kmeans_assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """X (N, F) points, C (K, F) centroids, both fp32, contiguous and
    on one CUDA device -> (N,) int32 nearest-centroid ids."""
    if X.device.type != "cuda" or C.device != X.device:
        raise ValueError(f"kmeans_assign kernel needs X and C on one CUDA device, "
                         f"got {X.device} and {C.device}")
    if X.dtype != torch.float32 or C.dtype != torch.float32:
        raise TypeError(f"kmeans_assign takes float32, got {X.dtype} and {C.dtype}")
    if X.dim() != 2 or C.dim() != 2 or X.shape[1] != C.shape[1] or C.shape[0] < 1:
        raise ValueError(f"kmeans_assign wants X (N,F) and C (K>=1,F), got "
                         f"{tuple(X.shape)} and {tuple(C.shape)}")
    if not (X.is_contiguous() and C.is_contiguous()):
        raise ValueError("kmeans_assign needs contiguous X and C")
    N, F = X.shape
    K = C.shape[0]
    smem = (K * F + K) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"kmeans_assign stages C in shared memory: K*F={K * F} "
                         f"needs {smem} B, more than {SMEM_LIMIT} B")
    out = torch.empty((N,), dtype=torch.int32, device=X.device)
    if N == 0:
        return out
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = _lib()(X.data_ptr(), C.data_ptr(), out.data_ptr(), N, F, K, stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign launch failed: CUDA error {err}")
    kmeans_assign.launches += 1
    return out


kmeans_assign.launches = 0
