"""kmeans_assign on the card: nearest-centroid ids for the coordinator.

Wraps ``csrc/kmeans_assign.cu``, the port of the Pallas kernel
``repro/kernels/kmeans_assign.py`` (``kmeans_assign``). The source note
there says what bounds it and how it is laid out. Its plain version is
:func:`repro_torch.kernels.ref.kmeans_assign`.

X and C may each be any of the storage types (``_build.STORAGE_CODES``),
converted to fp32 as the kernel loads them, and any K >= 1 by F >= 1:
C passes through shared memory in tiles of ``TILE_K`` centroids by
``CHUNK_F`` features (:func:`c_tiles`), staged once a CTA where it is
one tile, else once for each group of rows.

The ``k_active`` operand (a () integer tensor on the card, or None for
all K centroids) makes only centroids ``< k_active`` eligible: the grid
axis's masked static-max k-means. The kernel reads it on the device, so
the caller makes no host sync and a captured graph replays with whatever
the buffer holds. ``launches`` counts every launch and
``k_active_launches`` those that carried the operand.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

TILE_K = 8                            # centroids a tile of C (kBlockK)
CHUNK_F = 1024                        # features a tile of C (kChunkF)


def _lib():
    lib = _build.load("kmeans_assign")
    fn = lib.kmeans_assign_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def c_tiles(K: int, F: int) -> tuple:
    """(centroid blocks, feature chunks a block) that C (K, F) takes
    through shared memory in tiles of ``TILE_K`` centroids by ``CHUNK_F``
    features, walked in order by every group of rows; at (1, 1) the one
    tile is staged once a CTA."""
    return math.ceil(K / TILE_K), math.ceil(F / CHUNK_F)


def kmeans_assign(X: torch.Tensor, C: torch.Tensor, k_active=None) -> torch.Tensor:
    """X (N, F) points and C (K, F) centroids, each of a storage type,
    contiguous, on one CUDA device -> (N,) int32 nearest-centroid ids.
    ``k_active``: None, or a () integer tensor on X's device (clamped to
    [0, K] on the card; taken as int32)."""
    if X.device.type != "cuda" or C.device != X.device:
        raise ValueError(f"kmeans_assign kernel needs X and C on one CUDA device, "
                         f"got {X.device} and {C.device}")
    codes = (_build.storage_code(X.dtype, "kmeans_assign's X"),
             _build.storage_code(C.dtype, "kmeans_assign's C"))
    if X.dim() != 2 or C.dim() != 2 or X.shape[1] != C.shape[1] or C.shape[0] < 1 \
            or X.shape[1] < 1:
        raise ValueError(f"kmeans_assign wants X (N,F>=1) and C (K>=1,F), got "
                         f"{tuple(X.shape)} and {tuple(C.shape)}")
    if not (X.is_contiguous() and C.is_contiguous()):
        raise ValueError("kmeans_assign needs contiguous X and C")
    N, F = X.shape
    K = C.shape[0]
    if k_active is not None:
        if not isinstance(k_active, torch.Tensor) or k_active.dim() != 0 \
                or k_active.dtype.is_floating_point or k_active.dtype.is_complex \
                or k_active.dtype == torch.bool or k_active.device != X.device:
            raise ValueError(f"kmeans_assign's k_active must be a () integer tensor on "
                             f"{X.device}, got {k_active!r}")
        k_active = k_active.to(torch.int32)
    out = torch.empty((N,), dtype=torch.int32, device=X.device)
    if N == 0:
        return out
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = _lib()(X.data_ptr(), C.data_ptr(),
                     None if k_active is None else k_active.data_ptr(),
                     out.data_ptr(), N, F, K, *codes, stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign launch failed: CUDA error {err}")
    kmeans_assign.launches += 1
    kmeans_assign.k_active_launches += k_active is not None
    return out


kmeans_assign.launches = 0
kmeans_assign.k_active_launches = 0
