"""param_stats on the card: per-client (mean, var) of client-stacked
parameter leaves, the paper's §III.B distribution summary, every leaf of
a round in one launch.

Wraps ``csrc/param_stats.cu``, the port of the Pallas kernel
``repro/kernels/param_stats.py`` (``param_stats_batched``). The source
note there says what bounds it, how a CTA finds its leaf in the table
that the launch carries, and how a long row splits and merges in the
same launch. Leaves may be of any of the storage types
(``_build.STORAGE_CODES``: fp32, bf16, fp16, fp8 e4m3 and e5m2), each
converted to fp32 as it is loaded, mixed in one launch, and of any
number of clients. Its plain version is
:func:`repro_torch.kernels.ref.param_stats_leaves`.
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import merge_counter

MAX_LEAVES = 64                       # the kernel's table (kMaxLeaves)
ROW_PER_CTA = 16384                   # elements a CTA reads; a longer row splits
_INT32_MAX = 2**31 - 1
# one record of the kernel's table (struct Leaf in csrc/param_stats.cu):
# data pointer, elements a client, first CTA, slices, first partial,
# first counter, dtype, padding
LEAF_RECORD = struct.Struct("<Qqiiiiii")


def _lib():
    lib = _build.load("param_stats")
    fn = lib.param_stats_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


class Launch(NamedTuple):
    """One launch of the kernel: leaves ``start:stop`` of the call, each
    leaf's first CTA, CTAs a client, first partial and first merge
    counter (-1 for a leaf whose rows do not split), and the launch's
    CTAs, partials and counters in all."""
    start: int
    stop: int
    cta0: tuple
    slices: tuple
    part0: tuple
    ctr0: tuple
    n_ctas: int
    n_parts: int
    n_counters: int


def leaf_record(ptr: int, n: int, cta0: int, slices: int, part0: int, ctr0: int,
                dtype: torch.dtype) -> bytes:
    """One leaf's record of the launch's table: its data pointer, its
    elements a client, its place in the launch (:class:`Launch`) and its
    storage type's code."""
    return LEAF_RECORD.pack(ptr, n, cta0, slices, part0, ctr0,
                            _build.storage_code(dtype, "a param_stats leaf"), 0)


def slices(n: int) -> int:
    """CTAs a client row of ``n`` elements takes: one up to
    ``ROW_PER_CTA`` elements (an empty row too), else one a
    ``ROW_PER_CTA`` slice."""
    return max(1, math.ceil(n / ROW_PER_CTA))


def plan(sizes, N: int) -> list:
    """The launches for leaves of ``sizes[t]`` elements a client and
    ``N`` clients: the leaves in chunks of ``MAX_LEAVES``, one launch a
    chunk. Within a launch every leaf's CTAs follow the one before's,
    client-major; the rows that split get ``slices`` partials each and
    one merge counter each, numbered in leaf order."""
    out = []
    for start in range(0, len(sizes), MAX_LEAVES):
        chunk = sizes[start:start + MAX_LEAVES]
        cta0, sl, part0, ctr0 = [], [], [], []
        n_ctas = n_parts = n_counters = 0
        for n in chunk:
            s = slices(n)
            cta0.append(n_ctas)
            sl.append(s)
            part0.append(n_parts if s > 1 else -1)
            ctr0.append(n_counters if s > 1 else -1)
            n_ctas += N * s
            if s > 1:
                n_parts += N * s
                n_counters += N
        out.append(Launch(start, start + len(chunk), tuple(cta0), tuple(sl), tuple(part0),
                          tuple(ctr0), n_ctas, n_parts, n_counters))
    return out


def _check(leaves) -> torch.device:
    if not leaves:
        raise ValueError("param_stats kernel needs at least one leaf")
    dev = leaves[0].device
    for x in leaves:
        if not x.is_cuda or x.get_device() != dev.index:
            raise ValueError(f"param_stats kernel needs every leaf on one CUDA device, got "
                             f"{sorted({str(x.device) for x in leaves})}")
        _build.storage_code(x.dtype, "a param_stats leaf")
        if x.dim() < 1:
            raise ValueError("param_stats needs a leading client axis on every leaf")
        if not x.is_contiguous():
            raise ValueError(f"param_stats needs contiguous leaves, got strides {x.stride()} "
                             f"for shape {tuple(x.shape)}")
    N = leaves[0].shape[0]
    if any(x.shape[0] != N for x in leaves):
        raise ValueError(f"param_stats needs one client axis, got "
                         f"{sorted({x.shape[0] for x in leaves})}")
    return dev


def param_stats_leaves(leaves) -> torch.Tensor:
    """Per-client fp32 (mean, var) over the trailing axes of each of
    ``leaves``: T client-stacked (N, ...) tensors of any storage types,
    contiguous, on one CUDA device. Returns (N, T, 2) fp32, ``[..., 0]``
    the mean and ``[..., 1]`` the var; an empty trailing extent gives
    NaN. One launch, and one count, for every ``MAX_LEAVES`` leaves."""
    leaves = list(leaves)
    dev = _check(leaves)
    N, T = leaves[0].shape[0], len(leaves)
    out = torch.empty((N, T, 2), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    sizes = [x.numel() // N for x in leaves]
    launches = plan(sizes, N)
    n_parts = max(ln.n_parts for ln in launches)
    n_counters = max(ln.n_counters for ln in launches)
    if max(ln.n_ctas for ln in launches) > _INT32_MAX or n_parts > _INT32_MAX:
        raise ValueError(f"param_stats: {sum(sizes)} elements a client need more CTAs "
                         f"than one launch takes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # split rows only: int32 counts, fp32 means, fp32 M2 of every slice
        part = torch.empty((3 * n_parts,), dtype=torch.int32, device=dev) if n_parts else None
        counter = merge_counter(dev, stream, n_counters) if n_counters else None
        fn = _lib()
        for ln in launches:
            table = b"".join(
                leaf_record(x.data_ptr(), n, *rec, x.dtype)
                for x, n, *rec in zip(leaves[ln.start:ln.stop], sizes[ln.start:ln.stop], ln.cta0,
                                      ln.slices, ln.part0, ln.ctr0))
            err = fn(table, ln.stop - ln.start, ln.n_ctas, ROW_PER_CTA,
                     out.data_ptr() + ln.start * 2 * out.element_size(), 2 * T,
                     None if part is None else part.data_ptr(), n_parts,
                     None if counter is None else counter.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"param_stats launch failed: CUDA error {err}")
            param_stats_leaves.launches += 1
    return out


param_stats_leaves.launches = 0


def param_stats_batched(x: torch.Tensor):
    """The one-leaf entry, on the same kernel: per-client fp32 (mean,
    var) over the trailing axes of ``x`` (N, ...), as two (N,) views."""
    out = param_stats_leaves([x])
    return out[:, 0, 0], out[:, 0, 1]
