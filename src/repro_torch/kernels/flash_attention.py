"""flash_attention on the card: forward causal / sliding-window GQA
attention over a whole sequence.

Wraps ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro/kernels/flash_attention.py`` (``flash_attention``). The source
note there says what bounds it and how a CTA walks its K/V tiles. bf16
runs on the tensor cores (``mma``), fp32 on the FMA units (``fma``);
:func:`launch_plan` picks the kernel and its grid. Its plain version is
:func:`repro_torch.kernels.ref.attention`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# the kernel each input type runs, and its id in the C launcher
KERNEL_FOR_DTYPE = {torch.float32: "fma", torch.bfloat16: "mma"}
_KERNEL_IDS = {"fma": 0, "mma": 1}
HEAD_DIMS = (32, 64, 128)
BLOCK_K = 64                          # keys a K/V tile, both kernels


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_blocks(Sq: int, Sk: int, block_q: int, block_k: int) -> None:
    """The reference's shape rule: with ``block = min(block, S)``, each
    sequence length must be a multiple of its block. The kernel's own
    tiling does not need it; the rule is kept so that the port refuses
    exactly what the reference refuses."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"seq ({Sq},{Sk}) must divide blocks ({bq},{bk})")


def kernel_for(dtype: torch.dtype) -> str:
    """``"mma"`` (tensor cores) for bf16, ``"fma"`` (fp32 FMA units; TF32
    would miss fp32's 2e-5) for fp32; any other type raises."""
    if dtype not in KERNEL_FOR_DTYPE:
        raise TypeError(f"flash_attention takes q, k, v of one type among float32 and "
                        f"bfloat16, got {dtype}")
    return KERNEL_FOR_DTYPE[dtype]


def rows_per_cta(kernel: str, D: int) -> int:
    """Query rows a CTA: ``mma`` gives each of its 4 warps 32 rows where
    the registers allow (D <= 64) and 16 at D 128; ``fma`` 64."""
    return 128 if kernel == "mma" and D <= 64 else 64


def launch_plan(dtype: torch.dtype, B: int, H: int, Sq: int, D: int):
    """(kernel, rows a CTA, grid) of one call. ``mma``'s grid is (H, B,
    n_q) and its CTA ``z`` takes q tile ``n_q - 1 - z``
    (:func:`q_tile_order`), so the heaviest causal tiles are dispatched
    first; ``fma`` keeps (n_q, H, B) with q tile ``x``."""
    kernel = kernel_for(dtype)
    bq = rows_per_cta(kernel, D)
    n_q = math.ceil(Sq / bq)
    return kernel, bq, ((H, B, n_q) if kernel == "mma" else (n_q, H, B))


def q_tile_order(kernel: str, n_q: int) -> list:
    """The q tiles in the order of their CTAs' linear index within one
    (head, batch row)."""
    return list(range(n_q - 1, -1, -1)) if kernel == "mma" else list(range(n_q))


def tile_walk(q_tile: int, bq: int, Sq: int, Sk: int, causal: bool, window: int,
              q_offset: int, block_k: int = BLOCK_K) -> list:
    """``[(t0, masked), ...]``: the K/V tiles that the CTA of ``q_tile``
    visits, in order, and whether it applies the mask to each, as both
    kernels compute it (``csrc/flash_attention.cu``) for ``bq`` rows a
    CTA. Tiles wholly outside the causal / window band are not visited;
    ``mma`` masks only the tiles that cross the band's edge or Sk."""
    q0 = q_tile * bq
    pos_lo, pos_hi = q_offset + q0, q_offset + min(q0 + bq, Sq) - 1
    col_hi = min(Sk - 1, pos_hi) if causal else Sk - 1
    col_lo = max(0, pos_lo - window + 1) if window > 0 else 0
    return [(t0, t0 + block_k > Sk or (causal and t0 + block_k - 1 > pos_lo)
             or (window > 0 and t0 <= pos_hi - window))
            for t0 in range(col_lo // block_k * block_k, col_hi + 1, block_k)]


def _aligned16(t: torch.Tensor) -> bool:
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in t.stride()[:3])


def _launch(q, k, v, out, causal: bool, window: int, q_offset: int) -> None:
    """Checks the operands and launches one kernel writing ``out``
    (B,H,Sq,D), which may be a strided view."""
    tensors = (q, k, v, out)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in KERNEL_FOR_DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one type among float32 and "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,H,Sq,D) and k, v (B,KV,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)} (H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes D in {HEAD_DIMS}, got {D}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("flash_attention reads and writes with a unit stride on D")
    vec = int(all(_aligned16(t) for t in (q, k, v)))
    kernel, _, grid = launch_plan(q.dtype, B, H, Sq, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _KERNEL_IDS[kernel], B, H, KV, Sq, Sk, D, int(causal), window, q_offset,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                     vec, *grid, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,H,Sq,D), k and v (B,KV,Sk,D), fp32 or bf16 of one type on
    one CUDA device, any strides with D unit-stride. Returns (B,H,Sq,D)
    in q's type. ``block_q`` / ``block_k`` only carry the reference's
    shape rule (:func:`check_blocks`). One count per launch."""
    check_blocks(q.shape[2], k.shape[2], block_q, block_k)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, window, q_offset)
    return out


def flash_attention_bsh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, block_q: int = 128,
                        block_k: int = 128, q_offset: int = 0) -> torch.Tensor:
    """The (B,S,H,D) layout of the model's activations: the kernel reads
    q, k, v and writes the (B,Sq,H,D) output through transposed views,
    so no transposing copy is made."""
    check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), out.transpose(1, 2),
            causal, window, q_offset)
    return out


flash_attention.launches = 0
