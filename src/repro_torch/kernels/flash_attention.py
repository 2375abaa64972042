"""flash_attention on the card: forward causal / sliding-window GQA
attention over a whole sequence.

Wraps ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro/kernels/flash_attention.py`` (``flash_attention``). The source
note there says what bounds it and how a CTA walks its K/V tiles. Its
plain version is :func:`repro_torch.kernels.ref.attention`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _DTYPES[q.dtype], B, H, KV, Sq, Sk, D, int(causal), window, q_offset,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                     vec, stream)
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
