"""flash_attention on the card: forward causal / sliding-window GQA
attention over a whole sequence.

Wraps ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro/kernels/flash_attention.py`` (``flash_attention``). The source
note there says what bounds it and how a CTA walks its K/V tiles. q, k
and v all bf16 or all fp16 at D <= 128 run on the tensor cores
(``mma``); every other case runs on the FMA units (``fma``), each input
converted from its own type as it is staged: fp32, mixed types, a k or
v of an fp8 type, and D from 129 to ``MAX_HEAD_DIM``. :func:`kernel_for`
and :func:`launch_plan` choose the kernel and its grid by the types and
D up front. Still refused: D above ``MAX_HEAD_DIM``, and a q of an fp8
type or of fp64. Its plain version is
:func:`repro_torch.kernels.ref.attention`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MMA_DTYPES = (torch.bfloat16, torch.float16)
_KERNEL_IDS = {"fma": 0, "mma": 1}
LAYOUTS = (32, 64, 128, 256)          # padded dims of a row in shared memory
MAX_HEAD_DIM = LAYOUTS[-1]
MMA_MAX_HEAD_DIM = 128                # the tensor-core kernel's registers
BLOCK_K = 64                          # keys a K/V tile, both kernels


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
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


def padded_dims(D: int) -> int:
    """The dims a row holds in shared memory: the first of ``LAYOUTS`` at
    or above D (pad dims zero). A D outside 1..``MAX_HEAD_DIM`` raises."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim D <= {MAX_HEAD_DIM}, got {D}")
    return next(dp for dp in LAYOUTS if D <= dp)


def kernel_for(q_dtype: torch.dtype, k_dtype: torch.dtype | None = None,
               v_dtype: torch.dtype | None = None, D: int = 64) -> str:
    """The kernel of a call by its types (k's and v's default to q's) and
    head dim: ``"mma"`` (tensor cores) where q, k and v are all bf16 or
    all fp16 and D <= ``MMA_MAX_HEAD_DIM``, ``"fma"`` (fp32 FMA units;
    TF32 would miss fp32's 2e-5) for every other case. A q outside fp32,
    bf16 and fp16, a k or v outside the storage types, or a D above
    ``MAX_HEAD_DIM`` raises."""
    k_dtype = k_dtype or q_dtype
    v_dtype = v_dtype or q_dtype
    if q_dtype not in Q_DTYPES:
        raise TypeError(f"flash_attention takes q of float32, bfloat16 or float16, got {q_dtype}")
    _build.storage_code(k_dtype, "flash_attention's k")
    _build.storage_code(v_dtype, "flash_attention's v")
    padded_dims(D)
    same = q_dtype == k_dtype == v_dtype
    return "mma" if same and q_dtype in MMA_DTYPES and D <= MMA_MAX_HEAD_DIM else "fma"


def rows_per_cta(kernel: str, D: int) -> int:
    """Query rows a CTA: ``mma`` gives each of its 4 warps 32 rows where
    the registers allow (D <= 64) and 16 above; ``fma`` 64."""
    return 128 if kernel == "mma" and D <= 64 else 64


def launch_plan(dtypes, B: int, H: int, Sq: int, D: int):
    """(kernel, rows a CTA, grid) of one call; ``dtypes`` is q's type or
    (q's, k's, v's). ``mma``'s grid is (H, B, n_q) and its CTA ``z``
    takes q tile ``n_q - 1 - z`` (:func:`q_tile_order`), so the heaviest
    causal tiles are dispatched first; ``fma`` keeps (n_q, H, B) with q
    tile ``x``."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    kernel = kernel_for(*dtypes, D=D)
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


def stages_by_vectors(q, k, v) -> bool:
    """Whether the kernels load q, k, v in 16-byte vectors: every base
    and stride, and each row's D elements, are whole 16-byte chunks;
    else they stage with ordinary loads."""
    D = q.shape[3]
    return all(_aligned16(t) and D * t.element_size() % 16 == 0 for t in (q, k, v))


def _launch(q, k, v, out, causal: bool, window: int, q_offset: int) -> None:
    """Checks the operands and launches one kernel writing ``out``
    (B,H,Sq,D), which may be a strided view."""
    tensors = (q, k, v, out)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,H,Sq,D) and k, v (B,KV,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    kernel, _, grid = launch_plan((q.dtype, k.dtype, v.dtype), B, H, Sq, D)
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)} (H % KV == 0)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("flash_attention reads and writes with a unit stride on D")
    vec = int(stages_by_vectors(q, k, v))
    codes = _build.STORAGE_CODES             # each checked by launch_plan
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _KERNEL_IDS[kernel], codes[q.dtype], codes[k.dtype], codes[v.dtype], B, H,
                     KV, Sq, Sk, D, int(causal), window, q_offset,
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                     vec, *grid, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, block_q: int = 128, block_k: int = 128,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,H,Sq,D) fp32, bf16 or fp16, k and v (B,KV,Sk,D) each of any
    storage type, on one CUDA device, D <= ``MAX_HEAD_DIM``, any strides
    with D unit-stride. Returns (B,H,Sq,D) in q's type. ``block_q`` / ``block_k`` only carry the reference's
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
