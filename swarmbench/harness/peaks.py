"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit). Copied from the constants
of ``chip_smoke.py`` (HBM_BYTES_PER_S, FP32_FLOPS, BF16_TENSOR_FLOPS,
FP8_TENSOR_FLOPS), with TF32 added."""
HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "float32": 67e12,        # outside the tensor cores
    "tfloat32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "float8": 1979e12,
}


def bytes_bound_s(n_bytes: float) -> float:
    """The least time in which the card moves ``n_bytes`` through HBM."""
    return n_bytes / HBM_BYTES_PER_S
