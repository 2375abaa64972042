"""Products (matmuls, convolutions) in a precision below float32, for the
control: the reference computed one step lower than the configuration
states.

- ``"float32"``: the plain product (the caller keeps TF32 off).
- ``"tfloat32"``: both operands rounded to TF32 (10 mantissa bits, to
  nearest even) and the incoming gradient too, products accumulated in
  float32: what a TF32 tensor core computes.
- ``"float8"``: both operands scaled per tensor to e4m3's largest value
  (448) and cast to e4m3, the incoming gradient to e5m2 (57,344) the
  same way, products accumulated in float32.

The operands' rounding passes the gradient through unchanged (a
straight-through estimator), so the backward products see the rounded
operands and the rounded gradient."""
from __future__ import annotations

import torch

_FP8 = {"forward": (torch.float8_e4m3fn, 448.0), "backward": (torch.float8_e5m2, 57344.0)}


def round_to(x: torch.Tensor, precision: str, backward: bool = False) -> torch.Tensor:
    if precision == "float32":
        return x
    if precision == "tfloat32":
        i = x.float().contiguous().view(torch.int32)
        i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)
    if precision == "float8":
        dtype, top = _FP8["backward" if backward else "forward"]
        amax = torch.clamp(x.detach().abs().amax().float(), min=1e-30)
        scale = top / amax
        return (x.float() * scale).to(dtype).float() / scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.precision, backward=True), None


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return x
    return x + (round_to(x, precision) - x).detach()


def product(fn, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``fn(a, b)`` (a matmul or convolution) in ``precision``."""
    if precision == "float32":
        return fn(a, b)
    return _RoundGrad.apply(fn(operand(a, precision), operand(b, precision)), precision)
