"""Shared layer primitives (counterpart of ``repro.models.layers``).

Only ``dense_init`` is ported: the CNN family needs nothing else.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """LeCun-normal on the fan-in axis, drawn on the generator's device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = scale / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)
