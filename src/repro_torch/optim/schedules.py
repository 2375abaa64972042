"""Learning-rate schedules, pure functions step -> lr (counterpart of
``repro.optim.schedules``)."""
from __future__ import annotations

import numpy as np

_F32 = np.float32


def make_schedule(name: str, base_lr: float, *, warmup: int = 0, total_steps: int = 0,
                  min_ratio: float = 0.1):
    """``"constant"`` (with an optional linear warmup) or ``"cosine"``
    (linear warmup, then a cosine decay to ``min_ratio * base_lr`` at
    ``total_steps``), the reference's formulas. The returned function
    takes an int step and returns a Python float: the value computed in
    fp32, each operation rounded as the reference's ``jnp`` arithmetic
    rounds it, so it passes into a train step's ``lr`` as the reference's
    0-d fp32 array does."""
    lr = _F32(base_lr)
    if name == "constant":
        def sched(step):
            if warmup > 0:
                return float(lr * np.minimum(_F32(1.0), _F32((step + 1) / warmup)))
            return float(lr)
        return sched
    if name == "cosine":
        if total_steps <= 0:
            raise ValueError("cosine schedule needs total_steps")

        def sched(step):
            warm = np.minimum(_F32(1.0), _F32((step + 1) / max(warmup, 1)))
            prog = np.clip(_F32((step - warmup) / max(total_steps - warmup, 1)),
                           _F32(0.0), _F32(1.0))
            cos = _F32(min_ratio) + _F32(1 - min_ratio) * _F32(0.5) * (
                _F32(1.0) + np.cos(_F32(np.pi) * prog))
            return float(lr * warm * cos)
        return sched
    raise ValueError(f"unknown schedule '{name}'")
