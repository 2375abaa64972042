"""Named spans inside the port, opened only while ``torch.profiler`` is on.

``with span(name):`` costs one check of the profiler's state when no
profiler is active, and does nothing else. While one is, the span is a
``torch.profiler.record_function(name)``: it lands in the profiler's
trace, whose kernels are linked to the ops that launched them inside it.
The spans the port opens:

| Span | Where |
| --- | --- |
| ``train.gradient`` | a train step's ``grad_and_value`` call (or its accumulation) |
| ``train.forward`` | the loss inside it (forward only: the backward is the rest) |
| ``train.optimizer`` | a train step's optimizer update, its gradient clip included |
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.profiler import record_function

_OFF = nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler is on, else a null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(name)
