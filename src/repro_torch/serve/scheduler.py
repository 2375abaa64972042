"""Request queue + slot scheduler for the continuous-batching engine
(a copy of the numpy-only ``repro.serve.scheduler``: the port imports
nothing of the reference package).

The serving layout mirrors the training engine's static-shape
discipline (``run_grid`` / ``BucketedSwarmData``): the cache pool is a
fixed set of **size buckets**, each a ``BucketSpec(batch, seq)`` — a
block of ``batch`` cache slots whose sequence ceiling is ``seq``. A
request (arbitrary prompt length + generation budget) is routed to the
*smallest* bucket whose ceiling fits ``prompt_len + max_new_tokens``
and admitted when one of that bucket's slots is free; otherwise it
waits in the FIFO queue. Every shape the engine runs is keyed only on
``(batch, seq)``, so a bucket's prefill and decode always see the same
shapes whatever the requests.

Admission is FIFO *per bucket*: a request that cannot be admitted does
not block requests bound for other buckets (no head-of-line blocking
across size classes), but never spills to a larger bucket — routing is
deterministic in the request alone.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# ------------------------------------------------------------------ requests


@dataclass
class Request:
    """One generation (or classification) request.

    LM requests carry ``prompt`` (1-D int32 tokens) and
    ``max_new_tokens``; CNN scoring requests carry ``image`` instead
    (see ``repro_torch.serve.engine.ImageClassifier``). Timestamps are
    stamped by the engine: ``t_submit`` at queue entry, ``t_admit``
    when a slot is taken, ``t_first`` at the first generated token
    (prefill exit), ``t_done`` at completion.
    """
    rid: int
    prompt: Optional[np.ndarray] = None
    max_new_tokens: int = 0
    image: Optional[np.ndarray] = None
    eos_id: int = -1                     # -1: generate exactly max_new
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def prompt_len(self) -> int:
        return 0 if self.prompt is None else int(len(self.prompt))

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


# ------------------------------------------------------------------- buckets


@dataclass(frozen=True)
class BucketSpec:
    """One cache-slot block: ``batch`` slots of sequence ceiling
    ``seq``. ``prompt_ceiling`` bounds admissible prompt lengths (it
    equals ``seq`` except for ring-buffer caches, where the prefill
    window is the ring length)."""
    batch: int
    seq: int
    prompt_ceiling: int = 0

    def __post_init__(self):
        if self.batch < 1 or self.seq < 1:
            raise ValueError(f"bad bucket {self.batch}x{self.seq}")
        if self.prompt_ceiling <= 0:
            object.__setattr__(self, "prompt_ceiling", self.seq)

    @property
    def name(self) -> str:
        return f"b{self.batch}xs{self.seq}"


def default_bucket_layout(max_seq: int, *, slots: int = 8,
                          n_buckets: int = 2) -> Tuple[BucketSpec, ...]:
    """A pow2 ladder of sequence ceilings ending at ``max_seq`` with
    the slot budget split evenly — the serving analogue of
    reference's ``data.dr.bucket_clients`` pow2 strategy."""
    if max_seq < 2 ** (n_buckets - 1):
        raise ValueError(f"max_seq={max_seq} too small for {n_buckets} buckets")
    seqs = [max(1, max_seq // 2 ** (n_buckets - 1 - i))
            for i in range(n_buckets)]
    per = max(1, slots // n_buckets)
    return tuple(BucketSpec(batch=per, seq=s) for s in seqs)


# ----------------------------------------------------------------- scheduler


class SlotScheduler:
    """FIFO queue + per-bucket free-slot admission."""

    def __init__(self, buckets):
        self.buckets: Tuple[BucketSpec, ...] = tuple(buckets)
        if not self.buckets:
            raise ValueError("need at least one bucket")
        self.queue: deque = deque()
        self.free: List[List[int]] = [list(range(b.batch))
                                      for b in self.buckets]
        self.running: Dict[Tuple[int, int], Request] = {}
        self.n_submitted = 0
        self.n_done = 0

    # -- routing --------------------------------------------------------

    def bucket_for(self, req: Request) -> Optional[int]:
        """Smallest-ceiling bucket that fits the request, or None."""
        best, best_seq = None, None
        for i, b in enumerate(self.buckets):
            if req.total_len <= b.seq and req.prompt_len <= b.prompt_ceiling:
                if best_seq is None or (b.seq, b.batch) < best_seq:
                    best, best_seq = i, (b.seq, b.batch)
        return best

    # -- queue ----------------------------------------------------------

    def submit(self, req: Request) -> int:
        bi = self.bucket_for(req)
        if bi is None:
            raise ValueError(
                f"request {req.rid} (prompt {req.prompt_len} + "
                f"{req.max_new_tokens} new) fits no bucket "
                f"{[b.name for b in self.buckets]}")
        self.queue.append(req)
        self.n_submitted += 1
        return bi

    def admit(self) -> Dict[int, List[Tuple[int, Request]]]:
        """Move queued requests into free slots. Returns
        ``{bucket_idx: [(slot, request), ...]}`` for this round's
        admissions; requests whose bucket is full keep their queue
        order."""
        admitted: Dict[int, List[Tuple[int, Request]]] = {}
        waiting: deque = deque()
        while self.queue:
            req = self.queue.popleft()
            bi = self.bucket_for(req)
            if self.free[bi]:
                slot = self.free[bi].pop(0)
                self.running[(bi, slot)] = req
                admitted.setdefault(bi, []).append((slot, req))
            else:
                waiting.append(req)
        self.queue = waiting
        return admitted

    def release(self, bucket_idx: int, slot: int) -> Request:
        req = self.running.pop((bucket_idx, slot))
        self.free[bucket_idx].append(slot)
        self.free[bucket_idx].sort()
        self.n_done += 1
        return req

    # -- introspection ---------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running

    def occupancy(self) -> Dict[str, float]:
        """Fraction of each bucket's slots currently running."""
        return {b.name: 1.0 - len(self.free[i]) / b.batch
                for i, b in enumerate(self.buckets)}
