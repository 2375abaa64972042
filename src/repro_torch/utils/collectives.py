"""The fleet's collectives, each recorded in a census.

Every collective the fleet regime issues goes through this module: an
all-reduce (Eq. 2's segment sums, the round's means), an all-gather
(the merge of a placed leaf's shard statistics), a gather to rank 0
(the stat upload) or a broadcast from rank 0 (the coordinator's
decision). Each call records ``(op, bytes, tag)`` in :data:`CENSUS`, the
bytes of the tensor that this rank hands to the collective. The census
works like the kernels' ``.launches`` counters: a reader takes
:meth:`Census.mark` before the work and :meth:`Census.since` after it.
``repro_torch.launch.comm`` turns the entries into the traffic ledger.

Every function takes its ``group`` from the caller; none reaches for the
default process group.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.distributed as dist


class Collective(NamedTuple):
    op: str          # all_reduce | all_gather | gather | broadcast
    nbytes: int      # bytes this rank hands to the collective
    tag: str         # what it carries: eq2 | round | stats_merge | upload | decision | export


class Census:
    """The collectives issued so far, in order."""

    def __init__(self):
        self.entries: List[Collective] = []

    def record(self, op: str, t: torch.Tensor, tag: str) -> None:
        self.entries.append(Collective(op, t.numel() * t.element_size(), tag))

    def mark(self) -> int:
        return len(self.entries)

    def since(self, mark: int) -> List[Collective]:
        return list(self.entries[mark:])


CENSUS = Census()


def all_reduce_sum(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``'s ranks; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    CENSUS.record("all_reduce", t, tag)
    return t


def mean_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ranks of a () tensor (each rank's mean over an equal
    share of the clients, so this is the mean over all clients)."""
    t = x.detach().float().reshape(1).clone()
    all_reduce_sum(t, group, "round")
    return (t / dist.get_world_size(group))[0]


def all_gather_stack(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """``t`` of every rank of ``group`` stacked on a new dim 0, in rank
    order, on every rank (equal shapes on every rank)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    CENSUS.record("all_gather", t, tag)
    return torch.stack(parts)


def gather_to_root(t: torch.Tensor, group, tag: str = "upload"):
    """``t`` of every rank concatenated on dim 0, on rank 0 of ``group``
    (equal shapes on every rank); None on the other ranks."""
    t = t.contiguous()
    world = dist.get_world_size(group)
    root = dist.get_global_rank(group, 0)
    is_root = dist.get_rank(group) == 0
    parts = [torch.empty_like(t) for _ in range(world)] if is_root else None
    dist.gather(t, parts, dst=root, group=group)
    CENSUS.record("gather", t, tag)
    return torch.cat(parts) if is_root else None


def broadcast_from_root(t: torch.Tensor, group, tag: str = "decision") -> torch.Tensor:
    """Rank 0's ``t`` on every rank of ``group`` (in place)."""
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    CENSUS.record("broadcast", t, tag)
    return t
