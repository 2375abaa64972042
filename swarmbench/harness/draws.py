"""Every random input of the rounds a run drives, made on the device from
the seed in a few calls, in the fields ``repro_torch.core.engine.RoundDraws``
takes: each local step's rows (uniform with replacement below each
client's train size), the k-means++ uniforms and the brain storm's
uniforms and Gumbel draws. The pool holds ``n_rounds`` rounds; round
``r`` takes slot ``r % n_rounds``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from swarmbench.harness.seeds import generator


@dataclass
class Draws:
    batch_idx: torch.Tensor          # (local_steps, N, B) int64
    kmeans_u: torch.Tensor           # (k,) float64
    r1: torch.Tensor                 # (k,) float32: replace if r1 > p1
    g: torch.Tensor                  # (k, N) float32 Gumbel: random member
    r2: torch.Tensor                 # (k,) float32: swap if r2 > p2
    g2: torch.Tensor                 # (k, k) float32 Gumbel: swap partner


def _gumbel(u):
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


class DrawPool:
    def __init__(self, seed: int, train_n: torch.Tensor, local_steps: int, batch: int, k: int,
                 n_rounds: int):
        dev = train_n.device
        gen = generator(seed, "draws", dev)
        N = train_n.shape[0]
        self.n_rounds = n_rounds
        u = torch.rand((n_rounds, local_steps, N, batch), generator=gen, device=dev,
                       dtype=torch.float64)
        n = train_n.to(torch.float64)[None, None, :, None]
        self.batch_idx = torch.minimum((u * n).long(), train_n[None, None, :, None] - 1)
        self.kmeans_u = torch.rand((n_rounds, k), generator=gen, device=dev, dtype=torch.float64)
        self.r1 = torch.rand((n_rounds, k), generator=gen, device=dev)
        self.g = _gumbel(torch.rand((n_rounds, k, N), generator=gen, device=dev))
        self.r2 = torch.rand((n_rounds, k), generator=gen, device=dev)
        self.g2 = _gumbel(torch.rand((n_rounds, k, k), generator=gen, device=dev))

    def __call__(self, r: int) -> Draws:
        i = r % self.n_rounds
        return Draws(self.batch_idx[i], self.kmeans_u[i], self.r1[i], self.g[i], self.r2[i],
                     self.g2[i])
