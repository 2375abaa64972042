"""Unified model interface (counterpart of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions over parameter dicts, so the swarm layer can vmap them over
a client-stacked tree with ``torch.func``. Only the CNN family is
ported.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn as cnn_lib
from repro_torch.utils.tree import tree_leaves


def cross_entropy(logits, labels):
    """Mean cross-entropy in fp32; labels < 0 are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - label_logit, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def accuracy(logits, labels):
    """Share of unmasked rows (labels >= 0) whose argmax is the label."""
    mask = labels >= 0
    hit = (torch.argmax(logits, dim=-1) == labels) & mask
    return hit.sum() / torch.clamp(mask.sum(), min=1)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]        # generator -> params
    forward: Callable[[Any, dict], tuple]         # (params, batch) -> (logits, aux)
    loss: Callable[[Any, dict], tuple]            # (params, batch) -> (loss, metrics)

    def param_count(self, params) -> int:
        return sum(x.numel() for x in tree_leaves(params))


@functools.cache
def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"{cfg.arch_id}: only the cnn family is ported (got {cfg.family!r})")

    def fwd(params, batch):
        logits = cnn_lib.apply_cnn(params, batch["images"], cfg)
        return logits, torch.zeros((), device=logits.device)

    def loss(params, batch):
        logits, _ = fwd(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce, {"loss": ce, "ce": ce, "acc": accuracy(logits, batch["labels"])}

    return Model(cfg, lambda gen: cnn_lib.init_cnn(gen, cfg), fwd, loss)
