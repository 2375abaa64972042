"""train_step / eval_step / serve_step / prefill_step factories
(counterpart of ``repro.train.steps``).

The train and eval steps act on ONE client's params; the swarm engine
vmaps them over the client axis with ``torch.func.vmap``, the optimizer
update included. The train step accumulates gradients over
microbatches when asked, as the reference's does. The serve and prefill
steps run the LM's decode step and chunked prefill.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value

from repro_torch.models.model import Model, argmax_last
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding import shard_act
from repro_torch.utils.trace import span
from repro_torch.utils.tree import tree_map


def make_train_step(model: Model, opt: Optimizer, *, microbatches: int = 0):
    """``train_step(params, opt_state, batch, lr) -> (params, opt_state,
    metrics)``. With ``microbatches`` > 1 every batch leaf is split on
    axis 0 into that many equal microbatches, whose gradients and
    metrics are summed in a Python loop and divided by the count before
    one optimizer update (gradient accumulation: activation memory of one
    microbatch). The step opens the spans ``train.gradient`` (the
    forward and backward), ``train.forward`` inside it and
    ``train.optimizer`` (:mod:`repro_torch.utils.trace`)."""
    def loss(params, batch):
        with span("train.forward"):
            return model.loss(params, batch)

    grad_fn = grad_and_value(loss, has_aux=True)

    def accumulate(params, batch):
        n = microbatches
        g_sum = m_sum = None
        for i in range(n):
            mb = tree_map(lambda x: _microbatch(x, n, i), batch)
            grads, (_, metrics) = grad_fn(params, mb)
            if g_sum is None:
                g_sum, m_sum = grads, metrics
            else:
                g_sum = tree_map(torch.add, g_sum, grads)
                m_sum = tree_map(torch.add, m_sum, metrics)
        return tree_map(lambda g: g / n, g_sum), tree_map(lambda m: m / n, m_sum)

    def train_step(params, opt_state, batch, lr):
        with span("train.gradient"):
            if microbatches and microbatches > 1:
                grads, metrics = accumulate(params, batch)
            else:
                grads, (_, metrics) = grad_fn(params, batch)
        with span("train.optimizer"):
            new_params, new_opt = opt.update(grads, opt_state, params, lr)
        return new_params, new_opt, metrics

    return train_step


def _microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows ``i*B/n .. (i+1)*B/n - 1`` of (B, ...): the i-th of n equal
    microbatches (a view), placed on the batch axis under a placement
    context."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split into {n} microbatches")
    m = x.shape[0] // n
    return shard_act(x.narrow(0, i * m, m), "batch", *([None] * (x.dim() - 1)))


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step


def make_serve_step(model: Model):
    """One greedy decode iteration: (next token (B,) int32, logits,
    cache). ``pos`` is a scalar for lock-step decode or (B,) for per-row
    positions (the serve engine)."""
    def serve_step(params, tokens, cache, pos):
        with torch.no_grad():
            logits, cache = model.decode_step(params, tokens, cache, pos)
        return argmax_last(logits[:, -1, :]).to(torch.int32), logits, cache
    return serve_step


def make_prefill_step(model: Model):
    """Chunked prefill: one forward over a (B, C) prompt chunk with
    KV-cache writeback. Returns the (B, C, V) logits and the cache."""
    if model.prefill is None:
        raise ValueError(f"{model.cfg.arch_id} ({model.cfg.family}) has no "
                         "chunked-prefill path")

    def prefill_step(params, tokens, cache, pos0):
        with torch.no_grad():
            return model.prefill(params, tokens, cache, pos0)
    return prefill_step
