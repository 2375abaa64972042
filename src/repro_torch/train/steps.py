"""train_step / eval_step factories (counterpart of ``repro.train.steps``).

Both act on ONE client's params; the swarm engine vmaps them over the
client axis with ``torch.func.vmap``, the optimizer update included.
Microbatching is not ported.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value

from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer


def make_train_step(model: Model, opt: Optimizer):
    grad_fn = grad_and_value(model.loss, has_aux=True)

    def train_step(params, opt_state, batch, lr):
        grads, (_, metrics) = grad_fn(params, batch)
        new_params, new_opt = opt.update(grads, opt_state, params, lr)
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step
