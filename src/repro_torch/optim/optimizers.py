"""Hand-rolled optimizers (counterpart of ``repro.optim.optimizers``).

All optimizers share one interface::

    opt = make_optimizer(OptimizerConfig(...))
    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params, lr)

``init`` and ``update`` act on ONE client's tree. The swarm vmaps them
over the client axis together with the gradient (see
:mod:`repro_torch.train.steps`), so the global-norm ``grad_clip`` and
adam's ``step`` are per client, as they are in the reference, where the
optimizer runs inside the client vmap. Adafactor is not ported.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.utils.tree import tree_global_norm, tree_leaves, tree_map

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable                 # (grads, state, params, lr) -> (params, state)


def _clip_by_global_norm(grads, max_norm):
    if max_norm <= 0:
        return grads
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


@functools.cache
def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "sgd":
        return _sgd(cfg)
    if cfg.name == "momentum":
        return _momentum(cfg)
    if cfg.name in ("adam", "adamw"):
        return _adam(cfg, decoupled_wd=(cfg.name == "adamw"))
    raise ValueError(f"unknown or unported optimizer '{cfg.name}'")


def _sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params, lr):
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
        new_params = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new_params, {"step": state["step"] + 1}

    return Optimizer("sgd", init, update)


def _momentum(cfg: OptimizerConfig) -> Optimizer:
    sdt = _STATE_DTYPES[cfg.state_dtype]

    def init(params):
        return {"step": _step0(params),
                "mu": tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params)}

    def update(grads, state, params, lr):
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
        mu = tree_map(lambda m, g: cfg.momentum * m + g.to(m.dtype), state["mu"], grads)
        new_params = tree_map(lambda p, m: p - lr * m.to(p.dtype), params, mu)
        return new_params, {"step": state["step"] + 1, "mu": mu}

    return Optimizer("momentum", init, update)


def _adam(cfg: OptimizerConfig, decoupled_wd: bool) -> Optimizer:
    sdt = _STATE_DTYPES[cfg.state_dtype]

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=sdt)
        return {"step": _step0(params), "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, lr):
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        t = step.float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g.to(m_.dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * torch.square(g.to(v_.dtype)),
                     state["v"], grads)

        def step_fn(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
            if decoupled_wd and cfg.weight_decay > 0:
                upd = upd + cfg.weight_decay * p.to(upd.dtype)
            return (p.float() - lr * upd).to(p.dtype)

        new_params = tree_map(step_fn, params, m, v)
        return new_params, {"step": step, "m": m, "v": v}

    return Optimizer("adamw" if decoupled_wd else "adam", init, update)
