"""Hand-rolled optimizers (counterpart of ``repro.optim.optimizers``).

All optimizers share one interface::

    opt = make_optimizer(OptimizerConfig(...))
    state = opt.init(params)
    new_params, new_state = opt.update(grads, state, params, lr)

``init`` and ``update`` act on ONE client's tree. The swarm vmaps them
over the client axis together with the gradient (see
:mod:`repro_torch.train.steps`), so the global-norm ``grad_clip`` and
adam's ``step`` are per client, as they are in the reference, where the
optimizer runs inside the client vmap. Adafactor keeps factored second
moments, so a matrix's optimizer state is O(rows + cols).
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
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    raise ValueError(f"unknown optimizer '{cfg.name}'")


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


def _adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Factored second moments (Shazeer & Stern 2018), no first moment.
    A leaf of rank >= 2 keeps the row and column means of g^2 over its
    last two axes (``vr`` of shape ``p.shape[:-1]``, ``vc`` of
    ``p.shape[:-2] + p.shape[-1:]``, so a stacked (L, rows, cols) leaf
    keeps one pair a layer); a lower rank keeps a full ``v``. The decay
    is ``beta = 1 - t^-0.8``, each leaf's update is scaled down to RMS 1
    where it is above, weight decay is decoupled, and the global-norm
    clip comes first. The state is fp32 whatever ``state_dtype`` says,
    as in the reference."""
    eps2 = 1e-30

    def init(params):
        def leaf_state(p):
            # zeros_like of slices of p, so that a vmapped init keeps the client axis
            if p.dim() >= 2:
                return {"vr": torch.zeros_like(p[..., 0], dtype=torch.float32),
                        "vc": torch.zeros_like(p[..., 0, :], dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"step": _step0(params), "v": tree_map(leaf_state, params)}

    def update(grads, state, params, lr):
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"] + 1
        beta = 1.0 - step.float() ** -0.8

        def leaf_update(p, g, s):
            g = g.float()
            g2 = torch.square(g) + eps2
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps2)
                precond = (vr[..., :, None] / denom[..., :, None]) * vc[..., None, :]
                upd = g / (torch.sqrt(precond) + cfg.eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = g / (torch.sqrt(v) + cfg.eps)
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps2)
            upd = upd / torch.clamp(rms, min=1.0)
            if cfg.weight_decay > 0:
                upd = upd + cfg.weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype), new_s

        # tree_map stops at params' leaves, so each call gets the leaf's state dict
        out = tree_map(leaf_update, params, grads, state["v"])
        return (tree_map(lambda _, o: o[0], params, out),
                {"step": step, "v": tree_map(lambda _, o: o[1], params, out)})

    return Optimizer("adafactor", init, update)
