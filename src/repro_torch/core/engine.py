"""Functional BSO-SL round engine, sim regime (counterpart of
``repro.core.engine``).

The paper's round (§III): local training -> distribution upload ->
k-means -> brain storm -> Eq. 2 aggregation, as a function over an
explicit :class:`SwarmState`::

    state, metrics = swarm_round(state, data, cfg)

Clients are stacked along dim 0 of every tensor. Local training vmaps
one client's train step (gradient and optimizer update together) over
that axis with ``torch.func.vmap``; the coordinator runs on the device
beside it: the ``param_stats`` kernel per parameter leaf, the
``kmeans_assign`` kernel per Lloyd step, the brain storm and Eq. 2, with
no host round trip inside a round.

Randomness comes from the state's ``torch.Generator``. JAX's threefry
streams cannot be reproduced in torch, so :func:`swarm_round` also
takes a :class:`RoundDraws` holding every random input of one round
(batch indices, k-means seeds, brain-storm draws): that is how the
tests feed it the reference's randomness.

Not ported yet: the method, grid, churn and hierarchical axes, the
bucketed data layout and the fleet regime.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import ModelConfig, SwarmConfig
from repro_torch.core.aggregation import cluster_fedavg
from repro_torch.core.bso import BSODraws, brain_storm
from repro_torch.core.diststats import swarm_distribution_matrix
from repro_torch.core.kmeans import kmeans
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map, tree_stack

# --------------------------------------------------------------------- state


class SwarmState(NamedTuple):
    """The complete mutable state of a swarm."""
    params: Any                      # client-stacked model tree (N, ...)
    opt_state: Any                   # client-stacked optimizer tree
    generator: torch.Generator       # drives sampling, seeding and BSA
    round: int                       # rounds done
    n_samples: torch.Tensor          # (N,) float32 |D_h| (Eq. 2 weights)


class SwarmData(NamedTuple):
    """Device-resident, fixed-shape swarm dataset.

    train:   {"images": (N, n_max, H, W, 3), "labels": (N, n_max)};
             clients shorter than n_max are padded with label -1 rows,
             which the sampler never draws.
    train_n: (N,) int64 true train-set sizes, the sampling bound.
    val:     client-stacked eval batches (N, n_batches, batch, ...)
             padded with label -1 rows (see :func:`stack_eval_split`).
    """
    train: Any
    train_n: torch.Tensor
    val: Any


class RoundMetrics(NamedTuple):
    """Per-round outputs, all device tensors."""
    mean_val_acc: Any                # () paper Eq. 3 on the val split
    val_acc: Any                     # (N,) per-client val accuracy
    train_loss: Any                  # () mean loss of the last local step
    assignments: Any                 # (N,) int32 post-BSA clusters
    centers: Any                     # (k,) int32 center client ids
    n_replaced: Any                  # () int32 BSA replacement events
    n_swapped: Any                   # () int32 BSA swap events


class RoundDraws(NamedTuple):
    """Every random input of one round, for injecting a reference's
    draws. ``kmeans_init_idx`` and ``bso`` are only read when the
    round runs the coordinator (``aggregation="bso"``)."""
    batch_idx: torch.Tensor          # (local_steps, N, B) train rows
    kmeans_init_idx: torch.Tensor    # (k,) k-means++ seed rows
    bso: BSODraws                    # brain-storm draws


@dataclass(frozen=True)
class EngineConfig:
    """Static round configuration."""
    model: Model
    opt: Optimizer
    local_steps: int
    batch_size: int
    lr: float
    aggregation: str = "bso"         # bso | fedavg | none
    n_clusters: int = 3
    p1: float = 0.9
    p2: float = 0.8
    kmeans_iters: int = 20


def resolve_local_steps(swarm: SwarmConfig, clients_data, batch_size: int) -> int:
    """Explicit ``swarm.local_steps``, else ``local_epochs`` over the
    mean clinic size."""
    if swarm.local_steps is not None:
        return swarm.local_steps
    mean_n = float(np.mean([c["n_train"] for c in clients_data]))
    return max(1, swarm.local_epochs * int(np.ceil(mean_n / batch_size)))


# --------------------------------------------------------------- data layout


def make_batch(cfg: ModelConfig, X, y, device) -> dict:
    if cfg.family != "cnn":
        raise NotImplementedError(f"only the cnn family is ported (got {cfg.family!r})")
    return {"images": torch.as_tensor(X, device=device),
            "labels": torch.as_tensor(y, device=device)}


def pad_eval_split(X, y, n_to: int):
    """Pad an eval slice to ``n_to`` rows: zero inputs, label -1 rows."""
    pad = n_to - len(y)
    if pad:
        X = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)])
        y = np.concatenate([y, -np.ones((pad,) + y.shape[1:], y.dtype)])
    return X, y


def stack_eval_split(cfg: ModelConfig, clients_data, split: str, batch: int = 64,
                     device=None) -> dict:
    """Client-stacked eval data of one split, (N, n_batches, batch, ...):
    every client padded to the largest one rounded up to ``batch``."""
    device = resolve_device(device)
    n_max = max(len(c[split][1]) for c in clients_data)
    n_to = -(-n_max // batch) * batch
    Xs, ys = [], []
    for c in clients_data:
        X, y = pad_eval_split(*c[split], n_to)
        Xs.append(X.reshape((n_to // batch, batch) + X.shape[1:]))
        ys.append(y.reshape((n_to // batch, batch) + y.shape[1:]))
    return make_batch(cfg, np.stack(Xs), np.stack(ys), device)


def make_swarm_data(cfg: ModelConfig, clients_data, *, eval_batch: int = 64,
                    device=None) -> SwarmData:
    """The device-resident :class:`SwarmData` of the per-clinic dicts."""
    device = resolve_device(device)
    n_max = max(len(c["train"][1]) for c in clients_data)
    Xs, ys = [], []
    for c in clients_data:
        X, y = pad_eval_split(*c["train"], n_max)
        Xs.append(X)
        ys.append(y)
    train = make_batch(cfg, np.stack(Xs), np.stack(ys), device)
    train_n = torch.as_tensor([len(c["train"][1]) for c in clients_data],
                              dtype=torch.int64, device=device)
    return SwarmData(train=train, train_n=train_n,
                     val=stack_eval_split(cfg, clients_data, "val", batch=eval_batch,
                                          device=device))


def make_swarm_state(model: Model, opt: Optimizer, clients_data, seed: int, *,
                     device=None) -> SwarmState:
    """Fresh per-client params and optimizer state, and the generator
    (seeded from ``seed``) that drives every later round."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tree_stack([model.init(gen) for _ in clients_data])
    # vmap expands the unbatched ``step`` scalar; make it a real (N,) tensor
    opt_state = tree_map(torch.Tensor.contiguous, vmap(opt.init)(params))
    n_samples = torch.as_tensor([c["n_train"] for c in clients_data],
                                dtype=torch.float32, device=device)
    return SwarmState(params=params, opt_state=opt_state, generator=gen, round=0,
                      n_samples=n_samples)


# -------------------------------------------------------------- round pieces


def draw_batch_idx(generator: torch.Generator, train_n, batch_size: int) -> torch.Tensor:
    """(N, B) uniform-with-replacement row ids below each client's
    ``train_n``, so pad rows are never drawn."""
    u = torch.rand((train_n.shape[0], batch_size), generator=generator,
                   device=train_n.device, dtype=torch.float64)
    idx = (u * train_n[:, None]).long()
    return torch.minimum(idx, train_n[:, None] - 1)


def sample_local_batch(train, idx) -> dict:
    """Per-client minibatch (N, B, ...) gathered on the device from
    row ids ``idx`` (N, B)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: v[rows, idx] for k, v in train.items()}


def local_phase(step, params, opt_state, lr, batches):
    """Local training: for each of ``batches`` (each an (N, B, ...)
    stacked batch), one train step vmapped over the client axis.
    Returns the new params and optimizer state and the (steps,) mean
    client loss of each step."""
    vstep = vmap(step, in_dims=(0, 0, 0, None))
    losses = []
    for batch in batches:
        params, opt_state, m = vstep(params, opt_state, batch, lr)
        losses.append(torch.mean(m["loss"]))
    return params, opt_state, torch.stack(losses)


def make_client_eval(model: Model):
    """Per-client masked accuracy over stacked (N, n_batches, batch, ...)
    eval data: one vmapped eval per microbatch, adding acc * valid so a
    padded microbatch counts only its real rows."""
    veval = vmap(make_eval_step(model))

    def client_eval(params, batches):
        n_batches = batches["labels"].shape[1]
        hits = tot = 0.0
        for j in range(n_batches):
            bt = {k: v[:, j] for k, v in batches.items()}
            m = veval(params, bt)
            valid = torch.sum(bt["labels"] >= 0, dim=1).float()
            hits = hits + m["acc"] * valid
            tot = tot + valid
        return hits / torch.clamp(tot, min=1.0)

    return client_eval


def eval_swarm(model: Model, params, data: SwarmData) -> torch.Tensor:
    """(N,) per-client val accuracy."""
    return make_client_eval(model)(params, data.val)


# ---------------------------------------------------------------- the round


def swarm_round(state: SwarmState, data: SwarmData, cfg: EngineConfig,
                draws: RoundDraws = None):
    """One full BSO-SL round: local steps, eval, distribution upload,
    k-means, brain storm, Eq. 2 aggregation. Random inputs come from
    ``draws`` when given, else from ``state.generator``."""
    if cfg.aggregation not in ("bso", "fedavg", "none"):
        raise ValueError(f"unknown aggregation {cfg.aggregation!r} "
                         "(one of 'bso', 'fedavg', 'none')")
    model, opt = cfg.model, cfg.opt
    gen = state.generator
    N = data.train_n.shape[0]
    dev = data.train_n.device

    # --- local phase
    step = make_train_step(model, opt)
    if draws is None:
        batch_idx = [draw_batch_idx(gen, data.train_n, cfg.batch_size)
                     for _ in range(cfg.local_steps)]
    else:
        batch_idx = draws.batch_idx.to(dev).long()
    batches = (sample_local_batch(data.train, idx) for idx in batch_idx)
    params, opt_state, losses = local_phase(step, state.params, state.opt_state,
                                            cfg.lr, batches)
    train_loss = losses[-1]

    # --- eval: per-client val accuracy (shared within clusters, §III.C)
    val = eval_swarm(model, params, data)

    # --- coordinator + aggregation
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.aggregation == "none":
        assignments = torch.zeros((N,), dtype=torch.int32, device=dev)
        centers = torch.zeros((0,), dtype=torch.int32, device=dev)
        n_rep = n_swap = zero
    else:
        if cfg.aggregation == "fedavg":
            k = 1
            assignments = torch.zeros((N,), dtype=torch.int32, device=dev)
            centers = torch.argmax(val)[None].int()
            n_rep = n_swap = zero
        else:
            k = cfg.n_clusters
            feats = swarm_distribution_matrix(params)
            _, a0 = kmeans(feats, k, cfg.kmeans_iters, generator=gen,
                           init_idx=None if draws is None else draws.kmeans_init_idx)
            assignments, centers, n_rep, n_swap = brain_storm(
                a0, val, k, cfg.p1, cfg.p2, generator=gen,
                draws=None if draws is None else draws.bso)
        params = cluster_fedavg(params, assignments, state.n_samples, k=k)

    new_state = state._replace(params=params, opt_state=opt_state, round=state.round + 1)
    metrics = RoundMetrics(mean_val_acc=torch.mean(val), val_acc=val,
                           train_loss=train_loss, assignments=assignments,
                           centers=centers, n_replaced=n_rep, n_swapped=n_swap)
    return new_state, metrics


def run_rounds(state: SwarmState, data: SwarmData, cfg: EngineConfig, rounds: int):
    """``rounds`` calls of :func:`swarm_round`; metrics gain a leading
    (rounds,) axis."""
    ms = []
    for _ in range(rounds):
        state, m = swarm_round(state, data, cfg)
        ms.append(m)
    return state, RoundMetrics(*(torch.stack(f) for f in zip(*ms)))


def copy_state(state: SwarmState) -> SwarmState:
    """A deep copy of ``state``: tensors cloned, generator forked at its
    current position."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return state._replace(params=tree_map(torch.clone, state.params),
                          opt_state=tree_map(torch.clone, state.opt_state),
                          generator=gen, n_samples=state.n_samples.clone())
