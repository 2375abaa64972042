"""Table II methods as slices of the engine's method axis (counterpart
of ``repro.core.baselines``).

All four paper methods (centralized / local / FedAvg / BSO-SL) are
:class:`~repro_torch.core.engine.MethodParams` rows of the one round in
:mod:`repro_torch.core.engine`. Which entry point to use:

* :func:`run_method` -- one paper method, ``run_rounds`` over its row.
* :func:`run_sweep_table` -- the whole method axis through
  ``run_sweep``, every row over one shared device-resident
  :class:`~repro_torch.core.engine.SwarmData`. Row m is exactly
  :func:`run_method` of ``methods[m]`` with ``sweep_keys(seed)[m]``.
* :func:`run_grid_point` -- one hyper-parameter grid row, ``run_rounds``
  over its :class:`~repro_torch.core.engine.GridPoint`.
* :func:`run_grid_table` -- a whole grid through ``run_grid``; row g is
  exactly :func:`run_grid_point` of ``specs[g]`` with
  ``sweep_keys(seed, specs)[g]`` under the same pads.
* :func:`train_centralized` -- the pooled-data host loop, the oracle of
  the engine's pooled-sampling centralized row.

Everything runs on ``cuda`` unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig, SwarmConfig
from repro_torch.core.engine import (SWEEP_METHODS, EngineConfig, RoundMetrics, SwarmData,
                                     grid_axes, grid_point, make_batch,
                                     make_bucketed_swarm_data, make_client_eval,
                                     make_grid_config, make_grid_state,
                                     make_swarm_data, make_swarm_state, make_sweep_config,
                                     make_sweep_state, method_params, resolve_local_steps,
                                     run_grid, run_rounds, run_sweep, stack_eval_split)
from repro_torch.core.swarm import eval_client
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.utils.device import resolve_device


def make_method_setup(model: Model, clients_data, swarm: SwarmConfig,
                      opt_cfg: OptimizerConfig, *, batch_size: int = 16, lr=None,
                      cfg: EngineConfig = None, data: SwarmData = None, layout: str = "rect",
                      device=None):
    """(EngineConfig, data) shared by every method slice. A given ``cfg``
    or ``data`` passes through untouched, so repeated slices share one
    device-resident dataset. ``layout`` is the data layout built here:
    ``"rect"`` (:class:`~repro_torch.core.engine.SwarmData`, every client
    padded to the largest one) or ``"bucketed"``
    (:class:`~repro_torch.core.engine.BucketedSwarmData`, size buckets,
    each padded to its own largest client; on the CPU the same results
    bitwise). Every entry point below takes either."""
    if layout not in ("rect", "bucketed"):
        raise ValueError(f"unknown layout {layout!r} (one of 'rect', 'bucketed')")
    if cfg is None:
        cfg = EngineConfig(
            model=model, opt=make_optimizer(opt_cfg),
            local_steps=resolve_local_steps(swarm, clients_data, batch_size),
            batch_size=batch_size, lr=lr if lr is not None else opt_cfg.lr,
            aggregation="bso", n_clusters=swarm.n_clusters, p1=swarm.p1, p2=swarm.p2,
            kmeans_iters=swarm.kmeans_iters)
    if data is None:
        build = make_bucketed_swarm_data if layout == "bucketed" else make_swarm_data
        data = build(model.cfg, clients_data, device=resolve_device(device))
    return cfg, data


class MethodRun(NamedTuple):
    """One finished fit: the final state and the (rounds,)-stacked
    metrics; from :func:`run_sweep_table`, the list of per-row states and
    (M, rounds)-stacked metrics."""
    state: object
    metrics: RoundMetrics


def sweep_keys(seed: int, methods: Sequence = SWEEP_METHODS) -> List[int]:
    """Per-row seeds derived from one seed (the counterpart of
    ``jax.random.split``; only the length of ``methods`` matters): the
    one copy, so that a serial run reproduces sweep row m."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(len(methods))]


def _test_stack(model: Model, clients_data, data: SwarmData, test_stack):
    if test_stack is None:
        test_stack = stack_eval_split(model.cfg, clients_data, "test",
                                      device=data.train_n.device)
    return test_stack


def run_method(method: str, model: Model, clients_data, swarm: SwarmConfig,
               opt_cfg: OptimizerConfig, seed: int, *, batch_size: int = 16,
               verbose: bool = False, cfg: EngineConfig = None, data: SwarmData = None,
               test_stack=None, device=None):
    """One Table-II row; ``method`` in {centralized, local, fedavg,
    bso-sl}. The accuracy is Eq. 3 (the mean of per-client test
    accuracy) of the final per-client models. Pass ``cfg`` / ``data`` /
    ``test_stack`` of an earlier call to share them. Returns
    ``(acc, MethodRun)``."""
    cfg, data = make_method_setup(model, clients_data, swarm, opt_cfg, batch_size=batch_size,
                                  cfg=cfg, data=data, device=device)
    dev = data.train_n.device
    state = make_swarm_state(model, cfg.opt, clients_data, seed, device=dev)
    state, ms = run_rounds(state, data, cfg, swarm.rounds,
                           method_params(method, len(clients_data), dev))
    if verbose:
        for r, acc in enumerate(ms.mean_val_acc.tolist()):
            print(f"[{method}] round {r:3d} val_acc={acc:.4f}")
    scores = make_client_eval(model)(state.params,
                                     _test_stack(model, clients_data, data, test_stack))
    return float(scores.mean()), MethodRun(state, ms)


def run_sweep_table(model: Model, clients_data, swarm: SwarmConfig, opt_cfg: OptimizerConfig,
                    seed: int, *, methods: Sequence[str] = SWEEP_METHODS,
                    batch_size: int = 16, cfg: EngineConfig = None, data: SwarmData = None,
                    test_stack=None, device=None):
    """The whole Table II through ``run_sweep``: ``seed`` gives the
    per-row seeds (:func:`sweep_keys`), so row m is exactly
    ``run_method(methods[m], ..., sweep_keys(seed, methods)[m])``.
    Returns ``({method: Eq. 3 test acc}, MethodRun)`` with the per-row
    final states and (M, rounds) metrics."""
    cfg, data = make_method_setup(model, clients_data, swarm, opt_cfg, batch_size=batch_size,
                                  cfg=cfg, data=data, device=device)
    dev = data.train_n.device
    states = make_sweep_state(model, cfg.opt, clients_data, sweep_keys(seed, methods),
                              device=dev)
    sweep = make_sweep_config(len(clients_data), methods, dev)
    states, ms = run_sweep(states, data, cfg, sweep, swarm.rounds)
    test_stack = _test_stack(model, clients_data, data, test_stack)
    client_eval = make_client_eval(model)
    accs = {m: float(client_eval(s.params, test_stack).mean()) for m, s in zip(methods, states)}
    return accs, MethodRun(states, ms)


def run_grid_point(spec: dict, model: Model, clients_data, swarm: SwarmConfig,
                   opt_cfg: OptimizerConfig, seed: int, *, batch_size: int = 16,
                   cfg: EngineConfig = None, data: SwarmData = None, test_stack=None,
                   device=None):
    """One hyper-parameter point, serially: ``run_rounds`` over the
    :func:`~repro_torch.core.engine.grid_point` of ``spec`` (e.g.
    ``{"k": 2, "p1": 1.0}``; empty = the paper point), whose pads come
    from ``cfg``. It is the serial slice of the matching
    :func:`run_grid_table` row. Returns ``(acc, MethodRun)`` like
    :func:`run_method`."""
    cfg, data = make_method_setup(model, clients_data, swarm, opt_cfg, batch_size=batch_size,
                                  cfg=cfg, data=data, device=device)
    dev = data.train_n.device
    point = grid_point(cfg, len(clients_data), device=dev, **spec)
    state = make_swarm_state(model, cfg.opt, clients_data, seed, device=dev)
    state, ms = run_rounds(state, data, cfg, swarm.rounds, point)
    scores = make_client_eval(model)(state.params,
                                     _test_stack(model, clients_data, data, test_stack))
    return float(scores.mean()), MethodRun(state, ms)


def run_grid_table(model: Model, clients_data, swarm: SwarmConfig, opt_cfg: OptimizerConfig,
                   seed: int, *, axes: dict = None, specs: Sequence[dict] = None,
                   batch_size: int = 16, cfg: EngineConfig = None, data: SwarmData = None,
                   test_stack=None, device=None):
    """A whole hyper-parameter ablation through ``run_grid``, the grid's
    sibling of :func:`run_sweep_table`.

    Pass either ``axes`` (named axes, expanded row-major by
    :func:`~repro_torch.core.engine.grid_axes`, e.g. ``axes={"k": (1, 2,
    3), "p1": (0.9, 1.0)}``) or an explicit ``specs`` list of grid-point
    keyword dicts. ``cfg``'s ``n_clusters`` and ``local_steps`` are the
    grid's pads. When ``cfg`` is built here, every row is first pinned to
    the caller's ``k`` and step count, then the pads are raised to the
    grid's largest ``k`` and ``local_steps`` (never lowered), so a spec
    that omits a knob keeps the caller's value. Rows with fewer steps
    than the pad make ``run_grid`` compute only their own steps
    (``schedule``). Row g is :func:`run_grid_point` of ``specs[g]`` with
    ``sweep_keys(seed, specs)[g]``. The churn knobs (``dropout``,
    ``stale_decay``, ``churn_mask``) ride the same surface, in every row
    or none; a churn grid never takes a schedule. Returns
    ``(results, MethodRun)``:
    ``results`` is a ``{**spec, "acc": Eq. 3 test acc}`` row per grid
    point in grid order, the MethodRun the per-row final states and (G,
    rounds) metrics."""
    if (axes is None) == (specs is None):
        raise ValueError("pass exactly one of axes= or specs=")
    if specs is None:
        specs = grid_axes(**axes)
    rows = specs
    if cfg is None:
        base_steps = resolve_local_steps(swarm, clients_data, batch_size)
        rows = [{"k": swarm.n_clusters, "local_steps": base_steps, **s} for s in specs]
        swarm = dataclasses.replace(
            swarm, n_clusters=max(swarm.n_clusters, *(int(r["k"]) for r in rows)),
            local_steps=max(base_steps, *(int(r["local_steps"]) for r in rows)))
    cfg, data = make_method_setup(model, clients_data, swarm, opt_cfg, batch_size=batch_size,
                                  cfg=cfg, data=data, device=device)
    dev = data.train_n.device
    states = make_grid_state(model, cfg.opt, clients_data, sweep_keys(seed, specs), device=dev)
    grid = make_grid_config(cfg, len(clients_data), rows, dev)
    row_steps = tuple(int(r.get("local_steps", cfg.local_steps)) for r in rows)
    schedule = (row_steps if min(row_steps) < cfg.local_steps and grid.churn is None
                else None)
    states, ms = run_grid(states, data, cfg, grid, swarm.rounds, schedule)
    test_stack = _test_stack(model, clients_data, data, test_stack)
    client_eval = make_client_eval(model)
    results = [{**spec, "acc": float(client_eval(s.params, test_stack).mean())}
               for spec, s in zip(specs, states)]
    return results, MethodRun(states, ms)


def train_centralized(model: Model, clients_data: List[dict], opt_cfg: OptimizerConfig,
                      seed: int, *, steps: int, batch_size: int = 32, lr=None,
                      init_params=None, device=None):
    """Host-loop pooled-data training, the oracle the engine's pooled
    centralized row miniaturises. Batches come from the reference's
    index stream (``np.random.default_rng(0)`` over the pooled train
    rows), so from the same initial params (``init_params``, else
    ``model.init`` of a generator seeded from ``seed``) it takes the
    reference's steps. Returns (params, Eq. 3 test accuracy of the one
    global model)."""
    dev = resolve_device(device)
    X = np.concatenate([c["train"][0] for c in clients_data])
    y = np.concatenate([c["train"][1] for c in clients_data])
    rng = np.random.default_rng(0)

    opt = make_optimizer(opt_cfg)
    if init_params is None:
        init_params = model.init(torch.Generator(device=dev).manual_seed(seed))
    params = init_params
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    eval_fn = make_eval_step(model)
    lr = lr if lr is not None else opt_cfg.lr

    for _ in range(steps):
        idx = rng.integers(0, len(y), size=batch_size)
        params, opt_state, _ = step(params, opt_state, make_batch(model.cfg, X[idx], y[idx], dev),
                                    lr)
    accs = [eval_client(eval_fn, model.cfg, params, *c["test"]) for c in clients_data]
    return params, float(np.mean(accs))

