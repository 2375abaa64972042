"""Functional BSO-SL round engine, sim regime (counterpart of
``repro.core.engine``).

The paper's round (§III): local training -> distribution upload ->
k-means -> brain storm -> Eq. 2 aggregation, as a function over an
explicit :class:`SwarmState`::

    state, metrics = swarm_round(state, data, cfg)

Clients are stacked along dim 0 of every tensor. Local training vmaps
one client's train step (gradient and optimizer update together) over
that axis with ``torch.func.vmap``; the coordinator runs on the device
beside it: one ``param_stats`` launch over every parameter leaf, the
``kmeans_assign`` kernel per Lloyd step, the brain storm and Eq. 2, with
no host round trip inside a round.

The round also carries the paper's Table-II **method axis**
(:class:`MethodParams`): centralized (every client samples the pooled
dataset, one global model), local (singleton clusters), FedAvg (one
global cluster) and BSO-SL (the coordinator's clusters) are three
tensors of data on one body. On that path the coordinator always runs
and the row's masks pick what aggregates, as in the reference.
:func:`run_sweep` runs the rows one after another over one shared
device-resident :class:`SwarmData`.

Randomness comes from the state's ``torch.Generator``. JAX's threefry
streams cannot be reproduced in torch, so :func:`swarm_round` also
takes a :class:`RoundDraws` holding every random input of one round
(batch rows, pooled rows, k-means seeding, brain-storm draws): that is
how the tests feed it the reference's randomness. Without one, a round
takes all its draws first, in one fixed order, whichever branch runs
(:func:`draw_round`), so a method row and the plain branch it equals
stay on one random stream round after round.

The **hyper-parameter grid axis** (:class:`GridPoint`) carries the
knobs the paper fixes (k, p1, p2, local steps, lr) as () tensors of a
row on top of the method masks. ``cfg.n_clusters`` and
``cfg.local_steps`` are the row's pads: the coordinator's k-means runs
at ``cfg.n_clusters`` with the row's ``n_clusters`` as its
``k_active`` (a device operand of the ``kmeans_assign`` kernel), and
the local phase computes every static step and where-selects steps
``>= local_steps`` back, so a row takes every draw of the round and
keeps its random stream. :func:`run_grid` runs the rows one after
another, as :func:`run_sweep` does; with a static ``schedule`` each row
computes only its own step count. Under the same draws (the native
run's are the first slices of the padded run's) a padded row is the
native-k method row.

Not ported yet: the churn and hierarchical axes (ROADMAP A9, A10), the
bucketed data layout and the fleet regime.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import ModelConfig, SwarmConfig
from repro_torch.core.aggregation import cluster_fedavg, singleton_assignments
from repro_torch.core.bso import BSODraws, brain_storm, draw_bso
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
    draws. ``batch_idx`` is each client's own rows; ``pool_idx`` the
    global row ids (in ``[0, sum(train_n))``) of a pooled batch, from
    which its per-step client ids follow; only the method path reads
    it, and only for a pooled row. The k-means seeding takes
    ``kmeans_init_idx`` (the seed rows) if given, else the uniforms
    ``kmeans_u``. The coordinator's draws are read only when the round
    runs the coordinator."""
    batch_idx: torch.Tensor          # (local_steps, N, B) own train rows
    kmeans_init_idx: Any             # (k,) k-means++ seed rows, or None
    bso: BSODraws                    # brain-storm draws
    pool_idx: Any = None             # (local_steps, N, B) pooled global rows
    kmeans_u: Any = None             # (k,) uniforms of the k-means++ seeding


class MethodParams(NamedTuple):
    """One Table-II method as data: three tensors on the swarm's device.
    ``base_assign`` is the aggregation plan when the coordinator is
    masked off; Eq. 2 then runs over N segments."""
    pool_data: torch.Tensor          # () bool: sample the pooled dataset
    use_coord: torch.Tensor          # () bool: take the brain-storm clusters
    base_assign: torch.Tensor        # (N,) int32: arange local, zeros global


#: Paper Table II method axis, in table order.
SWEEP_METHODS = ("centralized", "local", "fedavg", "bso-sl")


def method_params(method: str, n_clients: int, device=None) -> MethodParams:
    """The :class:`MethodParams` row of one paper method. Every method
    runs the same (rounds x local_steps x batch) budget."""
    if method not in SWEEP_METHODS:
        raise ValueError(f"unknown method {method!r}; one of {SWEEP_METHODS}")
    base = (singleton_assignments(n_clients, device) if method == "local"
            else torch.zeros((n_clients,), dtype=torch.int32, device=device))
    return MethodParams(pool_data=torch.tensor(method == "centralized", device=device),
                        use_coord=torch.tensor(method == "bso-sl", device=device),
                        base_assign=base)


def make_sweep_config(n_clients: int, methods=SWEEP_METHODS, device=None) -> MethodParams:
    """The rows of ``methods`` stacked on a leading (M,) axis."""
    rows = [method_params(m, n_clients, device) for m in methods]
    return MethodParams(*(torch.stack(f) for f in zip(*rows)))


def sweep_row(sweep: MethodParams, m: int) -> MethodParams:
    """Row ``m`` of a stacked sweep config."""
    return MethodParams(*(t[m] for t in sweep))


class GridPoint(NamedTuple):
    """One hyper-parameter grid row as data: the Table-II masks plus ()
    tensors on the swarm's device that override :class:`EngineConfig`
    statics, which act as the row's pads.

    - ``n_clusters`` ``<= cfg.n_clusters``: k-means runs at the pad with
      only the first ``n_clusters`` clusters live;
    - ``local_steps`` ``<= cfg.local_steps``: every static step
      computes, steps ``>= local_steps`` are where-selected back;
    - ``p1`` / ``p2`` / ``lr``: value overrides.

    Build rows with :func:`grid_point`, stack them with
    :func:`make_grid_config`."""
    method: MethodParams             # Table-II masks (grid rows: bso-sl)
    n_clusters: torch.Tensor         # () int32 live clusters, 1..cfg.n_clusters
    p1: torch.Tensor                 # () float32 center-replacement threshold
    p2: torch.Tensor                 # () float32 center-swap threshold
    local_steps: torch.Tensor        # () int32 applied local steps, 1..cfg.local_steps
    lr: torch.Tensor                 # () float32 local-phase learning rate


def grid_point(cfg: "EngineConfig", n_clients: int, *, method: str = "bso-sl", k=None,
               p1=None, p2=None, local_steps=None, lr=None, dropout=None, stale_decay=None,
               churn_mask=None, device=None) -> GridPoint:
    """One :class:`GridPoint`; a ``None`` knob inherits ``cfg``'s value,
    so the empty spec is the paper point. ``k`` and ``local_steps`` are
    checked against the static maxima here, so the round only sees
    in-range values. The churn knobs are not ported and raise."""
    given = [n for n, v in (("dropout", dropout), ("stale_decay", stale_decay),
                            ("churn_mask", churn_mask)) if v is not None]
    if given:
        raise NotImplementedError(f"the churn axes ({', '.join(given)}) are not ported yet "
                                  "(ROADMAP A9)")
    k = cfg.n_clusters if k is None else int(k)
    if not 1 <= k <= cfg.n_clusters:
        raise ValueError(f"grid k={k} outside [1, {cfg.n_clusters}] — "
                         f"cfg.n_clusters is the static pad k_max")
    steps = cfg.local_steps if local_steps is None else int(local_steps)
    if not 1 <= steps <= cfg.local_steps:
        raise ValueError(f"grid local_steps={steps} outside "
                         f"[1, {cfg.local_steps}] — cfg.local_steps is "
                         f"the static step budget")
    return GridPoint(
        method=method_params(method, n_clients, device),
        n_clusters=torch.tensor(k, dtype=torch.int32, device=device),
        p1=torch.tensor(cfg.p1 if p1 is None else p1, dtype=torch.float32, device=device),
        p2=torch.tensor(cfg.p2 if p2 is None else p2, dtype=torch.float32, device=device),
        local_steps=torch.tensor(steps, dtype=torch.int32, device=device),
        lr=torch.tensor(cfg.lr if lr is None else lr, dtype=torch.float32, device=device))


def grid_axes(**axes) -> list:
    """The cartesian product of named axes as :func:`grid_point` specs,
    row-major in the given axis order::

        grid_axes(k=(1, 2), p1=(0.9, 1.0))
        # -> [{'k': 1, 'p1': 0.9}, {'k': 1, 'p1': 1.0}, {'k': 2, ...}, ...]
    """
    names = list(axes)
    return [dict(zip(names, combo)) for combo in itertools.product(*(axes[n] for n in names))]


def make_grid_config(cfg: "EngineConfig", n_clients: int, specs, device=None) -> GridPoint:
    """The :func:`grid_point` rows of ``specs`` stacked on a leading (G,)
    axis."""
    rows = [grid_point(cfg, n_clients, device=device, **spec) for spec in specs]
    return GridPoint(method=MethodParams(*(torch.stack(f) for f in zip(*(r.method for r in rows)))),
                     **{f: torch.stack([getattr(r, f) for r in rows])
                        for f in GridPoint._fields[1:]})


def grid_row(grid: GridPoint, g: int) -> GridPoint:
    """Row ``g`` of a stacked grid config."""
    return GridPoint(sweep_row(grid.method, g), *(t[g] for t in grid[1:]))


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
    reset_opt_each_round: bool = False


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
    opt_state = init_opt_state(opt, params)
    n_samples = torch.as_tensor([c["n_train"] for c in clients_data],
                                dtype=torch.float32, device=device)
    return SwarmState(params=params, opt_state=opt_state, generator=gen, round=0,
                      n_samples=n_samples)


def make_sweep_state(model: Model, opt: Optimizer, clients_data, seeds, *,
                     device=None) -> list:
    """One :class:`SwarmState` per sweep row: row m is exactly the state
    :func:`make_swarm_state` builds from ``seeds[m]``, each with its own
    generator, so a sweep row and a serial :func:`run_rounds` from the
    same seed share one random stream."""
    return [make_swarm_state(model, opt, clients_data, s, device=device) for s in seeds]


def make_grid_state(model: Model, opt: Optimizer, clients_data, seeds, *,
                    device=None) -> list:
    """One :class:`SwarmState` per grid row, as :func:`make_sweep_state`
    builds them: a grid row and a serial :func:`run_rounds` from the
    same seed share one random stream."""
    return make_sweep_state(model, opt, clients_data, seeds, device=device)


def init_opt_state(opt: Optimizer, params):
    """Fresh client-stacked optimizer state (vmap expands the unbatched
    ``step`` scalar; it is made a real (N,) tensor)."""
    return tree_map(torch.Tensor.contiguous, vmap(opt.init)(params))


# -------------------------------------------------------------- round pieces


def draw_batch_idx(generator: torch.Generator, train_n, batch_size: int) -> torch.Tensor:
    """(N, B) uniform-with-replacement row ids below each client's
    ``train_n``, so pad rows are never drawn."""
    u = torch.rand((train_n.shape[0], batch_size), generator=generator,
                   device=train_n.device, dtype=torch.float64)
    idx = (u * train_n[:, None]).long()
    return torch.minimum(idx, train_n[:, None] - 1)


def draw_pool_idx(generator: torch.Generator, train_n, batch_size: int) -> torch.Tensor:
    """(N, B) uniform global row ids in ``[0, sum(train_n))``: a pooled
    batch's draw, before it is mapped to (client, row)."""
    total = torch.sum(train_n)
    u = torch.rand((train_n.shape[0], batch_size), generator=generator,
                   device=train_n.device, dtype=torch.float64)
    return torch.minimum((u * total).long(), total - 1)


def draw_round(generator: torch.Generator, train_n, cfg: EngineConfig) -> RoundDraws:
    """Every random input of one round from ``generator``, in one fixed
    order: own rows and pooled rows of each local step, the k-means++
    uniforms, the brain-storm draws. A round takes them all whichever
    branch it runs, so the generator is at the same place after a plain
    round and after the method row that equals it."""
    steps = range(cfg.local_steps)
    N, dev = train_n.shape[0], train_n.device
    batch_idx = torch.stack([draw_batch_idx(generator, train_n, cfg.batch_size)
                             for _ in steps])
    pool_idx = torch.stack([draw_pool_idx(generator, train_n, cfg.batch_size)
                            for _ in steps])
    kmeans_u = torch.rand((cfg.n_clusters,), generator=generator, device=dev,
                          dtype=torch.float64)
    return RoundDraws(batch_idx=batch_idx, kmeans_init_idx=None,
                      bso=draw_bso(cfg.n_clusters, N, generator, dev),
                      pool_idx=pool_idx, kmeans_u=kmeans_u)


def sample_local_batch(train, idx) -> dict:
    """Per-client minibatch (N, B, ...) gathered on the device from
    row ids ``idx`` (N, B)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: v[rows, idx] for k, v in train.items()}


def swarm_batch_indices(train_n, own_row, pool_idx, pool):
    """(client, row) pairs (N, B) of one method-axis minibatch, from its
    draws: ``own_row`` (N, B) rows below each client's ``train_n``, and
    ``pool_idx`` (N, B) global row ids below ``sum(train_n)``.

    - pool off: client i draws its own rows, exactly the per-client
      batch of :func:`sample_local_batch`;
    - pool on: a global row id is mapped to (client, row) through the
      cumulative client sizes, the centralized method's merged client
      N replicas wide. Pad rows stay unreachable in both.
    ``pool`` is a () bool tensor; the select runs on the device."""
    N = train_n.shape[0]
    own_row, pool_idx = own_row.to(train_n.dtype), pool_idx.to(train_n.dtype)
    own_client = torch.arange(N, device=train_n.device)[:, None].expand_as(own_row)
    cum = torch.cumsum(train_n, dim=0)
    pool_client = torch.searchsorted(cum, pool_idx, right=True)
    pool_row = pool_idx - (cum[pool_client] - train_n[pool_client])
    return (torch.where(pool, pool_client, own_client),
            torch.where(pool, pool_row, own_row))


def sample_swarm_batch(train, train_n, own_row, pool_idx, pool) -> dict:
    """Method-axis minibatch over the rectangular stack (see
    :func:`swarm_batch_indices`)."""
    client, row = swarm_batch_indices(train_n, own_row, pool_idx, pool)
    return {k: v[client, row] for k, v in train.items()}


def sample_round_batch(data: SwarmData, own_row, pool_idx=None, pool=None) -> dict:
    """One local step's stacked batch: the plain per-client batch when
    ``pool`` is None (no method row), else the method-axis batch."""
    if pool is None:
        return sample_local_batch(data.train, own_row)
    if pool_idx is None:
        raise ValueError("a method row samples through pooled draws: give RoundDraws.pool_idx")
    return sample_swarm_batch(data.train, data.train_n, own_row, pool_idx, pool)


def local_phase(step, params, opt_state, lr, batches, n_active=None):
    """Local training: for each of ``batches`` (each an (N, B, ...)
    stacked batch), one train step vmapped over the client axis.
    Returns the new params and optimizer state and the (steps,) mean
    client loss of each step.

    ``n_active`` (a () integer tensor, or None) is the grid row's step
    count: every step computes, and steps ``>= n_active`` leave params
    and optimizer state as they were, selected on the device (so
    applying every step is the plain path, bitwise)."""
    vstep = vmap(step, in_dims=(0, 0, 0, None))
    losses = []
    for i, batch in enumerate(batches):
        new_params, new_opt, m = vstep(params, opt_state, batch, lr)
        if n_active is None:
            params, opt_state = new_params, new_opt
        else:
            on = n_active > i
            params = tree_map(lambda new, old: torch.where(on, new, old), new_params, params)
            opt_state = tree_map(lambda new, old: torch.where(on, new, old), new_opt, opt_state)
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


def _coordinate(params, val, cfg: EngineConfig, draws: RoundDraws, grid: GridPoint = None):
    """Distribution upload -> k-means -> brain storm over the swarm:
    (assignments, centers, n_replaced, n_swapped). A grid row runs them
    at the pad ``cfg.n_clusters`` with its ``n_clusters`` live and its
    ``p1`` / ``p2``."""
    if draws.kmeans_init_idx is None and draws.kmeans_u is None:
        raise ValueError("RoundDraws needs kmeans_init_idx or kmeans_u for the coordinator")
    k_active, p1, p2 = ((None, cfg.p1, cfg.p2) if grid is None
                        else (grid.n_clusters, grid.p1, grid.p2))
    feats = swarm_distribution_matrix(params)
    _, a0 = kmeans(feats, cfg.n_clusters, cfg.kmeans_iters, init_idx=draws.kmeans_init_idx,
                   u=draws.kmeans_u, k_active=k_active)
    return brain_storm(a0, val, cfg.n_clusters, p1, p2, draws=draws.bso)


def _coordinate_and_aggregate(params, opt_state, val, n_samples, cfg: EngineConfig,
                              masks: MethodParams, draws: RoundDraws, grid: GridPoint = None):
    """The method- and grid-axis tail of :func:`swarm_round`: the
    coordinator (stats, k-means, brain storm; masked to the grid row's
    clusters) always runs, then the row's ``use_coord`` picks its
    assignments or ``base_assign``, and Eq. 2 runs over N segments (so
    the identity plan, the global plan and the coordinator's clusters
    share one layout). Returns ``(params, opt_state, assignments,
    centers, n_replaced, n_swapped)``."""
    N = n_samples.shape[0]
    if cfg.n_clusters > N:
        raise ValueError(f"the method axis needs n_clusters <= n_clients, got "
                         f"{cfg.n_clusters} > {N}")
    bsa_a, bsa_c, n_rep, n_swap = _coordinate(params, val, cfg, draws, grid)
    use = masks.use_coord
    zero = torch.zeros((), dtype=torch.int32, device=val.device)
    assignments = torch.where(use, bsa_a, masks.base_assign.to(bsa_a.dtype))
    centers = torch.where(use, bsa_c, -1)
    n_rep = torch.where(use, n_rep, zero)
    n_swap = torch.where(use, n_swap, zero)
    params = cluster_fedavg(params, assignments, n_samples, k=N)
    if cfg.reset_opt_each_round:
        opt_state = init_opt_state(cfg.opt, params)
    return params, opt_state, assignments, centers, n_rep, n_swap


def _check_grid_device(grid: GridPoint, dev) -> None:
    """A grid row's tensors must live on the swarm's device: the round
    reads them there and never on the host."""
    for name, t in [*zip(MethodParams._fields, grid.method), *zip(GridPoint._fields[1:], grid[1:])]:
        if t.device != dev:
            raise ValueError(f"GridPoint.{name} is on {t.device} but the swarm is on {dev}; "
                             "build the grid with device=")


def swarm_round(state: SwarmState, data: SwarmData, cfg: EngineConfig,
                method=None, draws: RoundDraws = None, steps: int = None):
    """One full BSO-SL round: local steps, eval, distribution upload,
    k-means, brain storm, Eq. 2 aggregation.

    ``method`` puts the round on a traced axis: a :class:`MethodParams`
    row (the Table-II axis; see :func:`_coordinate_and_aggregate`) or a
    :class:`GridPoint` (the grid axis: the method masks plus the row's
    k, p1, p2, local-step and lr overrides of the ``cfg`` statics, which
    are its pads). None keeps the static ``cfg.aggregation`` branches
    (``none`` skips the coordinator). Random inputs come from ``draws``
    when given, else from ``state.generator`` through
    :func:`draw_round`: a round takes every draw of ``cfg.local_steps``
    steps whatever the row applies.

    ``steps`` (a grid row only) computes just the first ``steps`` local
    steps, so the row applies ``min(local_steps, steps)`` of them; at
    ``steps == local_steps`` (see :func:`run_grid`) the result is the
    masked path's."""
    if cfg.aggregation not in ("bso", "fedavg", "none"):
        raise ValueError(f"unknown aggregation {cfg.aggregation!r} "
                         "(one of 'bso', 'fedavg', 'none')")
    model, opt = cfg.model, cfg.opt
    N = data.train_n.shape[0]
    dev = data.train_n.device
    grid = method if isinstance(method, GridPoint) else None
    masks = method if grid is None else grid.method
    if grid is not None:
        _check_grid_device(grid, dev)
    elif steps is not None:
        raise ValueError("steps= applies to a GridPoint row only")
    if draws is None:
        draws = draw_round(state.generator, data.train_n, cfg)

    # --- local phase (a grid row applies only its first local_steps)
    step = make_train_step(model, opt)
    pool = None if masks is None else masks.pool_data
    batch_idx = draws.batch_idx.to(dev).long()
    pool_idx = None if draws.pool_idx is None else draws.pool_idx.to(dev).long()
    n_run = batch_idx.shape[0] if steps is None else steps
    batches = (sample_round_batch(data, batch_idx[i],
                                  None if pool_idx is None else pool_idx[i], pool)
               for i in range(n_run))
    lr, n_active = (cfg.lr, None) if grid is None else (grid.lr, grid.local_steps)
    params, opt_state, losses = local_phase(step, state.params, state.opt_state, lr, batches,
                                            n_active)
    # the last applied step's loss, read on the device
    train_loss = (losses[-1] if grid is None else losses.index_select(
        0, (torch.clamp(n_active, max=n_run) - 1).long().reshape(1))[0])

    # --- eval: per-client val accuracy (shared within clusters, §III.C)
    val = eval_swarm(model, params, data)

    # --- coordinator + aggregation
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if masks is not None:
        params, opt_state, assignments, centers, n_rep, n_swap = _coordinate_and_aggregate(
            params, opt_state, val, state.n_samples, cfg, masks, draws, grid)
    elif cfg.aggregation == "none":
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
            assignments, centers, n_rep, n_swap = _coordinate(params, val, cfg, draws)
        params = cluster_fedavg(params, assignments, state.n_samples, k=k)
        if cfg.reset_opt_each_round:
            opt_state = init_opt_state(opt, params)

    new_state = state._replace(params=params, opt_state=opt_state, round=state.round + 1)
    metrics = RoundMetrics(mean_val_acc=torch.mean(val), val_acc=val,
                           train_loss=train_loss, assignments=assignments,
                           centers=centers, n_replaced=n_rep, n_swapped=n_swap)
    return new_state, metrics


def _stack_metrics(ms) -> RoundMetrics:
    return RoundMetrics(*(torch.stack(f) for f in zip(*ms)))


def run_rounds(state: SwarmState, data: SwarmData, cfg: EngineConfig, rounds: int,
               method=None, steps: int = None):
    """``rounds`` calls of :func:`swarm_round` (on the method or grid row
    ``method``, if given; ``steps`` as there); metrics gain a leading
    (rounds,) axis."""
    ms = []
    for _ in range(rounds):
        state, m = swarm_round(state, data, cfg, method, steps=steps)
        ms.append(m)
    return state, _stack_metrics(ms)


def run_sweep(states, data: SwarmData, cfg: EngineConfig, sweep: MethodParams, rounds: int):
    """The Table-II axis: row m is exactly ``run_rounds(states[m], data,
    cfg, rounds, sweep_row(sweep, m))``, the rows run one after another
    over the one shared ``data``. ``states`` is a list of per-row states
    (:func:`make_sweep_state`); ``sweep`` the stacked rows
    (:func:`make_sweep_config`). Returns the list of final states and
    the metrics with leading (M, rounds) axes."""
    if len(states) != sweep.use_coord.shape[0]:
        raise ValueError(f"{len(states)} states for {sweep.use_coord.shape[0]} sweep rows")
    finals, ms = [], []
    for m, state in enumerate(states):
        state, mm = run_rounds(state, data, cfg, rounds, sweep_row(sweep, m))
        finals.append(state)
        ms.append(mm)
    return finals, _stack_metrics(ms)


def run_grid(states, data: SwarmData, cfg: EngineConfig, grid: GridPoint, rounds: int,
             schedule=None):
    """A hyper-parameter ablation: row g is exactly ``run_rounds(states[g],
    data, cfg, rounds, grid_row(grid, g))``, the rows run one after
    another over the one shared ``data``. ``states`` is a list of per-row
    states (:func:`make_grid_state`); ``grid`` the stacked rows
    (:func:`make_grid_config`), whose statics in ``cfg`` are the pads.

    ``schedule`` (a tuple of per-row step counts, each in ``[1,
    cfg.local_steps]``, the rows' ``local_steps`` as the caller built
    them) lets row g compute only its ``schedule[g]`` steps instead of
    ``cfg.local_steps`` with the rest selected away. A round still takes
    every draw, so the row keeps its random stream and its result is the
    masked row's. Like the reference, the entries are not read back
    against the rows' tensors (that would be a host sync); an entry
    below a row's ``local_steps`` cuts the row to that many steps.
    Returns the list of final states and the metrics with leading (G,
    rounds) axes."""
    G = grid.lr.shape[0]
    if len(states) != G:
        raise ValueError(f"{len(states)} states for {G} grid rows")
    if schedule is not None:
        schedule = tuple(int(s) for s in schedule)
        if len(schedule) != G:
            raise ValueError(f"schedule has {len(schedule)} entries for {G} grid rows")
        for s in schedule:
            if not 1 <= s <= cfg.local_steps:
                raise ValueError(f"schedule entry {s} outside [1, {cfg.local_steps}]")
    finals, ms = [], []
    for g, state in enumerate(states):
        state, mm = run_rounds(state, data, cfg, rounds, grid_row(grid, g),
                               None if schedule is None else schedule[g])
        finals.append(state)
        ms.append(mm)
    return finals, _stack_metrics(ms)


def copy_state(state: SwarmState) -> SwarmState:
    """A deep copy of ``state``: tensors cloned, generator forked at its
    current position."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return state._replace(params=tree_map(torch.clone, state.params),
                          opt_state=tree_map(torch.clone, state.opt_state),
                          generator=gen, n_samples=state.n_samples.clone())
