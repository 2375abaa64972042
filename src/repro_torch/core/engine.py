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

The **churn axis** (:class:`ChurnParams`, ROADMAP A9): clients drop
out of a round, by a Bernoulli draw at ``dropout`` or by an explicit
``(N,)`` or ``(rounds, N)`` mask. An absent client computes every local
step but keeps its params and optimizer state, is left out of the
k-means seeding, means and reseeds (but still assigned), and does not
receive its cluster's Eq. 2 aggregate; its weight there is
``|D_h| * stale_decay ** staleness`` (``0 ** 0 = 1``), the counter
carried in :attr:`SwarmState.staleness`. The Bernoulli uniforms come
from the state's own ``churn_generator``, never from ``generator``, so
churn leaves every other draw of a round where it was, and a
``dropout=0`` row is bitwise the churn-free row.

The **ragged layout** (:class:`BucketedSwarmData`): clients grouped
into a few size buckets, each padded only to its own largest client.
The sampler gathers the same rows from either layout and eval drops
only all-pad microbatches, so on the CPU a bucketed fit is bitwise the
rectangular one.

The **two-tier coordinator** (:class:`HierParams`, ROADMAP A10): the
swarm is split into pods; each pod runs a local k-means over its
members' stats (:func:`pod_summaries`), and the global tier runs a
member-count-weighted k-means and the brain storm over the
``n_pods * k_local`` pod-cluster summaries (:func:`global_tier`). A
client's cluster is ``g[pod * k_local + a_local]``; Eq. 2 is unchanged.
A one-pod ``HierParams`` is the flat coordinator, draws included.

The **fleet regime** (ROADMAP A11): :func:`make_fleet_round` is the
round a multi-process driver (``repro_torch.launch.fleet_driver``)
calls, a rank's slice of the client axis at a time, with Eq. 2 as
all-reduced segment sums and the coordinator on the host between rounds.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import ModelConfig, SwarmConfig
from repro_torch.core.aggregation import (cluster_fedavg, cluster_fedavg_masked,
                                          singleton_assignments)
from repro_torch.core.bso import BSODraws, brain_storm, draw_bso
from repro_torch.core.diststats import swarm_distribution_matrix
from repro_torch.core.kmeans import kmeans
from repro_torch.data.dr import bucket_clients
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding.rules import (client_view, is_placed, on_shard, place_batch,
                                        use_sharding, write_client)
from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.utils.collectives import mean_over_ranks
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack

# --------------------------------------------------------------------- state


class SwarmState(NamedTuple):
    """The complete mutable state of a swarm."""
    params: Any                      # client-stacked model tree (N, ...)
    opt_state: Any                   # client-stacked optimizer tree
    generator: torch.Generator       # drives sampling, seeding and BSA
    round: int                       # rounds done
    n_samples: torch.Tensor          # (N,) float32 |D_h| (Eq. 2 weights)
    staleness: Any = None            # (N,) int32 rounds since the client
    #                                  last took part (the churn axis)
    churn_generator: Any = None      # torch.Generator of the churn
    #                                  Bernoulli draws alone


class SwarmData(NamedTuple):
    """Device-resident, fixed-shape swarm dataset.

    train:   {"images": (N, n_max, H, W, 3), "labels": (N, n_max)}, or an
             LM's {"tokens", "labels": (N, n_max, seq)};
             clients shorter than n_max are padded with label -1 rows,
             which the sampler never draws.
    train_n: (N,) int64 true train-set sizes, the sampling bound.
    val:     client-stacked eval batches (N, n_batches, batch, ...)
             padded with label -1 rows (see :func:`stack_eval_split`).
    """
    train: Any
    train_n: torch.Tensor
    val: Any


class BucketedSwarmData:
    """Size-bucketed sibling of :class:`SwarmData`: clients grouped into
    a few size buckets (:func:`repro_torch.data.dr.bucket_clients`),
    each bucket padded only to its own largest client.

    train:      tuple of per-bucket batches, bucket b (N_b, n_max_b, ...)
                with label -1 pad rows, which the sampler never draws.
    val:        tuple of per-bucket stacked eval splits, bucket b
                (N_b, n_batches_b, batch, ...) (:func:`stack_eval_split`).
    train_n:    (N,) int64 true train sizes in global client order, the
                sampling bound of :class:`SwarmData`, so a round's draws
                do not depend on the layout.
    client_ids: tuple of per-bucket tuples of client ids (ascending in a
                bucket; together a partition of range(N)).

    The engine dispatches on the layout (:func:`sample_round_batch`,
    :func:`eval_swarm`), so every entry point takes either. Index
    tensors of the gathers and scatters are built once, on ``train_n``'s
    device."""

    def __init__(self, train, val, train_n, client_ids):
        self.train = tuple(train)
        self.val = tuple(val)
        self.train_n = train_n
        self.client_ids = tuple(tuple(int(i) for i in ids) for ids in client_ids)
        dev = train_n.device
        bucket_of, pos_of = _bucket_maps(self.client_ids, train_n.shape[0])
        self.ids = tuple(torch.as_tensor(ids, dtype=torch.int64, device=dev)
                         for ids in self.client_ids)
        self.bucket_of = torch.as_tensor(bucket_of, dtype=torch.int64, device=dev)
        self.pos_of = torch.as_tensor(pos_of, dtype=torch.int64, device=dev)
        # global client order from the buckets' concatenation
        self.inv = torch.argsort(torch.cat(self.ids))

    @property
    def n_buckets(self) -> int:
        return len(self.client_ids)


def _bucket_maps(client_ids, n_clients: int):
    """(bucket, position in the bucket) of every client id, on the host."""
    bucket_of = np.zeros(n_clients, np.int64)
    pos_of = np.zeros(n_clients, np.int64)
    for b, ids in enumerate(client_ids):
        for p, c in enumerate(ids):
            bucket_of[c] = b
            pos_of[c] = p
    return bucket_of, pos_of


class RoundMetrics(NamedTuple):
    """Per-round outputs, all device tensors."""
    mean_val_acc: Any                # () paper Eq. 3 on the val split
    val_acc: Any                     # (N,) per-client val accuracy
    train_loss: Any                  # () mean loss of the last local step
    assignments: Any                 # (N,) int32 post-BSA clusters
    centers: Any                     # (k,) int32 center client ids
    n_replaced: Any                  # () int32 BSA replacement events
    n_swapped: Any                   # () int32 BSA swap events
    present: Any = None              # (N,) bool participation of the
    #                                  round (all ones without churn)


class RoundDraws(NamedTuple):
    """Every random input of one round, for injecting a reference's
    draws. ``batch_idx`` is each client's own rows; ``pool_idx`` the
    global row ids (in ``[0, sum(train_n))``) of a pooled batch, from
    which its per-step client ids follow; only the method path reads
    it, and only for a pooled row. The k-means seeding takes
    ``kmeans_init_idx`` (the seed rows) if given, else the uniforms
    ``kmeans_u``. The coordinator's draws are read only when the round
    runs the coordinator, ``churn_u`` only on a churn row without a mask
    (a round that draws for itself takes it from the state's
    ``churn_generator``). A two-tier round seeds pod p from
    ``pod_kmeans_init_idx[p]`` or ``pod_kmeans_u[p]``, its global tier
    from ``kmeans_init_idx`` or ``kmeans_u`` (k rows of the
    ``P * k_local`` summaries), and its brain storm draws over those
    summary rows."""
    batch_idx: torch.Tensor          # (local_steps, N, B) own train rows
    kmeans_init_idx: Any             # (k,) k-means++ seed rows, or None
    bso: BSODraws                    # brain-storm draws
    pool_idx: Any = None             # (local_steps, N, B) pooled global rows
    kmeans_u: Any = None             # (k,) uniforms of the k-means++ seeding
    churn_u: Any = None              # (N,) float32 uniforms of the churn
    #                                  Bernoulli draw (present: u >= dropout)
    pod_kmeans_init_idx: Any = None  # (P, k_local) pod seed rows (local
    #                                  to each pod), or None
    pod_kmeans_u: Any = None         # (P, k_local) float64 uniforms of the
    #                                  pods' k-means++ seeding


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


class ChurnParams(NamedTuple):
    """One churn row: the scenario axis as () tensors on the swarm's
    device (build it with :func:`churn_params`).

    An absent client computes every local step but keeps its params and
    optimizer state, is left out of the k-means seeding, means and
    reseeds, and keeps its own params through Eq. 2, where its weight is
    ``|D_h| * stale_decay ** staleness``: ``stale_decay = 0`` is the
    hard mask (``0 ** 0 = 1`` keeps present clients whole), above 0
    stale params linger at a decaying weight. ``dropout = 0`` with no
    mask keeps every client, bitwise the churn-free round."""
    dropout: torch.Tensor            # () float32 P(absent) a client a round
    stale_decay: torch.Tensor        # () float32 Eq. 2 staleness decay
    mask: Any = None                 # bool (N,) every round, or a (rounds, N)
    #                                  schedule (run_rounds takes a row a
    #                                  round); overrides the Bernoulli draw


def churn_params(dropout: float = 0.0, stale_decay: float = 0.0, mask=None,
                 device=None) -> ChurnParams:
    """One :class:`ChurnParams` row on ``device``. ``mask`` pins the
    participation: (N,) for every round or a (rounds, N) schedule;
    without it each round drops each client with probability
    ``dropout``."""
    d = float(dropout)
    if not 0.0 <= d <= 1.0:
        raise ValueError(f"dropout={d} outside [0, 1]")
    g = float(stale_decay)
    if not 0.0 <= g <= 1.0:
        raise ValueError(f"stale_decay={g} outside [0, 1]")
    if mask is not None:
        mask = (mask.to(device=device, dtype=torch.bool) if isinstance(mask, torch.Tensor)
                else torch.as_tensor(np.asarray(mask, bool), device=device))
        if mask.dim() not in (1, 2):
            raise ValueError("churn mask must be (N,) or (rounds, N), "
                             f"got shape {tuple(mask.shape)}")
    return ChurnParams(dropout=torch.tensor(d, dtype=torch.float32, device=device),
                       stale_decay=torch.tensor(g, dtype=torch.float32, device=device),
                       mask=mask)


def _churn_row(churn: ChurnParams, g: int) -> ChurnParams:
    return ChurnParams(churn.dropout[g], churn.stale_decay[g],
                       None if churn.mask is None else churn.mask[g])


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
    churn: Any = None                # ChurnParams row, or None (no churn)


def grid_point(cfg: "EngineConfig", n_clients: int, *, method: str = "bso-sl", k=None,
               p1=None, p2=None, local_steps=None, lr=None, dropout=None, stale_decay=None,
               churn_mask=None, device=None) -> GridPoint:
    """One :class:`GridPoint`; a ``None`` knob inherits ``cfg``'s value,
    so the empty spec is the paper point. ``k`` and ``local_steps`` are
    checked against the static maxima here, so the round only sees
    in-range values. Any of ``dropout`` / ``stale_decay`` /
    ``churn_mask`` gives the row a :class:`ChurnParams` (``dropout=0.0``
    is the churn-free anchor); a grid's rows are all churn rows or
    none (:func:`make_grid_config`)."""
    k = cfg.n_clusters if k is None else int(k)
    if not 1 <= k <= cfg.n_clusters:
        raise ValueError(f"grid k={k} outside [1, {cfg.n_clusters}] — "
                         f"cfg.n_clusters is the static pad k_max")
    steps = cfg.local_steps if local_steps is None else int(local_steps)
    if not 1 <= steps <= cfg.local_steps:
        raise ValueError(f"grid local_steps={steps} outside "
                         f"[1, {cfg.local_steps}] — cfg.local_steps is "
                         f"the static step budget")
    churn = None
    if dropout is not None or stale_decay is not None or churn_mask is not None:
        churn = churn_params(0.0 if dropout is None else dropout,
                             0.0 if stale_decay is None else stale_decay, churn_mask,
                             device=device)
    return GridPoint(
        method=method_params(method, n_clients, device),
        n_clusters=torch.tensor(k, dtype=torch.int32, device=device),
        p1=torch.tensor(cfg.p1 if p1 is None else p1, dtype=torch.float32, device=device),
        p2=torch.tensor(cfg.p2 if p2 is None else p2, dtype=torch.float32, device=device),
        local_steps=torch.tensor(steps, dtype=torch.int32, device=device),
        lr=torch.tensor(cfg.lr if lr is None else lr, dtype=torch.float32, device=device),
        churn=churn)


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
    axis. The rows must all be churn rows or all churn-free, and churn
    rows all with a ``churn_mask`` of one shape or all without."""
    rows = [grid_point(cfg, n_clients, device=device, **spec) for spec in specs]
    has_churn = [r.churn is not None for r in rows]
    if any(has_churn) and not all(has_churn):
        raise ValueError(
            "grid rows must be uniformly churn or churn-free (stacking "
            "mixes pytree structures); give the always-on rows "
            "dropout=0.0 — it is the bitwise no-churn anchor")
    churn = None
    if all(has_churn):
        masks = [r.churn.mask for r in rows]
        if any(m is None for m in masks) and not all(m is None for m in masks):
            raise ValueError("grid churn rows must all give a churn_mask or none")
        churn = ChurnParams(*(torch.stack(f) for f in zip(*(r.churn[:2] for r in rows))),
                            mask=None if masks[0] is None else torch.stack(masks))
    return GridPoint(method=MethodParams(*(torch.stack(f) for f in zip(*(r.method for r in rows)))),
                     **{f: torch.stack([getattr(r, f) for r in rows])
                        for f in GridPoint._fields[1:-1]}, churn=churn)


def grid_row(grid: GridPoint, g: int) -> GridPoint:
    """Row ``g`` of a stacked grid config."""
    return GridPoint(sweep_row(grid.method, g), *(t[g] for t in grid[1:-1]),
                     churn=None if grid.churn is None else _churn_row(grid.churn, g))


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


@dataclass(frozen=True)
class HierParams:
    """Static two-tier coordination topology. ``pods`` partitions
    ``range(N)`` into member-id tuples; each pod clusters its members
    into ``k_local`` pod-clusters, and the global tier clusters the
    ``n_pods * k_local`` pod-cluster summaries. Unequal pods are fine. A
    one-pod value routes every round to the flat coordinator verbatim.

    The pods' member-id tensors are built once per device, on it
    (:meth:`pod_index`), so a round gathers with them and never rebuilds
    them from the tuples."""
    pods: tuple                      # tuple[tuple[int, ...], ...]
    k_local: int = 2                 # per-pod local cluster count
    _index: dict = field(default_factory=dict, init=False, repr=False, compare=False,
                         hash=False)

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    def pod_index(self, device) -> tuple:
        """The pods' member ids as int64 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._index:
            self._index[device] = tuple(torch.as_tensor(p, dtype=torch.int64, device=device)
                                        for p in self.pods)
        return self._index[device]


def hier_params(n_clients: int, n_pods: int, k_local: int = 2, pods=None) -> HierParams:
    """A validated :class:`HierParams`: ``n_pods`` contiguous near-equal
    pods (split at ``linspace(0, n_clients, n_pods + 1)``), or the
    explicit ``pods``; ``k_local`` must fit the smallest pod."""
    if pods is None:
        if not 1 <= n_pods <= n_clients:
            raise ValueError(f"n_pods={n_pods} outside [1, {n_clients}]")
        bounds = np.linspace(0, n_clients, n_pods + 1).astype(int)
        pods = tuple(tuple(range(int(a), int(b))) for a, b in zip(bounds[:-1], bounds[1:]))
    else:
        pods = tuple(tuple(int(i) for i in p) for p in pods)
    seen = sorted(i for p in pods for i in p)
    if seen != list(range(n_clients)):
        raise ValueError("pods must partition range(n_clients) — got "
                         f"{len(seen)} member ids for N={n_clients}")
    smallest = min(len(p) for p in pods)
    if not 1 <= int(k_local) <= smallest:
        raise ValueError(f"k_local={k_local} outside [1, {smallest}] "
                         "(the smallest pod bounds the local cluster "
                         "count)")
    return HierParams(pods=pods, k_local=int(k_local))


def resolve_local_steps(swarm: SwarmConfig, clients_data, batch_size: int) -> int:
    """Explicit ``swarm.local_steps``, else ``local_epochs`` over the
    mean clinic size."""
    if swarm.local_steps is not None:
        return swarm.local_steps
    mean_n = float(np.mean([c["n_train"] for c in clients_data]))
    return max(1, swarm.local_epochs * int(np.ceil(mean_n / batch_size)))


# --------------------------------------------------------------- data layout


def make_batch(cfg: ModelConfig, X, y, device) -> dict:
    """``{"images", "labels"}`` for the cnn family, else ``{"tokens",
    "labels"}`` (an LM's (n, seq) token ids and next-token labels)."""
    key = "images" if cfg.family == "cnn" else "tokens"
    return {key: torch.as_tensor(X, device=device),
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


def make_bucketed_swarm_data(cfg: ModelConfig, clients_data, *, eval_batch: int = 64,
                             max_buckets: int = 4, strategy: str = "pow2",
                             device=None) -> BucketedSwarmData:
    """The device-resident :class:`BucketedSwarmData` of the per-clinic
    dicts: clients grouped by train size
    (:func:`repro_torch.data.dr.bucket_clients`), each bucket's train
    stack padded to the bucket's largest client and its eval stack built
    by :func:`stack_eval_split` over the bucket's members."""
    device = resolve_device(device)
    sizes = [len(c["train"][1]) for c in clients_data]
    groups = bucket_clients(sizes, max_buckets=max_buckets, strategy=strategy)
    trains, vals = [], []
    for ids in groups:
        subset = [clients_data[i] for i in ids]
        n_max = max(len(c["train"][1]) for c in subset)
        Xs, ys = [], []
        for c in subset:
            X, y = pad_eval_split(*c["train"], n_max)
            Xs.append(X)
            ys.append(y)
        trains.append(make_batch(cfg, np.stack(Xs), np.stack(ys), device))
        vals.append(stack_eval_split(cfg, subset, "val", batch=eval_batch, device=device))
    train_n = torch.as_tensor(sizes, dtype=torch.int64, device=device)
    return BucketedSwarmData(trains, vals, train_n, groups)


def pad_fraction(data) -> dict:
    """The share of stored train and eval rows that are padding, for
    either layout: ``{"train": f, "eval": f, "total": f, "stored_rows":
    n, "real_rows": n}`` (reads the labels on the host)."""
    if isinstance(data, BucketedSwarmData):
        trains, vals = data.train, data.val
    else:
        trains, vals = (data.train,), (data.val,)
    tr_stored = sum(int(np.prod(t["labels"].shape[:2])) for t in trains)
    tr_real = int(data.train_n.sum())
    ev_stored = ev_real = 0
    for v in vals:
        ev_stored += v["labels"].numel()
        ev_real += int((v["labels"] >= 0).sum())
    stored = tr_stored + ev_stored
    real = tr_real + ev_real
    return {"train": 1.0 - tr_real / tr_stored,
            "eval": 1.0 - ev_real / ev_stored,
            "total": 1.0 - real / stored,
            "stored_rows": stored, "real_rows": real}


#: mixed into a state's seed to seed its churn generator, so that the
#: churn draws are a stream of their own
_CHURN_SEED_TAG = 0x0C


def make_churn_generator(seed: int, device) -> torch.Generator:
    """The churn generator of a state seeded from ``seed``: seeded from
    ``(seed, _CHURN_SEED_TAG)`` through numpy's SeedSequence, so its
    stream shares nothing with the generator seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), _CHURN_SEED_TAG])
                        .generate_state(1)[0]))
    return gen


def make_swarm_state(model: Model, opt: Optimizer, clients_data, seed: int, *,
                     device=None) -> SwarmState:
    """Fresh per-client params and optimizer state, zero staleness, the
    generator (seeded from ``seed``) that drives every later round, and
    the churn generator (:func:`make_churn_generator`)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = tree_stack([model.init(gen) for _ in clients_data])
    opt_state = init_opt_state(opt, params)
    n_samples = torch.as_tensor([c["n_train"] for c in clients_data],
                                dtype=torch.float32, device=device)
    return SwarmState(params=params, opt_state=opt_state, generator=gen, round=0,
                      n_samples=n_samples,
                      staleness=torch.zeros((len(clients_data),), dtype=torch.int32,
                                            device=device),
                      churn_generator=make_churn_generator(seed, device))


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


def draw_round(generator: torch.Generator, train_n, cfg: EngineConfig,
               hier: HierParams = None) -> RoundDraws:
    """Every random input of one round from ``generator``, in one fixed
    order: own rows and pooled rows of each local step, the k-means++
    uniforms, the brain-storm draws. A round takes them all whichever
    branch it runs, so the generator is at the same place after a plain
    round and after the method row that equals it. A multi-pod
    ``hier`` round takes, after the local steps' rows, the (P, k_local)
    pod seeding uniforms, the (k,) global seeding uniforms and the brain
    storm's draws over the ``P * k_local`` summary rows; ``hier=None``
    and a one-pod ``hier`` draw as the flat round."""
    steps = range(cfg.local_steps)
    N, dev = train_n.shape[0], train_n.device
    batch_idx = torch.stack([draw_batch_idx(generator, train_n, cfg.batch_size)
                             for _ in steps])
    pool_idx = torch.stack([draw_pool_idx(generator, train_n, cfg.batch_size)
                            for _ in steps])
    pod_u = None
    if hier is not None and hier.n_pods > 1:
        pod_u = torch.rand((hier.n_pods, hier.k_local), generator=generator, device=dev,
                           dtype=torch.float64)
        N = hier.n_pods * hier.k_local
    kmeans_u = torch.rand((cfg.n_clusters,), generator=generator, device=dev,
                          dtype=torch.float64)
    return RoundDraws(batch_idx=batch_idx, kmeans_init_idx=None,
                      bso=draw_bso(cfg.n_clusters, N, generator, dev),
                      pool_idx=pool_idx, kmeans_u=kmeans_u, pod_kmeans_u=pod_u)


def draw_churn(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """(n,) float32 uniforms of a churn round's Bernoulli draw: client i
    is present when ``u[i] >= dropout``."""
    return torch.rand((n,), generator=generator, device=device, dtype=torch.float32)


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


def _sample_local_bucketed(data: BucketedSwarmData, idx) -> dict:
    """:func:`sample_local_batch` over the buckets: each bucket gathers
    its clients' rows of ``idx`` (N, B), and the concatenation goes back
    to global client order, so the batch is the rectangular one."""
    parts = [sample_local_batch(tr, idx[ids]) for ids, tr in zip(data.ids, data.train)]
    return {k: torch.cat([p[k] for p in parts])[data.inv] for k in parts[0]}


def _gather_bucketed_rows(data: BucketedSwarmData, client, row) -> dict:
    """``train[client, row]`` over the buckets: each bucket gathers every
    (client, row) pair at its (position, row) slot, a lane outside the
    bucket gathering slot (0, 0), and the lanes are where-merged by
    bucket, so the values are the rectangular gather's."""
    b_of, pos = data.bucket_of[client], data.pos_of[client]
    out = None
    for b, tr in enumerate(data.train):
        in_b = b_of == b
        p = torch.where(in_b, pos, 0)
        r = torch.where(in_b, row, 0)
        g = {k: v[p, r] for k, v in tr.items()}
        if out is None:
            out = g
        else:
            out = {k: torch.where(in_b.reshape(in_b.shape + (1,) * (g[k].dim() - in_b.dim())),
                                  g[k], out[k]) for k in g}
    return out


def sample_round_batch(data, own_row, pool_idx=None, pool=None) -> dict:
    """One local step's stacked batch from either layout (a
    :class:`SwarmData` or :class:`BucketedSwarmData`): the plain
    per-client batch when ``pool`` is None (no method row), else the
    method-axis batch. Both layouts gather the same rows."""
    if pool is not None and pool_idx is None:
        raise ValueError("a method row samples through pooled draws: give RoundDraws.pool_idx")
    if isinstance(data, BucketedSwarmData):
        if pool is None:
            return _sample_local_bucketed(data, own_row)
        return _gather_bucketed_rows(data, *swarm_batch_indices(data.train_n, own_row,
                                                                pool_idx, pool))
    if pool is None:
        return sample_local_batch(data.train, own_row)
    return sample_swarm_batch(data.train, data.train_n, own_row, pool_idx, pool)


def _client_where(present, new, old):
    """``new`` for the clients ``present`` (N,) marks, else ``old``."""
    return torch.where(present.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def local_phase(step, params, opt_state, lr, batches, n_active=None, present=None):
    """Local training: for each of ``batches`` (each an (N, B, ...)
    stacked batch), one train step vmapped over the client axis.
    Returns the new params and optimizer state and the (steps,) mean
    client loss of each step.

    ``n_active`` (a () integer tensor, or None) is the grid row's step
    count: every step computes, and steps ``>= n_active`` leave params
    and optimizer state as they were, selected on the device (so
    applying every step is the plain path, bitwise).

    ``present`` (an (N,) bool tensor, or None) is the churn axis: every
    client computes every step, an absent client's params and optimizer
    state are selected back, and a step's loss is the mean over present
    clients. It is written ``mean(loss * p) * (N / max(sum(p), 1))`` so
    that all ones round as ``torch.mean`` does on any device: the same
    addends, then a multiply by exactly 1.0."""
    vstep = vmap(step, in_dims=(0, 0, 0, None))
    if present is not None:
        pf = present.float()
        scale = pf.shape[0] / torch.clamp(torch.sum(pf), min=1.0)
    losses = []
    for i, batch in enumerate(batches):
        new_params, new_opt, m = vstep(params, opt_state, batch, lr)
        if n_active is not None:
            on = n_active > i
            new_params = tree_map(lambda new, old: torch.where(on, new, old), new_params, params)
            new_opt = tree_map(lambda new, old: torch.where(on, new, old), new_opt, opt_state)
        if present is None:
            params, opt_state = new_params, new_opt
            losses.append(torch.mean(m["loss"]))
        else:
            params = tree_map(lambda new, old: _client_where(present, new, old), new_params, params)
            opt_state = tree_map(lambda new, old: _client_where(present, new, old), new_opt,
                                 opt_state)
            losses.append(torch.mean(m["loss"] * pf) * scale)
    return params, opt_state, torch.stack(losses)


def _full(x):
    """A DTensor's whole value as a plain tensor; a plain tensor as is."""
    return x.full_tensor() if is_placed(x) else x


def local_phase_placed(step, params, opt_state, lr, batches, mesh, rules, present=None):
    """:func:`local_phase` on a placed stack (DTensor leaves on ``mesh``
    whose client axis is whole, the fleet's ``spmd="auto"`` layout): the
    unvmapped train step on each client in turn, its params and optimizer
    state placed by the table, its batch (plain, whole on every rank)
    split on its batch axis by ``rules``. ``torch.func.vmap`` does not
    keep a DTensor's placements through the model (its batching rules
    fold the client axis into split axes). Each client's result is
    written into one new stack placed as the input (a copy of it under
    ``present``, where an absent client's slot keeps its value), which
    later steps read and write in place: a client's slot is read only by
    its own step, and one client's transients live at a time. The loss
    and the ``present`` selection are :func:`local_phase`'s."""
    n = tree_leaves(params)[0].shape[0]
    if present is not None:
        pf = present.float()
        scale = pf.shape[0] / torch.clamp(torch.sum(pf), min=1.0)
    fresh = torch.empty_like if present is None else torch.clone
    out_p = tree_map(lambda x: on_shard(fresh, x), params)
    out_o = tree_map(lambda x: on_shard(fresh, x), opt_state)
    src_p, src_o = params, opt_state
    losses = []
    for batch in batches:
        loss_c = []
        for c in range(n):
            keep = None if present is None else present[c]
            pc, oc, m = step(tree_map(lambda x: client_view(x, c), src_p),
                             tree_map(lambda x: client_view(x, c), src_o),
                             place_batch({k: v[c] for k, v in batch.items()}, mesh, rules), lr)
            tree_map(lambda dst, x: write_client(dst, c, x, keep), out_p, pc)
            tree_map(lambda dst, x: write_client(dst, c, x, keep), out_o, oc)
            loss_c.append(_full(m["loss"]).detach())
            del pc, oc, m
        src_p, src_o = out_p, out_o
        loss = torch.stack(loss_c)
        losses.append(torch.mean(loss) if present is None else torch.mean(loss * pf) * scale)
    return out_p, out_o, torch.stack(losses)


def make_client_eval_placed(model: Model, mesh, rules):
    """:func:`make_client_eval` on a placed stack: one client and one
    microbatch at a time, its batch split on its batch axis as
    :func:`local_phase_placed` splits a train batch."""
    eval_step = make_eval_step(model)

    def client_eval(params, batches):
        n, n_batches = batches["labels"].shape[:2]
        accs = []
        for c in range(n):
            pc = tree_map(lambda x: client_view(x, c), params)
            hits = tot = 0.0
            for j in range(n_batches):
                bt = {k: v[c, j] for k, v in batches.items()}
                acc = _full(eval_step(pc, place_batch(bt, mesh, rules))["acc"])
                valid = torch.sum(bt["labels"] >= 0).float()
                hits = hits + acc * valid
                tot = tot + valid
            accs.append(hits / torch.clamp(tot, min=1.0))
        return torch.stack(accs)

    return client_eval


def make_client_eval(model: Model):
    """Per-client masked accuracy over stacked (N, n_batches, batch, ...)
    eval data: one vmapped eval per microbatch, adding acc * valid so a
    padded microbatch counts only its real labels (rows of a CNN batch,
    tokens of an LM's (batch, seq) labels)."""
    veval = vmap(make_eval_step(model))

    def client_eval(params, batches):
        n_batches = batches["labels"].shape[1]
        hits = tot = 0.0
        for j in range(n_batches):
            bt = {k: v[:, j] for k, v in batches.items()}
            m = veval(params, bt)
            valid = torch.sum((bt["labels"] >= 0).flatten(1), dim=1).float()
            hits = hits + m["acc"] * valid
            tot = tot + valid
        return hits / torch.clamp(tot, min=1.0)

    return client_eval


def eval_swarm(model: Model, params, data) -> torch.Tensor:
    """(N,) per-client val accuracy, from either layout. Bucketed: one
    eval of each bucket's clients on the bucket's stack, scattered back
    to client order. A bucket's stack is a prefix of the rectangular
    one's microbatches, and a dropped all-pad microbatch adds exactly
    0.0 to hits and totals, so on the CPU this is the rectangular
    result bitwise."""
    client_eval = make_client_eval(model)
    if not isinstance(data, BucketedSwarmData):
        return client_eval(params, data.val)
    acc = torch.zeros(data.train_n.shape, dtype=torch.float32, device=data.train_n.device)
    for ids, val in zip(data.ids, data.val):
        acc[ids] = client_eval(tree_map(lambda t: t[ids], params), val)
    return acc


# ---------------------------------------------------------------- the round


def _coordinate(params, val, cfg: EngineConfig, draws: RoundDraws, grid: GridPoint = None,
                present=None):
    """Distribution upload -> k-means -> brain storm over the swarm:
    (assignments, centers, n_replaced, n_swapped). A grid row runs them
    at the pad ``cfg.n_clusters`` with its ``n_clusters`` live and its
    ``p1`` / ``p2``; a churn round's ``present`` masks the k-means."""
    if draws.kmeans_init_idx is None and draws.kmeans_u is None:
        raise ValueError("RoundDraws needs kmeans_init_idx or kmeans_u for the coordinator")
    k_active, p1, p2 = ((None, cfg.p1, cfg.p2) if grid is None
                        else (grid.n_clusters, grid.p1, grid.p2))
    feats = swarm_distribution_matrix(params)
    _, a0 = kmeans(feats, cfg.n_clusters, cfg.kmeans_iters, init_idx=draws.kmeans_init_idx,
                   u=draws.kmeans_u, k_active=k_active, mask=present)
    return brain_storm(a0, val, cfg.n_clusters, p1, p2, draws=draws.bso)


def _aggregate(cfg: EngineConfig, params, opt_state, assignments, n_samples, k: int,
               present=None, eff_w=None):
    """Eq. 2 over ``k`` segments, then the optimizer reset if ``cfg``
    asks for it. A churn round (``present`` and ``eff_w``, its effective
    weights) runs the masked Eq. 2 and resets only present clients."""
    if present is None:
        params = cluster_fedavg(params, assignments, n_samples, k=k)
    else:
        params = cluster_fedavg_masked(params, assignments, eff_w, present, k=k)
    if cfg.reset_opt_each_round:
        new_opt = init_opt_state(cfg.opt, params)
        opt_state = new_opt if present is None else tree_map(
            lambda new, old: _client_where(present, new, old), new_opt, opt_state)
    return params, opt_state


def _coordinate_and_aggregate(params, opt_state, val, n_samples, cfg: EngineConfig,
                              masks: MethodParams, draws: RoundDraws, grid: GridPoint = None,
                              present=None, eff_w=None):
    """The method- and grid-axis tail of :func:`swarm_round`: the
    coordinator (stats, k-means, brain storm; masked to the grid row's
    clusters and the churn round's present clients) always runs, then
    the row's ``use_coord`` picks its assignments or ``base_assign``,
    and Eq. 2 runs over N segments (so the identity plan, the global
    plan and the coordinator's clusters share one layout). Returns
    ``(params, opt_state, assignments, centers, n_replaced,
    n_swapped)``."""
    N = n_samples.shape[0]
    if cfg.n_clusters > N:
        raise ValueError(f"the method axis needs n_clusters <= n_clients, got "
                         f"{cfg.n_clusters} > {N}")
    bsa_a, bsa_c, n_rep, n_swap = _coordinate(params, val, cfg, draws, grid, present)
    use = masks.use_coord
    zero = torch.zeros((), dtype=torch.int32, device=val.device)
    assignments = torch.where(use, bsa_a, masks.base_assign.to(bsa_a.dtype))
    centers = torch.where(use, bsa_c, -1)
    n_rep = torch.where(use, n_rep, zero)
    n_swap = torch.where(use, n_swap, zero)
    params, opt_state = _aggregate(cfg, params, opt_state, assignments, n_samples, N,
                                   present, eff_w)
    return params, opt_state, assignments, centers, n_rep, n_swap


def pod_summaries(feats, val, weights, present, k_local: int, kmeans_iters: int, pods, *,
                  init_idx=None, u=None):
    """The pod tier of the two-tier coordinator: a k-means over each
    pod's members' ``feats`` rows (masked by their ``present`` slice
    under churn), reduced to ``P * k_local`` summary rows.

    ``pods`` holds each pod's member ids as int64 tensors on feats'
    device, as :meth:`HierParams.pod_index` gives them; the loop over
    pods runs on the host, a pod's k-means at its own size. Pod p is
    seeded from ``init_idx[p]`` (k_local rows local to the pod) or the
    uniforms ``u[p]``.

    Returns ``(centroids (P*kl, F), counts (P*kl,), wsums (P*kl,),
    valsums (P*kl,), pc_of (N,) int32)``: ``counts`` are present member
    counts, ``wsums`` the sums of the members' Eq. 2 ``weights``,
    ``valsums`` of their val scores, and ``pc_of`` maps each client,
    absent ones too, to its summary row ``p * k_local + a_local``."""
    if init_idx is None and u is None:
        raise ValueError("pod_summaries needs the pods' seed rows (init_idx) or uniforms (u)")
    N, dev = val.shape[0], val.device
    kl = int(k_local)
    cents = []
    pc_of = torch.zeros((N,), dtype=torch.int32, device=dev)
    for p, idx in enumerate(pods):
        C_p, a_p = kmeans(feats.index_select(0, idx), kl, kmeans_iters,
                          init_idx=None if init_idx is None else init_idx[p],
                          u=None if u is None else u[p],
                          mask=None if present is None else present.index_select(0, idx))
        cents.append(C_p)
        pc_of.index_copy_(0, idx, a_p + p * kl)
    w = (torch.ones((N,), dtype=feats.dtype, device=dev) if present is None
         else present.to(feats.dtype))
    pc = pc_of.long()
    S = len(cents) * kl

    def seg_sum(x):
        return torch.zeros((S,), dtype=feats.dtype, device=dev).index_add_(0, pc, x)

    return torch.cat(cents), seg_sum(w), seg_sum(weights * w), seg_sum(val * w), pc_of


def global_tier(centroids, counts, valsums, *, k: int, kmeans_iters: int, p1, p2,
                init_idx=None, u=None, bso: BSODraws = None):
    """The global tier of the two-tier coordinator, over the summary
    rows: a k-means weighted by the member ``counts`` (seeded from
    ``init_idx`` or ``u``), then the brain storm (draws ``bso``) ranking
    the pod-clusters' mean val scores. An empty pod-cluster weighs 0 in
    the k-means and scores -1.0, so it never wins a best-val center and
    moves no client when it is swapped. Returns ``(g (S,) pod-cluster
    -> global cluster, centers_s (k,) best summary rows or -1,
    n_replaced, n_swapped)``."""
    val_means = torch.where(counts > 0, valsums / torch.clamp(counts, min=1e-9), -1.0)
    _, g0 = kmeans(centroids, k, kmeans_iters, init_idx=init_idx, u=u, weights=counts)
    return brain_storm(g0, val_means, k, p1, p2, draws=bso)


def _hier_coordinate_and_aggregate(params, opt_state, val, n_samples, cfg: EngineConfig,
                                   hier: HierParams, draws: RoundDraws, present=None,
                                   eff_w=None):
    """The two-tier coordinator and Eq. 2 tail of :func:`swarm_round`:
    pod tier, global tier, client assignments ``g[pc_of]``, then the
    unchanged Eq. 2 over N segments. A center is its summary row's
    best-val present member, or -1 for an empty row. Returns
    ``(params, opt_state, assignments, centers, n_replaced,
    n_swapped)``."""
    if draws.pod_kmeans_init_idx is None and draws.pod_kmeans_u is None:
        raise ValueError("a two-tier round needs RoundDraws.pod_kmeans_init_idx or "
                         "pod_kmeans_u (draw_round(..., hier) draws them)")
    if draws.kmeans_init_idx is None and draws.kmeans_u is None:
        raise ValueError("RoundDraws needs kmeans_init_idx or kmeans_u for the coordinator")
    N = n_samples.shape[0]
    S = hier.n_pods * hier.k_local
    dev = val.device
    feats = swarm_distribution_matrix(params)
    centroids, counts, _, valsums, pc_of = pod_summaries(
        feats, val, n_samples if eff_w is None else eff_w, present, hier.k_local,
        cfg.kmeans_iters, hier.pod_index(dev), init_idx=draws.pod_kmeans_init_idx,
        u=draws.pod_kmeans_u)
    g, centers_s, n_rep, n_swap = global_tier(
        centroids, counts, valsums, k=cfg.n_clusters, kmeans_iters=cfg.kmeans_iters,
        p1=cfg.p1, p2=cfg.p2, init_idx=draws.kmeans_init_idx, u=draws.kmeans_u,
        bso=draws.bso)
    pc = pc_of.long()
    assignments = g[pc]
    member = pc[None, :] == torch.arange(S, device=dev)[:, None]   # (S, N)
    if present is not None:
        member = member & present[None, :]
    score = torch.where(member, val[None, :], -torch.inf)
    rep = torch.where(member.any(dim=1), torch.argmax(score, dim=1).int(), -1)
    centers = torch.where(centers_s >= 0, rep[torch.clamp(centers_s, 0, S - 1).long()], -1)
    params, opt_state = _aggregate(cfg, params, opt_state, assignments, n_samples, N,
                                   present, eff_w)
    return params, opt_state, assignments, centers, n_rep, n_swap


def _check_hier(hier: HierParams, masks, cfg: EngineConfig, N: int):
    """The reference's refusals of a two-tier round; returns the
    ``hier`` the round runs, None for one pod (the flat coordinator)."""
    if masks is not None:
        raise ValueError(
            "hier composes with the plain path only — the "
            "method/grid axes mask against the flat coordinator's "
            "assignments; run hierarchical rows as separate "
            "run_rounds fits")
    if cfg.aggregation != "bso":
        raise ValueError(
            f"hier needs cfg.aggregation='bso' (got "
            f"{cfg.aggregation!r}) — fedavg/none have no "
            "coordinator to shard")
    if hier.n_pods == 1:
        # one pod is the whole swarm: the flat coordinator, verbatim
        return None
    covered = sum(len(p) for p in hier.pods)
    if covered != N:
        raise ValueError(f"hier pods cover {covered} clients but the swarm has {N}")
    if cfg.n_clusters > hier.n_pods * hier.k_local:
        raise ValueError(f"hier global tier needs n_clusters={cfg.n_clusters} <= "
                         f"n_pods*k_local={hier.n_pods * hier.k_local} summary rows")
    return hier


def _check_grid_device(grid: GridPoint, dev) -> None:
    """A grid row's tensors must live on the swarm's device: the round
    reads them there and never on the host."""
    named = [*zip(MethodParams._fields, grid.method), *zip(GridPoint._fields[1:-1], grid[1:-1])]
    if grid.churn is not None:
        named += [(f"churn.{f}", t) for f, t in zip(ChurnParams._fields, grid.churn)
                  if t is not None]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"GridPoint.{name} is on {t.device} but the swarm is on {dev}; "
                             "build the grid with device=")


def _churn_presence(state: SwarmState, churn: ChurnParams, draws, N: int, dev):
    """A churn round's (present, staleness, effective Eq. 2 weights):
    ``present`` from the row's mask, else ``u >= dropout`` on float32
    uniforms (``draws.churn_u``, or drawn from the state's churn
    generator when the round draws for itself)."""
    if state.staleness is None:
        raise ValueError(
            "the churn axis needs SwarmState.staleness — rebuild "
            "the state with make_swarm_state (or _replace a zeros "
            "(N,) int32 field onto a pre-churn state)")
    if churn.mask is not None:
        present = churn.mask.to(device=dev, dtype=torch.bool)
        if present.dim() != 1:
            raise ValueError(
                "swarm_round wants a per-round (N,) churn mask; "
                "run_rounds scans (rounds, N) schedules")
    else:
        if draws is not None:
            if draws.churn_u is None:
                raise ValueError("a churn row without a mask needs RoundDraws.churn_u")
            u = draws.churn_u.to(device=dev, dtype=torch.float32)
        elif state.churn_generator is None:
            raise ValueError("a churn row without a mask draws from SwarmState.churn_generator; "
                             "build the state with make_swarm_state")
        else:
            u = draw_churn(state.churn_generator, N, dev)
        present = u >= churn.dropout
    staleness = torch.where(present, torch.zeros_like(state.staleness), state.staleness + 1)
    # |D_h| * decay ** staleness: a present client multiplies by
    # decay ** 0 == 1.0 (bitwise |D_h|), and the hard mask (decay 0)
    # zeroes every absent one (0 ** s == 0 for s > 0)
    eff_w = state.n_samples * torch.pow(churn.stale_decay, staleness.float())
    return present, staleness, eff_w


def swarm_round(state: SwarmState, data, cfg: EngineConfig, method=None,
                draws: RoundDraws = None, steps: int = None, churn: ChurnParams = None,
                hier: HierParams = None):
    """One full BSO-SL round: local steps, eval, distribution upload,
    k-means, brain storm, Eq. 2 aggregation. ``data`` is a
    :class:`SwarmData` or a :class:`BucketedSwarmData`.

    ``method`` puts the round on a traced axis: a :class:`MethodParams`
    row (the Table-II axis; see :func:`_coordinate_and_aggregate`) or a
    :class:`GridPoint` (the grid axis: the method masks plus the row's
    k, p1, p2, local-step and lr overrides of the ``cfg`` statics, which
    are its pads). None keeps the static ``cfg.aggregation`` branches
    (``none`` skips the coordinator). Random inputs come from ``draws``
    when given, else from ``state.generator`` through
    :func:`draw_round`: a round takes every draw of ``cfg.local_steps``
    steps whatever the row applies.

    ``churn`` (a :class:`ChurnParams` row with an (N,) mask or none;
    else a GridPoint's own ``churn``) puts the round on the churn axis
    on any of those paths (see :class:`ChurnParams`): the round's
    participation is in ``RoundMetrics.present`` and the new staleness
    in the state. Its Bernoulli uniforms are ``draws.churn_u``, or come
    from ``state.churn_generator``, which nothing else reads.

    ``steps`` (a grid row only) computes just the first ``steps`` local
    steps, so the row applies ``min(local_steps, steps)`` of them; at
    ``steps == local_steps`` (see :func:`run_grid`) the result is the
    masked path's.

    ``hier`` (a :class:`HierParams`) puts the plain bso round on the
    two-tier coordinator (see :func:`_hier_coordinate_and_aggregate`);
    it composes with ``churn`` and either data layout, and refuses a
    method or grid row and any other aggregation. One pod is the flat
    round, bitwise."""
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
        if churn is None:
            churn = grid.churn
    elif steps is not None:
        raise ValueError("steps= applies to a GridPoint row only")
    if hier is not None:
        hier = _check_hier(hier, masks, cfg, N)
    present = staleness = eff_w = None
    if churn is not None:
        present, staleness, eff_w = _churn_presence(state, churn, draws, N, dev)
    if draws is None:
        draws = draw_round(state.generator, data.train_n, cfg, hier)

    # --- local phase (a grid row applies only its first local_steps; an
    # absent client none)
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
                                            n_active, present)
    # the last applied step's loss, read on the device
    train_loss = (losses[-1] if grid is None else losses.index_select(
        0, (torch.clamp(n_active, max=n_run) - 1).long().reshape(1))[0])

    # --- eval: per-client val accuracy (shared within clusters, §III.C);
    # an absent client is scored on its stale params, the score the
    # coordinator kept from its last round
    val = eval_swarm(model, params, data)

    # --- coordinator + aggregation
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if masks is not None:
        params, opt_state, assignments, centers, n_rep, n_swap = _coordinate_and_aggregate(
            params, opt_state, val, state.n_samples, cfg, masks, draws, grid, present, eff_w)
    elif hier is not None:
        params, opt_state, assignments, centers, n_rep, n_swap = _hier_coordinate_and_aggregate(
            params, opt_state, val, state.n_samples, cfg, hier, draws, present, eff_w)
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
            assignments, centers, n_rep, n_swap = _coordinate(params, val, cfg, draws,
                                                              present=present)
        params, opt_state = _aggregate(cfg, params, opt_state, assignments, state.n_samples, k,
                                       present, eff_w)

    new_state = state._replace(params=params, opt_state=opt_state, round=state.round + 1,
                               staleness=state.staleness if churn is None else staleness)
    metrics = RoundMetrics(mean_val_acc=torch.mean(val), val_acc=val,
                           train_loss=train_loss, assignments=assignments,
                           centers=centers, n_replaced=n_rep, n_swapped=n_swap,
                           present=(torch.ones((N,), dtype=torch.bool, device=dev)
                                    if present is None else present))
    return new_state, metrics


def _stack_metrics(ms) -> RoundMetrics:
    return RoundMetrics(*(torch.stack(f) for f in zip(*ms)))


def run_rounds(state: SwarmState, data, cfg: EngineConfig, rounds: int,
               method=None, steps: int = None, churn: ChurnParams = None,
               hier: HierParams = None, draws=None):
    """``rounds`` calls of :func:`swarm_round` (on the method or grid row
    ``method``, if given; ``steps`` as there); metrics gain a leading
    (rounds,) axis. ``churn`` (or the grid row's own) goes to every
    round; a (rounds, N) mask schedule gives round r its row r. ``hier``
    puts every round on the two-tier coordinator. ``draws``, a list of
    :class:`RoundDraws`, injects round r's random inputs as ``draws[r]``."""
    if churn is None and isinstance(method, GridPoint):
        churn = method.churn
    schedule = None
    if churn is not None and churn.mask is not None and churn.mask.dim() == 2:
        if churn.mask.shape[0] != rounds:
            raise ValueError(
                f"churn mask schedule has {churn.mask.shape[0]} rows "
                f"for rounds={rounds}")
        schedule = churn.mask
    ms = []
    for r in range(rounds):
        if schedule is not None:
            churn = churn._replace(mask=schedule[r])
        state, m = swarm_round(state, data, cfg, method, steps=steps, churn=churn, hier=hier,
                               draws=None if draws is None else draws[r])
        ms.append(m)
    return state, _stack_metrics(ms)


def run_sweep(states, data, cfg: EngineConfig, sweep: MethodParams, rounds: int):
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


def run_grid(states, data, cfg: EngineConfig, grid: GridPoint, rounds: int,
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
    below a row's ``local_steps`` cuts the row to that many steps. Churn
    rows refuse a schedule, as the reference's do. Returns the list of
    final states and the metrics with leading (G, rounds) axes."""
    G = grid.lr.shape[0]
    if len(states) != G:
        raise ValueError(f"{len(states)} states for {G} grid rows")
    if schedule is not None:
        if grid.churn is not None:
            raise ValueError(
                "the sorted local-steps schedule does not support churn "
                "rows (its prefix segments assume every row trains every "
                "client); pass schedule=None — churn grids ride the "
                "masked path")
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


def _fork(gen):
    if gen is None:
        return None
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def copy_state(state: SwarmState) -> SwarmState:
    """A deep copy of ``state``: tensors cloned, generators forked at
    their current positions."""
    return state._replace(params=tree_map(torch.clone, state.params),
                          opt_state=tree_map(torch.clone, state.opt_state),
                          generator=_fork(state.generator), n_samples=state.n_samples.clone(),
                          staleness=None if state.staleness is None else state.staleness.clone(),
                          churn_generator=_fork(state.churn_generator))


# ------------------------------------------------------------- fleet regime


class FleetRoundOut(NamedTuple):
    """What a fleet round hands the coordinator: O(clients), the models
    never leave their ranks (paper §III.B). On a rank, the local slice."""
    stats: Any        # (N, 2*#tensors) distribution upload of the
    #                   post-local-phase params (§III.B)
    val_acc: Any      # (N,) per-client masked val accuracy, the scores
    #                   the brain storm ranks (§III.C step 1)
    train_loss: Any   # () mean loss of the last local step, over all ranks


class HierRoundOut(NamedTuple):
    """The two-tier fleet round's outputs: O(pods). Each pod's k-means
    runs in the round, and only the ``S = n_pods * k_local`` pod-cluster
    summaries go to the coordinator. ``a_local`` stays on the device as
    the next round's ``a_prev``. On a rank (one pod), its own rows."""
    centroids: Any    # (S, 2*#tensors) pod-cluster stat centroids
    counts: Any       # (S,) reporting-member counts (the global tier's weights)
    wsums: Any        # (S,) summed member Eq. 2 weights
    valsums: Any      # (S,) summed member val accuracies
    a_local: Any      # (N,) int32 global pod-cluster row of each client
    mean_val: Any     # () swarm-mean val accuracy, over all ranks
    train_loss: Any   # () mean loss of the last local step, over all ranks


def _seed_kw(seeds, p: int) -> dict:
    """``kmeans`` seeding of pod ``p`` from a (pods, k_local) operand:
    integer rows are seed rows (``init_idx``), floating ones uniforms."""
    row = seeds[p]
    return {"init_idx": row} if not row.is_floating_point() else {"u": row}


def make_fleet_round(model: Model, opt: Optimizer, k: int, n_local_steps: int = 1, *,
                     with_eval: bool = False, with_loss: bool = False, group=None,
                     with_churn: bool = False, hier_k_local: int = 0, hier_pods: int = 0,
                     hier_kmeans_iters: int = 20, inner=None, rules=None):
    """The fleet round (counterpart of the reference's
    ``make_fleet_round``): the sim round's pieces reordered so that a
    driver closes the coordinator loop between calls. First Eq. 2 applies
    the *incoming* decision ``clusters`` over ``k`` segments, then
    :func:`local_phase` trains on per-step microbatches of the uploaded
    round ``batch`` (N, n_b, ...): ``mb = min(n_b, ceil(n_b / steps))``
    rows, step i from row ``min(i * mb, n_b - mb)``, then the stat upload
    :func:`~repro_torch.core.diststats.swarm_distribution_matrix` (one
    ``param_stats`` launch on the card). Round 0 fed singletons makes
    its Eq. 2 the identity, so R rounds run the sim protocol with the
    last Eq. 2 pending.

    ``group`` puts the round on a rank's local slice of the client axis:
    Eq. 2 is :func:`~repro_torch.core.aggregation.cluster_fedavg` (or its
    masked variant) all-reduced over ``group``, and the loss and mean val
    are averaged over the ranks. ``group=None`` keeps the whole stack on
    one process (the reference's ``axis_name=None``).

    Surfaces, as the reference's:

    - plain: ``round_step(sparams, sopt, batch, lr, clusters, weights)
      -> (sparams, sopt, stats)``;
    - ``with_eval``: ``round_step(sparams, sopt, batch, val, lr,
      clusters, weights) -> (sparams, sopt, FleetRoundOut)``, val
      accuracies of the post-local-phase params (:func:`make_client_eval`);
    - ``with_loss`` (exclusive with ``with_eval``): the plain signature,
      returning ``(sparams, sopt, stats, loss)``; the bucketed-eval
      driver scores the clients itself;
    - ``with_churn`` appends ``(present, agg_present)`` (N,) bool:
      ``agg_present`` gates who receives the incoming Eq. 2 (the masked
      variant, the effective weights in ``weights``), ``present`` masks
      the local phase. All-ones masks are the churn-free round bitwise;
    - ``hier_k_local > 0`` (exclusive with both): ``round_step(sparams,
      sopt, batch, val, lr, g, use_composed, clusters0, a_prev, kmseed,
      weights[, present, agg_present, report]) -> (sparams, sopt,
      HierRoundOut)``. The incoming decision is ``where(use_composed,
      g[a_prev], clusters0)``, built on the device. Each pod runs a
      ``k_local``-means over its members' stats (masked by ``report``
      under churn, which also masks the summary sums) through the
      ``kmeans_assign`` kernel, as :func:`pod_summaries` does. ``kmseed``
      (pods, k_local) seeds them, one row a pod: integer rows are seed
      rows, floating ones k-means++ uniforms (they replace the
      reference's key ``kmkey``). With ``group`` this rank is one pod,
      pod index = rank; with ``group=None`` the stack is ``hier_pods``
      equal contiguous pods.

    ``inner`` (a ``DeviceMesh`` of the ranks that hold the same clients,
    with the placement table's ``rules``) is the placed layout of
    ``swarm_fleet.fleet_setup(spmd="auto")``: ``sparams`` and ``sopt``
    are DTensors on ``inner`` whose client axis is whole
    (``sharding.rules.distribute_stacked``), every other operand is plain
    and whole on each rank of ``inner``. Eq. 2 sums each rank's shards
    and all-reduces them over ``group``; the local phase and the eval run
    one client at a time (:func:`local_phase_placed`), each client's batch
    split over ``inner`` by ``rules``; the stat upload merges the shards'
    statistics over ``inner``. The round runs under ``use_sharding(inner,
    rules)``.
    """
    if with_eval and with_loss:
        raise ValueError("with_eval and with_loss are exclusive round surfaces")
    step = make_train_step(model, opt)
    placed = inner is not None

    def pmean(x):
        return x if group is None else mean_over_ranks(x, group)

    def run_local(sparams, sopt, lr, batches, present):
        if placed:
            return local_phase_placed(step, sparams, sopt, lr, batches, inner, rules,
                                      present=present)
        return local_phase(step, sparams, sopt, lr, batches, present=present)

    def eval_fn():
        return make_client_eval_placed(model, inner, rules) if placed else make_client_eval(model)

    def surface(fn):
        if not placed:
            return fn

        def round_step(*args):
            from torch.distributed.tensor.experimental import implicit_replication
            with implicit_replication(), use_sharding(inner, rules):
                return fn(*args)

        return round_step

    def body(sparams, sopt, batch, lr, clusters, weights, present=None, agg_present=None):
        # Eq. 2 on the incoming (previous-round) coordinator decision
        sparams = (cluster_fedavg(sparams, clusters, weights, k=k, group=group)
                   if agg_present is None else
                   cluster_fedavg_masked(sparams, clusters, weights, agg_present, k=k,
                                         group=group))
        # ceil-sized microbatches with a clamped last start cover every
        # row (an indivisible batch overlaps at the tail)
        n_b = batch["labels"].shape[1]
        mb = min(n_b, -(-n_b // n_local_steps))
        starts = [min(i * mb, n_b - mb) for i in range(n_local_steps)]
        batches = ({key: v[:, s:s + mb].contiguous() for key, v in batch.items()}
                   for s in starts)
        sparams, sopt, losses = run_local(sparams, sopt, lr, batches, present)
        return sparams, sopt, swarm_distribution_matrix(sparams), losses

    def churn_kw(masks):
        if not with_churn:
            return {}
        return {"present": masks[0], "agg_present": masks[1]}

    if hier_k_local > 0:
        if with_eval or with_loss:
            raise ValueError("hier_k_local selects its own eval surface — drop "
                             "with_eval/with_loss")
        kl = int(hier_k_local)
        client_eval = eval_fn()

        def pod_summary(stats, val_acc, weights, report, seed_kw, pod_idx):
            C, a = kmeans(stats, kl, hier_kmeans_iters, mask=report, **seed_kw)
            w = (torch.ones(stats.shape[:1], dtype=stats.dtype, device=stats.device)
                 if report is None else report.to(stats.dtype))
            al = a.long()

            def seg(x):
                return torch.zeros((kl,), dtype=stats.dtype, device=stats.device).index_add_(
                    0, al, x)

            return C, seg(w), seg(weights * w), seg(val_acc * w), pod_idx * kl + a

        def round_step_hier(sparams, sopt, batch, val, lr, g, use_comp, clusters0, a_prev,
                            kmseed, weights, *masks):
            report = masks[2] if with_churn else None
            clusters = torch.where(use_comp, g[a_prev.long()], clusters0)
            sparams, sopt, stats, losses = body(sparams, sopt, batch, lr, clusters, weights,
                                                **churn_kw(masks))
            val_acc = client_eval(sparams, val)
            loss, mean_val = pmean(losses[-1]), pmean(torch.mean(val_acc))
            if group is not None:
                pod = torch.distributed.get_rank(group)
                outs = [pod_summary(stats, val_acc, weights, report, _seed_kw(kmseed, 0), pod)]
            else:
                n_loc = stats.shape[0]
                P = int(hier_pods)
                if P <= 0 or n_loc % P:
                    raise ValueError(
                        "the stacked hier surface needs hier_pods to divide the client count "
                        f"into equal contiguous pods (hier_pods={P}, clients={n_loc})")
                m = n_loc // P
                outs = [pod_summary(stats[p * m:(p + 1) * m], val_acc[p * m:(p + 1) * m],
                                    weights[p * m:(p + 1) * m],
                                    None if report is None else report[p * m:(p + 1) * m],
                                    _seed_kw(kmseed, p), p) for p in range(P)]
            C, counts, wsums, valsums, pc = (torch.cat(f) for f in zip(*outs))
            return sparams, sopt, HierRoundOut(centroids=C, counts=counts, wsums=wsums,
                                               valsums=valsums, a_local=pc.to(torch.int32),
                                               mean_val=mean_val, train_loss=loss)

        return surface(round_step_hier)

    if with_eval:
        client_eval = eval_fn()

        def round_step_eval(sparams, sopt, batch, val, lr, clusters, weights, *masks):
            sparams, sopt, stats, losses = body(sparams, sopt, batch, lr, clusters, weights,
                                                **churn_kw(masks))
            val_acc = client_eval(sparams, val)
            return sparams, sopt, FleetRoundOut(stats=stats, val_acc=val_acc,
                                                train_loss=pmean(losses[-1]))

        return surface(round_step_eval)

    if with_loss:

        def round_step_loss(sparams, sopt, batch, lr, clusters, weights, *masks):
            sparams, sopt, stats, losses = body(sparams, sopt, batch, lr, clusters, weights,
                                                **churn_kw(masks))
            return sparams, sopt, stats, pmean(losses[-1])

        return surface(round_step_loss)

    def round_step(sparams, sopt, batch, lr, clusters, weights, *masks):
        sparams, sopt, stats, _ = body(sparams, sopt, batch, lr, clusters, weights,
                                       **churn_kw(masks))
        return sparams, sopt, stats

    return surface(round_step)
