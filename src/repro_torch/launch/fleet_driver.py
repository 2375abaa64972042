"""End-to-end multi-round BSO-SL in the fleet regime (counterpart of
``repro.launch.fleet_driver``).

The swarm is split over the ranks of a :class:`~repro_torch.launch.mesh
.FleetMesh`, each holding an equal contiguous slice of the clients. The
round step is built once a run (``swarm_fleet.fleet_setup``), and the
driver closes the paper's coordinator loop for R rounds:

  1. every rank runs the round on its slice: Eq. 2 on the incoming
     decision (segment sums all-reduced over the mesh's group), local
     SGD on the uploaded round batch, the val eval and the stat upload
     (the ``param_stats`` kernel on the card);
  2. the O(clients) :class:`~repro_torch.core.engine.FleetRoundOut`
     (stats and val scores) is gathered to rank 0 and pulled to the
     host;
  3. rank 0 runs the coordinator, k-means on the stats (the
     ``kmeans_assign`` kernel on the card) and the numpy brain storm,
     and broadcasts the (N,) decision that the next round's Eq. 2
     applies.

The round aggregates first, so R rounds run the sim engine's protocol
(train, eval, stats, coordinator, Eq. 2) with the last Eq. 2 pending.
Parity with ``engine.run_rounds`` is statistical: the fleet samples its
batches on the host and its coordinator draws from numpy streams.

Random streams, all numpy ``default_rng`` seeded from lists: batch rows
``[seed, r, client]``, faults ``[seed, r, 0xFA, 0x17]``, the brain storm
``[seed, r]`` (the reference's), the coordinator's k-means++ uniforms
``[seed, r, 0xC0, 0x3D]`` and pod p's ``[seed, r, 0xC0, 0x3E, p]``. The
last two replace the reference's JAX keys, so a decision is the same on
the card and on the CPU and replays from the pulled stats. Every rank
draws the batches of its own clients and the whole fault schedule, so
only the decision travels between rounds.

Run on the CPU with spawned gloo ranks, or on a card (one NCCL rank)::

    PYTHONPATH=src python -m repro_torch.launch.fleet_driver --device cpu --ranks 2 --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.fleet_driver --rounds 3
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import OptimizerConfig, get_config
from repro_torch.core.aggregation import (cluster_fedavg, cluster_fedavg_masked,
                                          singleton_assignments)
from repro_torch.core.bso import brain_storm_host
from repro_torch.core.engine import init_opt_state, make_batch, make_client_eval, stack_eval_split
from repro_torch.core.kmeans import kmeans
from repro_torch.data.dr import bucket_clients, make_dr_swarm_data, scale_table
from repro_torch.launch.comm import fleet_round_comm, hier_round_comm
from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh, spawn_cpu_ranks
from repro_torch.launch.swarm_fleet import fleet_setup
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.collectives import CENSUS, broadcast_from_root, gather_to_root
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack

# ------------------------------------------------------- host coordinator

# the coordinator's k-means++ uniforms and each pod's: 4- and 5-element
# seeds, apart from the batch rows' [seed, r, i], the faults' [seed, r,
# 0xFA, 0x17] and the brain storm's [seed, r] (a list seed with trailing
# zeros equals the shorter one, so no tag ends in a 0)
_COORD_STREAM_TAG = (0xC0, 0x3D)
_POD_STREAM_TAG = (0xC0, 0x3E)


def coordinator_uniforms(seed: int, round_idx: int, k: int) -> np.ndarray:
    """(k,) float64 k-means++ uniforms of round ``round_idx``'s coordinator."""
    return np.random.default_rng([seed, round_idx, *_COORD_STREAM_TAG]).random(k)


def pod_uniforms(seed: int, round_idx: int, pods, k_local: int) -> np.ndarray:
    """(len(pods), k_local) float64 k-means++ uniforms of the in-round
    k-means of each pod in ``pods``."""
    return np.stack([np.random.default_rng([seed, round_idx, *_POD_STREAM_TAG, int(p)])
                     .random(k_local) for p in pods])


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def host_coordinator(stats, val_acc, *, k: int, p1: float, p2: float, kmeans_iters: int = 20,
                     seed: int = 0, round_idx: int = 0, init_idx=None):
    """The paper's neighbour-assignment server. k-means on ``stats`` (a
    tensor runs on its device, the ``kmeans_assign`` kernel on a card;
    an array on the CPU), seeded from the uniforms
    :func:`coordinator_uniforms` or the injected seed rows ``init_idx``
    (how a test hands over the reference's), then the numpy brain storm
    on ``default_rng([seed, round_idx])``. Deterministic in ``(stats,
    val_acc, seed, round_idx)``, so replaying a round's pulled stats
    reproduces its decision. Returns ``(assignments, centers, events)``:
    the (N,) int32 decision the next round's Eq. 2 applies, the (k,)
    center client ids and the event log."""
    X = _as_tensor(stats).float()
    u = torch.as_tensor(coordinator_uniforms(seed, round_idx, k), device=X.device)
    _, a0 = kmeans(X, k, kmeans_iters, u=u,
                   init_idx=None if init_idx is None else _as_tensor(init_idx, X.device))
    plan = brain_storm_host(np.random.default_rng([seed, round_idx]), _np(a0), _np(val_acc),
                            k, p1, p2)
    return plan.assignments.astype(np.int32), plan.centers.astype(np.int32), plan.events


def _hier_val_means(counts, valsums):
    """Per-summary-row mean val accuracy; an empty row (a pod-cluster
    with no reporting client) gets -1.0, never a center."""
    counts = np.asarray(counts, np.float32)
    return np.where(counts > 0,
                    np.asarray(valsums, np.float32) / np.maximum(counts, np.float32(1e-9)),
                    np.float32(-1.0)).astype(np.float32)


def host_hier_coordinator(centroids, counts, valsums, *, k: int, p1: float, p2: float,
                          kmeans_iters: int = 20, seed: int = 0, round_idx: int = 0,
                          init_idx=None):
    """The two-tier coordinator's global tier, O(pods): a k-means over
    the ``S`` pod-cluster centroids weighted by their reporting-member
    ``counts`` (seeded as :func:`host_coordinator`'s), then the numpy
    brain storm over the rows' mean val scores (empty rows -1.0).
    Returns ``(g, centers, events)``: the (S,) pod-cluster -> global
    cluster map the next round composes as ``g[a_local]``, and the (k,)
    center summary rows."""
    X = _as_tensor(centroids).float()
    w = _as_tensor(counts, X.device).float()
    u = torch.as_tensor(coordinator_uniforms(seed, round_idx, k), device=X.device)
    _, a0 = kmeans(X, k, kmeans_iters, u=u, weights=w,
                   init_idx=None if init_idx is None else _as_tensor(init_idx, X.device))
    plan = brain_storm_host(np.random.default_rng([seed, round_idx]), _np(a0),
                            _hier_val_means(_np(counts), _np(valsums)), k, p1, p2)
    return plan.assignments.astype(np.int32), plan.centers.astype(np.int32), plan.events


# -------------------------------------------------------- fault injection

_FAULT_STREAM_TAG = (0xFA, 0x17)


@dataclass(frozen=True)
class FleetFaults:
    """Host-side fault injection for :func:`run_fleet`.

    ``drop_rate``      per-round probability that a client drops: no
                       local phase, no report, zero (or decayed) weight
                       in the next Eq. 2.
    ``straggler_rate`` probability that a present client straggles: it
                       trains, but its report misses the deadline (the
                       coordinator falls back to its last-seen stats).
    ``delay_s``        each straggler's simulated lateness, logged as
                       ``sim_delay_s``, never slept.
    ``stale_decay``    λ of the staleness-weighted Eq. 2: an absent
                       client keeps weight |D_h|·λ^staleness (λ = 0 is
                       the hard mask; 0^0 == 1 keeps fresh clients whole).
    ``quorum``         the coordinator recomputes the decision only when
                       at least Q clients report; below, the previous
                       decision is applied again (``coordinated=False``).

    The draws are deterministic in ``(seed, round_idx)``."""
    drop_rate: float = 0.0
    straggler_rate: float = 0.0
    delay_s: float = 0.0
    stale_decay: float = 0.0
    quorum: int = 0

    @property
    def active(self) -> bool:
        return self.drop_rate > 0 or self.straggler_rate > 0 or self.quorum > 0


def draw_faults(faults: FleetFaults, n_clients: int, seed: int, round_idx: int):
    """One round's ``(present, straggler)`` bool (N,) arrays; stragglers
    are drawn among present clients only."""
    rng = np.random.default_rng([seed, round_idx, *_FAULT_STREAM_TAG])
    present = rng.random(n_clients) >= faults.drop_rate
    straggler = present & (rng.random(n_clients) < faults.straggler_rate)
    return present, straggler


# ------------------------------------------------------------- the driver


@dataclass
class FleetRoundLog:
    """One driver round. The host-side fields (``stats``, ``val_acc``,
    ``centers``, ``events``, the two-tier ``counts`` / ``valsums``) are
    rank 0's; another rank holds None there (its ``mean_val_acc`` is NaN
    on the flat surfaces), and the decision, which every rank receives."""
    round: int
    mean_val_acc: float                # Eq. 3 over the val split
    val_acc: Optional[np.ndarray]      # (N,)
    train_loss: float
    stats: Optional[np.ndarray]        # (N, 2*#tensors) §III.B upload
    assignments: np.ndarray            # (N,) decision FROM this round's stats
    centers: np.ndarray                # (k,) BSA center client ids
    applied_clusters: np.ndarray       # (N,) decision fed INTO this round
    events: List[str]
    wall_s: float                      # sample, upload, round and stat pull
    coord_s: float                     # the coordinator and the decision's broadcast
    present: Optional[np.ndarray] = None
    reported: Optional[np.ndarray] = None
    staleness: Optional[np.ndarray] = None
    coordinated: bool = True
    sim_delay_s: float = 0.0
    # the two-tier surface: ``stats`` holds the (S, 2*#tensors)
    # centroids, ``val_acc`` / ``assignments`` / ``centers`` are per
    # summary row, and these complete the pulled upload
    counts: Optional[np.ndarray] = None
    valsums: Optional[np.ndarray] = None


@dataclass
class FleetRunResult:
    history: List[FleetRoundLog]
    n_compiles: int                    # round and eval step functions built:
    #                                    1, plus one a size bucket
    comm: dict                         # per-round ledger (launch.comm)
    params: Any                        # this rank's final client-stacked params
    opt_state: Any = None              # and its optimizer state
    meta: dict = field(default_factory=dict)

    @property
    def mean_val_accs(self):
        return [r.mean_val_acc for r in self.history]


def make_unit_fleet(n_clients: int = 8, *, arch: str = "squeezenet-dr", image_size: int = 16,
                    data_scale: int = 16, seed: int = 0, lr: float = 2e-3, device=None,
                    backend=None):
    """Unit-scale fleet: the first ``n_clients`` Table-I clinics.
    Returns ``(model, opt, mesh, clients_data)``, what :func:`run_fleet`
    takes; ``device`` and ``backend`` go to :func:`make_fleet_mesh`."""
    table = scale_table(data_scale)[:, :n_clients]
    clients = make_dr_swarm_data(image_size=image_size, seed=seed, table=table)
    model = build_model(get_config(arch))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=lr))
    return model, opt, make_fleet_mesh(len(clients), backend=backend, device=device), clients


def _sample_round_batch(model_cfg, clients_data, n_rows: int, seed: int, round_idx: int, *,
                        ids=None, device="cpu"):
    """The round's batch upload: client i draws ``n_rows``
    uniform-with-replacement rows of its train split from
    ``default_rng([seed, round_idx, i])``, stacked (len(ids), n_rows,
    ...) for the clients ``ids`` (all by default) on ``device``."""
    ids = range(len(clients_data)) if ids is None else ids
    Xs, ys = [], []
    for i in ids:
        rng = np.random.default_rng([seed, round_idx, i])
        X, y = clients_data[i]["train"]
        idx = rng.integers(0, len(y), size=n_rows)
        Xs.append(X[idx])
        ys.append(y[idx])
    return make_batch(model_cfg, np.stack(Xs), np.stack(ys), device)


def _gather_tree(tree, mesh: FleetMesh):
    """The whole client stack of every leaf on rank 0 (None elsewhere)."""
    if mesh is None or mesh.world == 1:
        return tree
    out = tree_map(lambda x: gather_to_root(x, mesh.group, "export"), tree)
    return out if mesh.rank == 0 else None


def export_fleet_checkpoint(path, model, sparams, clusters, weights, *, round_idx: int,
                            n_clusters: int, mean_val_acc: float = 0.0, present=None,
                            mesh: FleetMesh = None):
    """Save the swarm for ``repro_torch.serve``: apply the pending Eq. 2
    (the aggregation the next round would run; with ``present``, the
    masked one with ``weights`` as the effective weights), then write the
    client-stacked tree with a manifest ``extra`` that rebuilds the model
    with no training code (the ``ModelConfig``, client count, |D_h|
    weights, the decision). ``clusters`` / ``weights`` / ``present`` are
    the global (N,) arrays. On several ranks the client slices are
    gathered to rank 0, which writes while the others wait at a barrier.
    Returns the aggregated stack that was written (None off rank 0)."""
    full = _gather_tree(sparams, mesh)
    if full is not None:
        dev = tree_leaves(full)[0].device
        N = len(np.asarray(clusters))
        a = torch.as_tensor(np.asarray(clusters, np.int32), device=dev)
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        if present is None:
            agg = cluster_fedavg(full, a, w, k=N)
        else:
            agg = cluster_fedavg_masked(full, a, w, torch.as_tensor(np.asarray(present, bool),
                                                                     device=dev), k=N)
        save_checkpoint(path, agg, step=round_idx + 1, extra={
            "model_config": dataclasses.asdict(model.cfg),
            "n_clients": int(N),
            "client_weights": np.asarray(weights, np.float32).tolist(),
            "assignments": np.asarray(clusters, np.int32).tolist(),
            "n_clusters": int(n_clusters),
            "mean_val_acc": float(mean_val_acc),
        })
    else:
        agg = None
    if mesh is not None and mesh.world > 1:
        dist.barrier(group=mesh.group)
    return agg


def run_fleet(model, opt, mesh: FleetMesh, clients_data, *, rounds: int, local_steps: int = 4,
              batch_size: int = 8, lr: float = 2e-3, n_clusters: int = 3, p1: float = 0.9,
              p2: float = 0.8, kmeans_iters: int = 20, seed: int = 0, eval_batch: int = 64,
              eval_buckets: int = 0, bucket_strategy: str = "pow2", ckpt_path=None,
              ckpt_every: int = 0, faults: Optional[FleetFaults] = None,
              hier_k_local: int = 0, state=None, verbose: bool = False) -> FleetRunResult:
    """Drive ``rounds`` BSO-SL rounds on ``mesh`` with one round step.
    Every rank of the mesh calls this with the same arguments.

    Every client's params are initialised from one CPU generator seeded
    with ``seed`` and each rank keeps its slice, so a run is the same on
    any device and any rank count; ``state`` (``(params, opt_state)``,
    the whole client stack on any device, e.g. a result's) resumes from
    it instead. Round 0 applies singletons (Eq. 2 is the identity),
    round r the decision taken from round r-1's stats.

    ``eval_buckets > 0`` scores the val split by size bucket
    (``data.dr.bucket_clients`` on the val sizes), each rank its own
    clients with the bucket's stack padded to the bucket's ceiling, and
    the round is built ``with_loss``; on the CPU the scores are the
    rectangular eval's bitwise.

    ``faults`` (any knob active) puts the run on the churn regime with
    the same round step built ``with_churn``: per-round drops and
    stragglers, the quorum rule, staleness-decayed Eq. 2 weights, and
    rank 0's last-seen report cache for stragglers. Round r's incoming
    Eq. 2 uses round r-1's presence and post-round staleness.

    ``hier_k_local > 0`` (exclusive with ``eval_buckets``) is the
    two-tier regime: each rank is a pod whose k-means runs in the round,
    only the O(pods * k_local) summaries reach rank 0, and
    :func:`host_hier_coordinator` answers with the (S,) map ``g``.
    ``a_local`` stays on the device as the next round's ``a_prev``; it
    is composed to (N,) only at a checkpoint export. Under ``faults`` a
    straggler's stats sit out the round (the in-round ``report`` mask);
    there is no last-seen cache on this surface.

    ``ckpt_path`` exports the final state (and every ``ckpt_every``
    rounds to ``{ckpt_path}_r{r}``); with ``rounds=0`` it warns and
    exports the initial swarm under the identity Eq. 2."""
    N = len(clients_data)
    if n_clusters > N:
        raise ValueError(f"n_clusters={n_clusters} > n_clients={N}")
    hier = hier_k_local > 0
    bucketed = eval_buckets > 0
    if hier and bucketed:
        raise ValueError("hier_k_local and eval_buckets are exclusive driver regimes (the hier "
                         "round carries its own in-program eval)")
    n_pods = mesh.world if hier else 0
    S = n_pods * hier_k_local
    if hier and n_clusters > S:
        raise ValueError(
            f"n_clusters={n_clusters} > pods*k_local={S}: the global tier clusters the summary "
            "rows — raise hier_k_local or use more pods")
    if N % mesh.world:
        raise ValueError(f"{mesh.world} ranks do not divide {N} clients")
    churn = faults is not None and faults.active
    program = fleet_setup(model, opt, mesh, k=N, n_local_steps=local_steps,
                          with_eval=not bucketed and not hier, with_loss=bucketed,
                          with_churn=churn, hier_k_local=hier_k_local)
    dev, root = mesh.device, mesh.rank == 0
    n_loc = N // mesh.world
    lo = mesh.rank * n_loc
    sl = slice(lo, lo + n_loc)

    def put(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    if state is None:
        gen = torch.Generator().manual_seed(seed)
        sparams = tree_map(lambda x: x[sl].contiguous().to(dev),
                           tree_stack([model.init(gen) for _ in range(N)]))
        sopt = init_opt_state(opt, sparams)
    else:
        sparams, sopt = (tree_map(lambda x: x[sl].to(dev, copy=True).contiguous(), t)
                         for t in state)
    params_abs = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                          sparams)

    eval_progs = []
    n_buckets = 0
    if bucketed:
        groups = bucket_clients([len(c["val"][1]) for c in clients_data],
                                max_buckets=eval_buckets, strategy=bucket_strategy)
        n_buckets = len(groups)
        ev = make_client_eval(model)
        for ids in groups:
            mine = [j for j, i in enumerate(ids) if lo <= i < lo + n_loc]
            if not mine:
                continue
            val_b = stack_eval_split(model.cfg, [clients_data[i] for i in ids], "val",
                                     batch=eval_batch, device=dev)
            pick = torch.as_tensor(mine, device=dev)
            eval_progs.append((torch.as_tensor([ids[j] - lo for j in mine], device=dev),
                               {key: v[pick] for key, v in val_b.items()}))
        val = None
    else:
        val = {key: v[sl] for key, v in stack_eval_split(model.cfg, clients_data, "val",
                                                          batch=eval_batch, device=dev).items()}
    base_w = np.asarray([c["n_train"] for c in clients_data], np.float32)
    weights = put(base_w[sl])
    clusters = _np(singleton_assignments(N)).astype(np.int32)
    if hier:
        clusters0_dev = put(clusters[sl])
        a_prev = torch.zeros((n_loc,), dtype=torch.int32, device=dev)
        g = np.zeros(S, np.int32)

    staleness = np.zeros(N, np.int32)
    prev_present = np.ones(N, bool)
    have_cache = np.zeros(N, bool)
    last_stats, last_val = None, None
    centers = np.full(n_clusters, -1, np.int32)

    def eff_weights():
        return base_w * np.power(np.float32(faults.stale_decay), staleness.astype(np.float32))

    def put_batch(r):
        return _sample_round_batch(model.cfg, clients_data, local_steps * batch_size, seed, r,
                                   ids=range(lo, lo + n_loc), device=dev)

    def decide(values, n: int):
        """Rank 0's decision and centers on every rank, one broadcast."""
        buf = (torch.as_tensor(np.concatenate(values).astype(np.int32), device=dev) if root
               else torch.zeros((n + n_clusters,), dtype=torch.int32, device=dev))
        out = _np(broadcast_from_root(buf, mesh.group))
        return out[:n], out[n:]

    comm = None
    history = []
    for r in range(rounds):
        mark = CENSUS.mark()
        t0 = time.perf_counter()
        batch = put_batch(r)
        if comm is None:
            batch_bytes = mesh.world * sum(x.numel() * x.element_size() for x in batch.values())
        applied = g.copy() if hier else clusters
        masks = ()
        present = straggler = reported = None
        if churn:
            present, straggler = draw_faults(faults, N, seed, r)
            reported = present & ~straggler
            # the incoming Eq. 2 is the previous round's pending one: last
            # round's presence receives, last round's staleness decays
            weights = put(eff_weights()[sl])
            masks = (put(present[sl]), put(prev_present[sl]))
            if hier:
                masks = masks + (put(reported[sl]),)
        stats = val_acc = counts = valsums = None
        hier_mean_val = float("nan")
        if hier:
            seeds = put(pod_uniforms(seed, r, [mesh.rank], hier_k_local))
            sparams, sopt, out = program.step(sparams, sopt, batch, val, lr, put(applied),
                                              put(np.bool_(r > 0)), clusters0_dev, a_prev,
                                              seeds, weights, *masks)
            a_prev = out.a_local
            stats_t = gather_to_root(out.centroids, mesh.group)
            counts_t = gather_to_root(out.counts, mesh.group)
            valsums_t = gather_to_root(out.valsums, mesh.group)
            if root:
                stats, counts, valsums = _np(stats_t), _np(counts_t), _np(valsums_t)
                val_acc = _hier_val_means(counts, valsums)
            train_loss, hier_mean_val = float(out.train_loss), float(out.mean_val)
        elif bucketed:
            sparams, sopt, stats_dev, loss_dev = program.step(sparams, sopt, batch, lr,
                                                              put(applied[sl]), weights, *masks)
            val_loc = torch.zeros((n_loc,), dtype=torch.float32, device=dev)
            for pos, val_b in eval_progs:
                val_loc[pos] = ev(tree_map(lambda x: x[pos], sparams), val_b)
            stats_t = gather_to_root(stats_dev, mesh.group)
            val_t = gather_to_root(val_loc, mesh.group)
            if root:
                stats, val_acc = _np(stats_t), _np(val_t)
            train_loss = float(loss_dev)
        else:
            sparams, sopt, out = program.step(sparams, sopt, batch, val, lr, put(applied[sl]),
                                              weights, *masks)
            stats_t = gather_to_root(out.stats, mesh.group)
            val_t = gather_to_root(out.val_acc, mesh.group)
            if root:
                stats, val_acc = _np(stats_t), _np(val_t)
            train_loss = float(out.train_loss)
        t1 = time.perf_counter()
        coordinated = True
        events: List[str] = []
        n_rep = N
        if churn:
            staleness = np.where(present, 0, staleness + 1).astype(np.int32)
            prev_present = present
            n_rep = int(reported.sum())
        stats_used, val_used = stats, val_acc
        if churn and not hier and root:
            # a late or dropped client's report falls back to its last-seen
            # one; the cache takes this round's reports whether or not the
            # quorum is met
            stats_used, val_used = stats.copy(), val_acc.copy()
            if last_stats is not None:
                miss = ~reported & have_cache
                stats_used[miss] = last_stats[miss]
                val_used[miss] = last_val[miss]
            else:
                last_stats, last_val = np.zeros_like(stats), np.zeros_like(val_acc)
            last_stats[reported] = stats[reported]
            last_val[reported] = val_acc[reported]
            have_cache |= reported
        quorum_miss = churn and faults.quorum and n_rep < faults.quorum
        if quorum_miss:
            # the previous decision again (round 0's singletons included);
            # the coordinator's streams are not drawn for this round
            coordinated = False
            what = "pod-cluster map" if hier else "cluster decision"
            events = [f"quorum miss: {n_rep}/{N} reported < Q={faults.quorum}; previous "
                      f"{what} re-applied"]
        elif hier:
            if root:
                g_new, centers, events = host_hier_coordinator(
                    stats_t, counts_t, valsums_t, k=n_clusters, p1=p1, p2=p2,
                    kmeans_iters=kmeans_iters, seed=seed, round_idx=r)
            g, centers = decide((g_new, centers) if root else None, S)
        else:
            if root:
                a_new, centers, events = host_coordinator(
                    put(stats_used), val_used, k=n_clusters, p1=p1, p2=p2,
                    kmeans_iters=kmeans_iters, seed=seed, round_idx=r)
            clusters, centers = decide((a_new, centers) if root else None, N)
        t2 = time.perf_counter()
        if comm is None:
            entries = CENSUS.since(mark)
            comm = (hier_round_comm(entries, params_abs, N, n_pods=n_pods, k_local=hier_k_local,
                                    batch_bytes=batch_bytes) if hier else
                    fleet_round_comm(entries, params_abs, N, batch_bytes=batch_bytes))
        log = FleetRoundLog(
            round=r,
            mean_val_acc=hier_mean_val if hier or not root else float(val_acc.mean()),
            val_acc=val_acc, train_loss=train_loss, stats=stats,
            assignments=g.copy() if hier else clusters, centers=centers,
            applied_clusters=applied, events=list(events), wall_s=t1 - t0, coord_s=t2 - t1,
            present=present, reported=reported,
            staleness=staleness.copy() if churn else None, coordinated=coordinated,
            sim_delay_s=float(faults.delay_s) if churn and bool(straggler.any()) else 0.0,
            counts=counts, valsums=valsums)
        history.append(log)
        if ckpt_path and ckpt_every and (r + 1) % ckpt_every == 0:
            export_fleet_checkpoint(
                f"{ckpt_path}_r{r + 1}", model, sparams, _composed(g, a_prev, mesh) if hier
                else clusters, eff_weights() if churn else base_w, round_idx=r,
                n_clusters=n_clusters, mean_val_acc=log.mean_val_acc,
                present=present if churn else None, mesh=mesh)
        if verbose and root:
            flag = "" if coordinated else " [quorum miss]"
            decision = g if hier else clusters
            print(f"[fleet] round {r}: val_acc={log.mean_val_acc:.3f} "
                  f"loss={log.train_loss:.3f} "
                  f"clusters={np.bincount(decision, minlength=n_clusters)}"
                  f" events={len(events)} wall={log.wall_s:.2f}s{flag}")

    if comm is None:
        comm = (hier_round_comm([], params_abs, N, n_pods=n_pods, k_local=hier_k_local)
                if hier else fleet_round_comm([], params_abs, N))
    if ckpt_path:
        if history:
            export_fleet_checkpoint(
                ckpt_path, model, sparams,
                _composed(g, a_prev, mesh) if hier else history[-1].assignments,
                eff_weights() if churn else base_w, round_idx=rounds - 1,
                n_clusters=n_clusters, mean_val_acc=history[-1].mean_val_acc,
                present=prev_present if churn else None, mesh=mesh)
        else:
            warnings.warn(
                "run_fleet(rounds=0) with ckpt_path: no rounds executed — exporting the initial "
                "(untrained) swarm params under the singleton identity Eq. 2", stacklevel=2)
            export_fleet_checkpoint(ckpt_path, model, sparams, clusters, base_w, round_idx=-1,
                                    n_clusters=n_clusters, mean_val_acc=0.0, mesh=mesh)
    meta = dict(n_clients=N, rounds=rounds, local_steps=local_steps, batch_size=batch_size,
                lr=lr, n_clusters=n_clusters, p1=p1, p2=p2, seed=seed,
                mesh_shape=dict(mesh.shape), n_devices=mesh.world, backend=mesh.backend,
                eval_buckets=n_buckets,
                hier=None if not hier else {"k_local": hier_k_local, "n_pods": n_pods,
                                            "summary_rows": S},
                faults=None if faults is None else dataclasses.asdict(faults))
    return FleetRunResult(history=history, n_compiles=1 + n_buckets, comm=comm, params=sparams,
                          opt_state=sopt, meta=meta)


def _composed(g, a_prev, mesh: FleetMesh):
    """The (N,) decision ``g[a_local]`` of the two-tier surface, from
    every rank's device-resident ``a_local`` (a gather to rank 0; the
    other ranks get a placeholder they do not use)."""
    a = gather_to_root(a_prev, mesh.group, "export")
    if a is None:
        return np.zeros(mesh.world * a_prev.shape[0], np.int32)
    return np.asarray(g)[_np(a)]


def _run_cli(args):
    model, opt, mesh, clients = make_unit_fleet(args.clients, image_size=args.image_size,
                                                data_scale=args.data_scale, seed=args.seed,
                                                device=args.device)
    try:
        faults = FleetFaults(drop_rate=args.drop_rate, straggler_rate=args.straggler_rate,
                             delay_s=args.straggler_delay, stale_decay=args.stale_decay,
                             quorum=args.quorum)
        res = run_fleet(model, opt, mesh, clients, rounds=args.rounds,
                        local_steps=args.local_steps, batch_size=args.batch_size, seed=args.seed,
                        eval_buckets=args.eval_buckets, ckpt_path=args.ckpt,
                        ckpt_every=args.ckpt_every, faults=faults if faults.active else None,
                        hier_k_local=args.hier_k, verbose=True)
        if mesh.rank == 0:
            if args.ckpt:
                print(f"[fleet] checkpoint -> {args.ckpt}.npz")
            coll = res.comm["eq2_collective_bytes"]["total"]
            if args.hier_k:
                what = (f"summary upload {res.comm['summary_upload_bytes']} B "
                        f"({res.comm['summary_rows']} rows) to rank 0")
            else:
                what = f"stat upload {res.comm['stat_upload_bytes']} B to rank 0"
            print(f"[fleet] {res.meta['n_clients']} clients on {res.meta['n_devices']} "
                  f"{res.meta['backend']} ranks ({mesh.device}), {args.rounds} rounds, "
                  f"{res.n_compiles} round step; per round: {what}, Eq. 2 collectives "
                  f"{coll} B a rank")
        return res
    finally:
        mesh.close()


def _cli_rank(rank: int, args):
    _run_cli(args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--data-scale", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the ranks (default: cuda; 'cpu' for gloo ranks)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="CPU ranks spawned over gloo (the reference's --devices stand-in); "
                         "a card runs one NCCL rank")
    ap.add_argument("--eval-buckets", type=int, default=0,
                    help="bucket the val eval into at most this many size buckets "
                         "(0 = rectangular in-round eval)")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="export the final aggregated swarm params (npz + manifest)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="also export every N rounds (PATH_r<N>)")
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--straggler-rate", type=float, default=0.0)
    ap.add_argument("--straggler-delay", type=float, default=0.0)
    ap.add_argument("--stale-decay", type=float, default=0.0)
    ap.add_argument("--quorum", type=int, default=0)
    ap.add_argument("--hier-k", type=int, default=0,
                    help="per-pod local k-means cluster count: > 0 switches onto the two-tier "
                         "O(pods) coordinator (0 = flat O(clients))")
    args = ap.parse_args(argv)
    if args.ranks > 1:
        if resolve_device(args.device).type != "cpu":
            raise ValueError("--ranks > 1 spawns CPU ranks over gloo; a card runs one NCCL rank")
        spawn_cpu_ranks(_cli_rank, args.ranks, args)
        return None
    return _run_cli(args)


if __name__ == "__main__":
    main()
