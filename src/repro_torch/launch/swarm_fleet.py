"""Fleet-regime BSO-SL: the round step of a multi-process fleet
(counterpart of ``repro.launch.swarm_fleet``).

:func:`fleet_setup` builds the round step once a run over the same body,
``engine.make_fleet_round``, in one of two layouts:

- ``spmd="shard_map"`` (``repro_torch.launch.fleet_driver``'s):
  a :class:`~repro_torch.launch.mesh.FleetMesh`, each rank a contiguous
  slice of the client axis, Eq. 2 an all-reduced segment sum over the
  mesh's group. Clients are single-device sized (the paper's CNNs).
- ``spmd="auto"`` (the LM fleet, "swarm on pods"): a ``("pod", "data",
  "model")`` ``DeviceMesh`` (``launch.mesh.make_pod_mesh``). ``pod`` is
  the client axis, as an explicit process group: each pod holds a
  contiguous slice of the clients (one a pod in production), and Eq. 2's
  segment sums and the round's means are all-reduced over it. Inside a
  pod each client's model is placed on the ``("data", "model")`` sub-mesh
  by the table with ``pod`` dropped (:func:`fleet_inner_rules`): params
  and optimizer state are DTensors, a client's batch is split over
  ``data``, and DTensor issues the FSDP / tensor-parallel collectives.
  The reference partitions the whole round with GSPMD over the three
  axes; DTensor plans a train step on three mesh dimensions in tens of
  minutes, so the client axis stays an explicit group.

The stat upload is computed in the round (the ``param_stats`` kernel on
the card; on placed leaves over each rank's shards, merged over the pod's
ranks), and the coordinator stays on the host between rounds. The
reference's ``use_pallas_stats`` switch has no counterpart: a CUDA
tensor takes the kernel and a CPU tensor its plain version.

:func:`lower_fleet_round` is the LM fleet's dry-run: one round step of
granite-3-2b on the 2x16x16 mesh under a fake process group of 512
ranks, on ``meta`` tensors, through the census of ``launch.dryrun``
(the reference lowers and compiles it for 512 TPU devices).
``force_host_device_count`` has no counterpart: the fake process group
takes its place. Run it with::

    PYTHONPATH=src python -m repro_torch.launch.swarm_fleet --arch granite-3-2b
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.engine import make_fleet_round
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import POD_MESH_AXES, FleetMesh, make_pod_mesh
from repro_torch.models.model import abstract_params, build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding.rules import (DEFAULT_LOGICAL_TO_PHYSICAL, AxisRules,
                                        distribute_stacked, mesh_group, place_batch)
from repro_torch.utils.collectives import CENSUS
from repro_torch.utils.tree import tree_leaves, tree_map

SPMD_MODES = ("shard_map", "auto")


def fleet_inner_rules() -> AxisRules:
    """Per-client placement rules: ``pod`` is the client axis of the
    fleet, so a client's own placement never consumes it."""
    return AxisRules({k: tuple(a for a in v if a != "pod")
                      for k, v in DEFAULT_LOGICAL_TO_PHYSICAL.items()})


class FleetProgram(NamedTuple):
    """The one round step of a fleet run and the mesh it was built on.
    On the ``"auto"`` layout also the inner rules and the ``("data",
    "model")`` sub-mesh that place a client (the reference's ``rules``
    and ``in_shardings``): :meth:`place` puts a client-stacked tree on it."""
    step: Any            # engine.make_fleet_round's round_step
    mesh: Any            # a FleetMesh, or the ("pod", "data", "model") DeviceMesh
    rules: Any = None    # fleet_inner_rules() on the "auto" layout
    inner: Any = None    # the ("data", "model") sub-mesh on the "auto" layout

    def place(self, tree):
        """``tree`` (client-stacked, whole on every rank of a pod) as the
        round step takes its params and optimizer state: DTensors on
        :attr:`inner` on the ``"auto"`` layout, as it is otherwise."""
        return tree if self.inner is None else distribute_stacked(tree, self.inner, self.rules)


def fleet_setup(model, opt, mesh, *, k: int, n_local_steps: int = 1, with_eval: bool = False,
                with_loss: bool = False, spmd: str = "shard_map", with_churn: bool = False,
                hier_k_local: int = 0, hier_kmeans_iters: int = 20) -> FleetProgram:
    """The fleet round on ``mesh``: every client-stacked operand is this
    rank's local slice of the clients, Eq. 2 all-reduces over the client
    group, and on the two-tier surface (``hier_k_local > 0``) a pod is
    one pod of the two-tier coordinator. ``with_eval`` / ``with_loss`` /
    ``with_churn`` select the surfaces of ``engine.make_fleet_round``.

    ``spmd="shard_map"`` takes a :class:`FleetMesh`: a rank is a shard of
    the client axis and holds its clients whole. ``spmd="auto"`` takes a
    ``("pod", "data", "model")`` ``DeviceMesh``: the client group is the
    mesh's ``pod`` group, a rank holds its pod's clients placed on the
    ``("data", "model")`` sub-mesh by :func:`fleet_inner_rules`
    (:meth:`FleetProgram.place` places the stacked params and optimizer
    state), and a client's batch is split over ``data``."""
    if spmd not in SPMD_MODES:
        raise ValueError(f"spmd={spmd!r}: the fleet round is laid out by one of {SPMD_MODES}")
    kw = dict(with_eval=with_eval, with_loss=with_loss, with_churn=with_churn,
              hier_k_local=hier_k_local, hier_kmeans_iters=hier_kmeans_iters)
    if spmd == "shard_map":
        if not isinstance(mesh, FleetMesh):
            raise ValueError('spmd="shard_map" runs on a FleetMesh (launch.mesh.make_fleet_mesh)')
        return FleetProgram(step=make_fleet_round(model, opt, k, n_local_steps,
                                                  group=mesh.group, **kw), mesh=mesh)
    if getattr(mesh, "mesh_dim_names", None) != POD_MESH_AXES:
        raise ValueError(f'spmd="auto" places the round on a {POD_MESH_AXES} DeviceMesh '
                         f"(launch.mesh.make_pod_mesh), not on {type(mesh).__name__}")
    rules = fleet_inner_rules()
    inner = mesh["data", "model"]
    # the pod's one group, made before the first placed op: the stat
    # upload merges over it, and DTensor then reduces over both inner
    # dimensions at once through it in every step alike
    mesh_group(inner)
    step = make_fleet_round(model, opt, k, n_local_steps, group=mesh.get_group("pod"),
                            inner=inner, rules=rules, **kw)
    return FleetProgram(step=step, mesh=mesh, rules=rules, inner=inner)


# ---------------------------------------------------------------------------
# the LM fleet's dry-run


def fleet_runtime_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    """The reference's runtime settings of the fleet dry-run: bf16
    activations, the scanned layout, ``remat="full"`` (of the smoke
    config with ``smoke``)."""
    cfg = get_config(arch_id)
    if smoke:
        cfg = cfg.smoke()
    return dataclasses.replace(cfg, dtype="bfloat16", scan_layers=True, remat="full")


def _stacked_meta(tree, n: int):
    return tree_map(lambda x: torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device="meta"),
                    tree)


def _local_nbytes(tree) -> int:
    return sum(x.to_local().numel() * x.element_size() for x in tree_leaves(tree))


def _axis_names(device_mesh, inner) -> dict:
    """process-group name -> the mesh axes it spans (the flattened inner
    group ``data_model``; axes of one rank may share a group: joined by
    ``+``)."""
    groups = [(device_mesh.get_group(a).group_name, a) for a in POD_MESH_AXES]
    groups.append((mesh_group(inner).group_name, "data_model"))
    names = {}
    for g, a in groups:
        names[g] = f"{names[g]}+{a}" if g in names else a
    return names


def fleet_round_census(cfg: ModelConfig, opt_cfg: OptimizerConfig, device_mesh, *,
                       n_clients: int, per_client_batch: int, seq: int, k: int,
                       n_local_steps: int = 1) -> dict:
    """One plain fleet round step of ``cfg`` on ``meta`` tensors, placed
    by :func:`fleet_setup` (``spmd="auto"``) on ``device_mesh``, a pod
    mesh under a fake process group of its world
    (``launch.dryrun.fake_world``, ``launch.mesh.make_pod_mesh``),
    counted by ``launch.dryrun.Census`` on rank 0 (pod 0 and its first
    inner rank): per-device FLOPs and op bytes, the collectives by op and
    by mesh axis (``pod``: Eq. 2 and the round's means; ``data``,
    ``model``: DTensor's FSDP / tensor-parallel collectives; ``data_model``:
    the stat upload's merge), and the port's own collectives by census
    tag. ``memory`` holds the table's per-device bytes of the pod's
    params, optimizer state and batch."""
    pods = device_mesh.size(0)
    if n_clients % pods:
        raise ValueError(f"{pods} pods do not divide {n_clients} clients")
    n_local = n_clients // pods
    model = build_model(cfg)
    opt = make_optimizer(opt_cfg)
    params_abs = abstract_params(cfg)
    prog = fleet_setup(model, opt, device_mesh, k=k, n_local_steps=n_local_steps, spmd="auto")
    sparams = prog.place(_stacked_meta(params_abs, n_local))
    sopt = prog.place(_stacked_meta(opt.init(params_abs), n_local))
    batch = {key: torch.empty((n_local, per_client_batch, seq), dtype=torch.int32,
                              device="meta") for key in ("tokens", "labels")}
    clusters = torch.empty((n_local,), dtype=torch.int32, device="meta")
    weights = torch.empty((n_local,), dtype=torch.float32, device="meta")
    one_batch = place_batch({key: v[0] for key, v in batch.items()}, prog.inner, prog.rules)
    census = dryrun.Census()
    mark = CENSUS.mark()
    with census:
        prog.step(sparams, sopt, batch, opt_cfg.lr, clusters, weights)
    rec = census.record()
    axes = _axis_names(device_mesh, prog.inner)
    rec["by_axis"] = {axes.get(g, g or "unnamed"): v for g, v in rec.pop("by_group").items()}
    tags = {}
    for entry in CENSUS.since(mark):
        t = tags.setdefault(entry.tag, {"count": 0, "bytes": 0})
        t["count"] += 1
        t["bytes"] += entry.nbytes
    rec["tags"] = tags
    params_bytes, state_bytes = _local_nbytes(sparams), _local_nbytes(sopt)
    input_bytes = n_local * _local_nbytes(one_batch)
    rec["memory"] = {"params_bytes": params_bytes, "state_bytes": state_bytes,
                     "input_bytes": input_bytes,
                     "argument_bytes": params_bytes + state_bytes + input_bytes}
    return rec


def _extrapolate_tree(a, b, L1: int, L2: int, L: int):
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {key: _extrapolate_tree(a.get(key), b.get(key), L1, L2, L)
                for key in sorted(set(a) | set(b))}
    return dryrun._extrapolate(float(a or 0.0), float(b or 0.0), L1, L2, L)


def lower_fleet_round(arch_id: str = "granite-3-2b", k: int = 3, seq: int = 1024,
                      per_client_batch: int = 16, *, mesh_shape=(2, 16, 16),
                      smoke: bool = False) -> dict:
    """The LM fleet's dry-run (the reference's ``lower_fleet_round``): one
    round step of ``arch_id`` at :func:`fleet_runtime_config`, adamw at lr
    3e-4, one client a pod (``n_clients = pods``), ``{"tokens",
    "labels"}`` of (clients, ``per_client_batch``, ``seq``), on the
    ``mesh_shape`` pod mesh (the reference's 2x16x16 unless given;
    ``smoke`` takes the arch's smoke config: the tests' seam).
    :func:`fleet_round_census` at the two probe depths of
    ``launch.dryrun.cost_probe`` (unrolled), extrapolated linearly to the
    config's depth, as ``cost_probe`` does. Nothing is compiled, so no
    temporary bytes are known: ``memory`` is the table's argument bytes a
    device."""
    cfg = fleet_runtime_config(arch_id, smoke=smoke)
    opt_cfg = OptimizerConfig(name="adamw", lr=3e-4)
    n_clients = int(mesh_shape[0])
    t0 = time.time()
    L1, L2 = dryrun._probe_layers(cfg)
    with dryrun.fake_world(math.prod(mesh_shape)):
        device_mesh = make_pod_mesh(mesh_shape)
        probes = {L: fleet_round_census(dryrun._probe_cfg(cfg, L), opt_cfg, device_mesh,
                                        n_clients=n_clients, per_client_batch=per_client_batch,
                                        seq=seq, k=k)
                  for L in (L1, L2)}
    L = cfg.n_layers
    full = {key: _extrapolate_tree(probes[L1][key], probes[L2][key], L1, L2, L)
            for key in ("flops", "bytes", "coll", "collectives", "by_axis", "tags", "memory")}
    rec = {"arch": arch_id + ("-smoke" if smoke else ""), "mesh": "x".join(map(str, mesh_shape)),
           "n_clients": n_clients, "per_client_batch": per_client_batch, "seq": seq, "k": k,
           "n_local_steps": 1, "optimizer": "adamw", "dtype": cfg.dtype, "remat": cfg.remat,
           "n_layers": L, "probe_layers": (L1, L2),
           "memory": {**full["memory"], "temp_bytes": None,
                      "note": "per device, from the placement table; no program is compiled, "
                              "so no temporary bytes are known"},
           "cost": {"flops_per_device": full["flops"], "bytes_per_device": full["bytes"],
                    "collective_bytes_per_device": full["coll"],
                    "counted_on": "rank 0's local shards (pod 0); bytes are op inputs + "
                                  "outputs, unfused; collectives are DTensor's plan and the "
                                  "port's explicit ones, the probe depths unrolled"},
           "collectives": full["collectives"], "by_axis": full["by_axis"], "tags": full["tags"],
           "probes": {str(d): probes[d] for d in (L1, L2)}}
    rec["roofline"] = dryrun.roofline(full["flops"], full["bytes"], full["coll"])
    rec["census_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="The LM fleet's dry-run: one round step on the "
                                 "2x16x16 pod mesh, counted on meta tensors.")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--out", default=None, help="write the record as JSON to this file")
    args = ap.parse_args(argv)
    rec = lower_fleet_round(args.arch)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    mem, tags = rec["memory"], rec["tags"]
    eq2 = tags.get("eq2", {"count": 0, "bytes": 0})
    by_axis = {a: {op: round(v["count"]) for op, v in ops_.items()}
               for a, ops_ in rec["by_axis"].items()}
    print(f"[swarm-fleet] {args.arch} round step placed on {rec['mesh']} "
          f"({rec['census_s']:.1f} s census); args/dev={mem['argument_bytes'] / 2**30:.2f} GiB "
          f"(table bytes of params, optimizer state and batch: nothing is compiled, so no temp "
          f"bytes); flops/dev={rec['cost']['flops_per_device']:.4e} "
          f"coll/dev={rec['cost']['collective_bytes_per_device']:.4e} B; eq2 all-reduces "
          f"{eq2['count']:.0f} of {eq2['bytes']:.4e} B on pod; collectives by axis "
          f"{json.dumps(by_axis)}",
          flush=True)
    return rec


if __name__ == "__main__":
    main()
