"""The fleet round's setup path (counterpart of
``repro.launch.swarm_fleet``'s ``shard_map`` path).

:func:`fleet_setup` builds the round step once a run, on the process
group of the mesh it is given: each rank runs the round body on its own
contiguous slice of the client axis and Eq. 2 is an all-reduced segment
sum (``engine.make_fleet_round(group=...)``). The stat upload is
computed in the round (the ``param_stats`` kernel on the card), and the
coordinator stays on rank 0 between rounds (``repro_torch.launch
.fleet_driver``).

The placement table it would build on is ported
(``repro_torch.sharding``, with ``launch.mesh.make_production_mesh``
and the dry-run census ``launch.dryrun``). Not ported yet (ROADMAP
A14): ``spmd="auto"`` (the fleet placed by that table on a
``DeviceMesh``, with ``fleet_inner_rules``), the LM fleet dry-run
``lower_fleet_round`` on the census, and ``force_host_device_count``,
which has no counterpart. The reference's
``use_pallas_stats`` switch has no counterpart: a CUDA tensor takes the
kernel and a CPU tensor its plain version.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.engine import make_fleet_round
from repro_torch.launch.mesh import FleetMesh


class FleetProgram(NamedTuple):
    """The one round step of a fleet run and the mesh it was built on
    (the reference's jit function, rules and shardings have no
    counterpart here)."""
    step: Any            # engine.make_fleet_round's round_step on mesh.group
    mesh: FleetMesh


def fleet_setup(model, opt, mesh: FleetMesh, *, k: int, n_local_steps: int = 1,
                with_eval: bool = False, with_loss: bool = False, spmd: str = "shard_map",
                with_churn: bool = False, hier_k_local: int = 0,
                hier_kmeans_iters: int = 20) -> FleetProgram:
    """The fleet round on ``mesh``: every client-stacked operand is this
    rank's local slice, Eq. 2 all-reduces over ``mesh.group``, and on
    the two-tier surface (``hier_k_local > 0``) this rank is one pod.
    ``with_eval`` / ``with_loss`` / ``with_churn`` select the surfaces
    of ``engine.make_fleet_round``.

    ``spmd`` is ``"shard_map"``, the reference driver's layout; the
    reference's ``"auto"`` is not ported (ROADMAP A14) and raises."""
    if spmd != "shard_map":
        raise ValueError(f'spmd={spmd!r} is not ported: "auto" (partitioner placement with '
                         'inner FSDP/TP rules) waits for ROADMAP A14; use spmd="shard_map"')
    step = make_fleet_round(model, opt, k, n_local_steps, with_eval=with_eval,
                            with_loss=with_loss, group=mesh.group, with_churn=with_churn,
                            hier_k_local=hier_k_local, hier_kmeans_iters=hier_kmeans_iters)
    return FleetProgram(step=step, mesh=mesh)
