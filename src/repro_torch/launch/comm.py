"""Communication accounting for the swarm, the §I / §III.B ledger
(counterpart of ``repro.launch.comm``).

BSO-SL's coordinator sees only O(#tensors) distribution summaries a
client while the models are exchanged among cluster peers. The ledger of
a fleet round sets the host-facing traffic (the stat upload, the
decision sent back) beside the Eq. 2 exchange between ranks and the
blockchain-SL and FedAvg baselines.

The Eq. 2 bytes are measured: every collective the fleet issues is
recorded in :data:`repro_torch.utils.collectives.CENSUS`, and
:func:`census_bytes` sums a round's entries. This takes the place of the
reference's parse of compiled HLO (``collective_bytes``, not ported).
There is no compiled program to ask for a cost analysis, so
``cost_analysis`` is ``{}``.
"""
from __future__ import annotations

from repro_torch.core.diststats import full_params_bytes, upload_bytes

_OPS = ("all_reduce", "gather", "broadcast")


def census_bytes(entries, tag: str = None) -> dict:
    """Bytes a rank hands to the collectives of ``entries`` (census
    records), by op, with ``"total"`` and ``"op_counts"``; only the
    entries tagged ``tag`` when given."""
    out = {op: 0 for op in _OPS}
    n_ops = {op: 0 for op in _OPS}
    for e in entries:
        if tag is not None and e.tag != tag:
            continue
        out[e.op] += e.nbytes
        n_ops[e.op] += 1
    out["total"] = sum(out[op] for op in _OPS)
    out["op_counts"] = n_ops
    return out


def fleet_round_comm(entries, params_abs, n_clients: int, batch_bytes: int = 0) -> dict:
    """The per-round ledger of one flat fleet round, the reference's keys.
    ``entries`` are the census records of one round (round step, stat
    gather and decision broadcast); ``params_abs`` is one client's tree
    (its leaves may be on the ``meta`` device); ``batch_bytes`` the
    round's data upload, listed apart.

    Host-facing: ``stat_upload_bytes`` (the (N, 2*#tensors) matrix),
    ``val_upload_bytes`` (the (N,) scores), ``cluster_feedback_bytes``
    (the (N,) int32 decision plus the (N,) f32 weights). Between ranks:
    ``eq2_collective_bytes``, the census of the Eq. 2 all-reduces (a
    rank's bytes a round), and ``round_collective_bytes``, every
    collective of the round. The analytic ``eq2_p2p_bound_bytes``,
    ``fedavg_bytes`` and ``blockchain_bytes`` follow the reference."""
    up = upload_bytes(params_abs)
    full = full_params_bytes(params_abs)
    return {
        "n_clients": n_clients,
        "stat_upload_bytes": n_clients * up,
        "val_upload_bytes": n_clients * 4,
        "cluster_feedback_bytes": n_clients * (4 + 4),
        "batch_upload_bytes": int(batch_bytes),
        "eq2_collective_bytes": census_bytes(entries, "eq2"),
        "round_collective_bytes": census_bytes(entries),
        "eq2_p2p_bound_bytes": 2 * n_clients * full,
        "fedavg_bytes": 2 * n_clients * full,
        "blockchain_bytes": n_clients * (n_clients - 1) * full,
        "full_params_bytes": full,
        "coord_reduction_x": full / max(up, 1),
        "cost_analysis": {},
    }


def hier_host_bytes(params_abs, n_clients: int, n_pods: int, k_local: int) -> dict:
    """The analytic host-facing ledger of one two-tier round beside the
    flat O(clients) round it replaces (the reference's arithmetic).

    Upload: flat ``N * (up + 4)`` (a stat row and a val score a client);
    hier ``S * (up + 12)`` for ``S = n_pods * k_local`` summary rows (a
    centroid plus count, weight sum and val sum), plus two O(1) scalars.
    Feedback: flat the (N,) int32 decision and (N,) f32 weights; hier the
    (S,) int32 map ``g`` plus the flag and an 8-byte seed."""
    up = upload_bytes(params_abs)
    S = n_pods * k_local
    return {
        "n_clients": n_clients,
        "n_pods": n_pods,
        "k_local": k_local,
        "summary_rows": S,
        "flat_upload_bytes": n_clients * (up + 4),
        "flat_feedback_bytes": n_clients * (4 + 4),
        "summary_upload_bytes": S * (up + 12),
        "scalar_upload_bytes": 8,
        "hier_feedback_bytes": S * 4 + 9,
        "hier_reduction_x": (n_clients * (up + 4)) / max(S * (up + 12), 1),
    }


def hier_round_comm(entries, params_abs, n_clients: int, *, n_pods: int, k_local: int,
                    batch_bytes: int = 0) -> dict:
    """The ledger of one two-tier fleet round: :func:`hier_host_bytes`
    plus the measured collectives and the baselines, as
    :func:`fleet_round_comm` gives them."""
    full = full_params_bytes(params_abs)
    out = hier_host_bytes(params_abs, n_clients, n_pods, k_local)
    out.update({
        "batch_upload_bytes": int(batch_bytes),
        "eq2_collective_bytes": census_bytes(entries, "eq2"),
        "round_collective_bytes": census_bytes(entries),
        "eq2_p2p_bound_bytes": 2 * n_clients * full,
        "fedavg_bytes": 2 * n_clients * full,
        "blockchain_bytes": n_clients * (n_clients - 1) * full,
        "full_params_bytes": full,
        "cost_analysis": {},
    })
    return out


def hier_scaling_table(params_abs, *, pod_size: int, k_local: int,
                       n_clients=(10_000, 100_000, 1_000_000)) -> list:
    """:func:`hier_host_bytes` at swarm sizes no host could serve flat,
    one row per N at a fixed pod size (pods grow with N)."""
    rows = []
    for n in n_clients:
        n = int(n)
        pods = -(-n // pod_size)
        row = hier_host_bytes(params_abs, n, pods, k_local)
        row["pod_size"] = pod_size
        rows.append(row)
    return rows
