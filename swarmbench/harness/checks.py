"""The comparison that decides ``correct``, and the numbers it prints.

One side's :class:`~swarmbench.reference.swarm.Readings` (the program's,
or the control's) against the float32 reference's, which followed that
side's assignments from the same weights and draws:

- ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over every local
  step of the rounds (the step's mean client loss);
- ``first_loss_gap``: the same of the first local step alone, where both
  sides start from the same weights and rows, so that only the
  arithmetic differs (steady from seed to seed; the later steps add the
  drift of two trajectories);
- ``first_grad_gap``: after the first local step, by the worst
  (client, leaf), ``| |m| - |m_ref| |`` over the larger of ``|m_ref|``
  and the client's median leaf's (adam's first moment after one step:
  the first gradient as the optimizer got it, from the same weights and
  rows on both sides);
- ``change_gap``: the same of ``|params - start|`` after the last round
  (local steps and Eq. 2 together);
- ``eval_gap``: the largest ``|acc_c - acc_ref_c|`` over the clients
  and rounds, a share of the client's val answers (tokens): the side's
  val accuracy against the float32 reference's accuracy of the same
  weights, those the side's eval scored (so that the two trajectories'
  drift, which the other numbers judge, does not enter);
- ``upload_gap``: by the worst (client, feature), ``|u - u_ref|`` over
  the larger of ``|u_ref|`` and the client's median ``|u_ref|``, the
  largest over the rounds: the side's own upload (the program's K1
  statistics as the coordinator got them) against the reference's
  statistics of the same weights (0 for a side that has no upload of
  its own);
- ``coord_mismatch``: assignments, centers and event counts in which
  the side's coordinator differs from the reference's coordinator run
  over the side's own upload and val scores, summed over the rounds.

Leaves whose reference first moment is under a thousandth of the
client's median leaf's are left out of ``first_grad_gap`` and
``change_gap``: their
gradient is nought to rounding, and adam moves them by round-off."""
from __future__ import annotations

import torch

NAMES = ("loss_gap", "first_loss_gap", "first_grad_gap", "change_gap", "eval_gap",
         "upload_gap", "coord_mismatch")
NOUGHT = 1e-3


def _norm_gap(side: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor) -> float:
    med = ref.median(dim=1, keepdim=True).values
    gap = (side - ref).abs() / torch.maximum(ref, med)
    return float(torch.where(keep, gap, 0.0).max())


def _upload_gap(side) -> float:
    gaps = [0.0]
    for up, ref in zip(side.upload, side.features):
        ref = ref.double()
        scale = torch.maximum(ref.abs(), ref.abs().median(dim=1, keepdim=True).values)
        gaps.append(float(((up.double() - ref).abs() / scale).max()))
    return max(gaps)


def compare(side, ref, coord, scored) -> dict:
    """The numbers of :data:`NAMES`; ``coord`` is the reference
    coordinator's (assignments, centers, replaced, swapped) a round over
    the side's upload, ``scored`` the reference's (N,) val accuracy a
    round of the weights the side's eval scored."""
    loss = max(float(((s - r).abs() / r.abs()).max()) for s, r in zip(side.losses, ref.losses))
    first = float(abs(side.losses[0][0] - ref.losses[0][0]) / abs(ref.losses[0][0]))
    keep = ref.first_moment >= NOUGHT * ref.first_moment.median(dim=1, keepdim=True).values
    val = max(float((s.double() - r.double()).abs().max()) for s, r in zip(side.val, scored))
    mism = 0
    for r, (a, c, n_rep, n_swap) in enumerate(coord):
        mism += int((side.assignments[r].long().cpu() != a.long().cpu()).sum())
        mism += int((side.centers[r].long().cpu() != c.long().cpu()).sum())
        mism += abs(side.events[r][0] - n_rep) + abs(side.events[r][1] - n_swap)
    return {"loss_gap": loss,
            "first_loss_gap": first,
            "first_grad_gap": _norm_gap(side.first_moment.double(), ref.first_moment.double(),
                                        keep),
            "change_gap": _norm_gap(side.change.double(), ref.change.double(), keep),
            "eval_gap": val,
            "upload_gap": _upload_gap(side),
            "coord_mismatch": float(mism)}


def verdict(values: dict, limits: dict):
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NAMES}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
