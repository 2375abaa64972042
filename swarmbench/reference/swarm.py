"""Plain reference of the BSO-SL round (paper §III), client by client.

One round: every client takes ``local_steps`` adam steps on its own
rows (the global gradient norm clipped first), each client's val
accuracy over its real val rows, the distribution upload (per leaf, in
sorted path order, the client's ``[mean, log1p(var)]``, two-pass in
float32), k-means++ seeded from the round's uniforms and
``kmeans_iters`` Lloyd steps (empty clusters take distinct far points,
farthest first), the brain storm (centers = best val score a cluster;
with r1 > p1 a Gumbel-picked member replaces it; then cluster by cluster
with r2 > p2 its center swaps with a Gumbel-picked other occupied
cluster's and the two clients trade clusters), and Eq. 2 (each
cluster's members take their train-size-weighted mean). Ties go to the
lowest index everywhere.

:func:`run_rounds` drives rounds from given weights and draws and
returns the :class:`Readings` that the check compares. With ``follow``
(another side's readings) Eq. 2 takes that side's assignments, so the
two trajectories average the same clients and the coordinator is judged
on its own by :func:`coordinate` over that side's uploads."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F


@dataclass
class Readings:
    """What one side (the program, the control or the reference) gave in
    the rounds that are compared."""
    losses: list = field(default_factory=list)         # a round: (steps,) mean client loss
    val: list = field(default_factory=list)            # a round: (N,) val accuracy
    features: list = field(default_factory=list)       # a round: (N, 2T) reference statistics
    #                                                    of the side's post-local weights
    upload: list = field(default_factory=list)         # a round: (N, 2T) the side's own upload
    eval_weights: list = field(default_factory=list)   # a round: {path: (N, ...)} on the host,
    #                                                    the weights the side's eval scored
    assignments: list = field(default_factory=list)    # a round: (N,) post brain storm
    centers: list = field(default_factory=list)        # a round: (k,)
    events: list = field(default_factory=list)         # a round: (replaced, swapped)
    first_moment: torch.Tensor = None                  # (N, T) |adam m| after the first step
    change: torch.Tensor = None                        # (N, T) |params - start| after the last
    end_weights: dict = None                           # {path: (N, ...)} on the host after the
    #                                                    last round, until ``change`` is taken


def family(name: str):
    return importlib.import_module(f"swarmbench.reference.{name}")


def features(params: dict) -> torch.Tensor:
    """(N, 2T) upload: per leaf in sorted path order ``[mean, log1p(var)]``."""
    cols = []
    for path in sorted(params):
        x = params[path].reshape(params[path].shape[0], -1).float()
        mean = x.mean(dim=1)
        var = ((x - mean[:, None]) ** 2).mean(dim=1)
        cols += [mean, torch.log1p(var)]
    return torch.stack(cols, dim=1)


def leaf_norms(params: dict, minus: dict = None) -> torch.Tensor:
    """(N, T) per client and leaf (sorted paths) ``|x|`` or ``|x - minus|``
    (``x`` may sit on the host: it is taken to ``minus``'s device a client
    leaf at a time)."""
    out = []
    for path in sorted(params):
        x = params[path]
        rows = []
        for c in range(x.shape[0]):              # a client at a time: a leaf's copy, not N
            d = x[c].double() if minus is None else \
                x[c].to(minus[path].device).double() - minus[path][c].double()
            rows.append(torch.linalg.vector_norm(d))
        out.append(torch.stack(rows))
    return torch.stack(out, dim=1)


def _sqdist(X, C):
    return ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)


def kmeans(X: torch.Tensor, k: int, iters: int, u: torch.Tensor):
    """(centroids, assignments int64) of the rows of X."""
    N = X.shape[0]
    uniform = [min(int(float(u[i]) * N), N - 1) for i in range(k)]
    idx = [uniform[0]]
    for i in range(1, k):
        d = _sqdist(X, X[idx]).min(dim=1).values
        cum = torch.cumsum(d.double(), 0)
        if float(cum[-1]) > 0:
            pick = int(torch.searchsorted(cum, (u[i].double() * cum[-1]).reshape(1), right=True))
            idx.append(min(pick, N - 1))
        else:
            idx.append(uniform[i])
    C = X[idx]
    for _ in range(iters):
        a = _sqdist(X, C).argmin(dim=1)
        newC = torch.zeros_like(C)
        counts = torch.zeros(k, dtype=X.dtype, device=X.device)
        for j in range(k):
            m = a == j
            counts[j] = m.sum()
            if m.any():
                newC[j] = X[m].sum(0) / m.sum()
        d = ((X - C[a]) ** 2).sum(dim=1)
        far = torch.argsort(-d, stable=True)
        n_empty = 0
        for j in range(k):
            if counts[j] == 0:
                newC[j] = X[far[min(n_empty, N - 1)]]
                n_empty += 1
        C = newC
    return C, _sqdist(X, C).argmin(dim=1)


def brain_storm(a: torch.Tensor, val: torch.Tensor, k: int, p1: float, p2: float, draws):
    """(assignments, centers, n_replaced, n_swapped) after the brain storm."""
    a = a.clone()
    occupied = [bool((a == j).any()) for j in range(k)]
    centers = [-1] * k
    for j in range(k):
        if occupied[j]:
            members = torch.nonzero(a == j)[:, 0]
            centers[j] = int(members[torch.argmax(val[members].float())])
    n_rep = 0
    for j in range(k):
        if occupied[j] and bool(draws.r1[j] > p1):
            members = torch.nonzero(a == j)[:, 0]
            new = int(members[torch.argmax(draws.g[j, members])])
            n_rep += int(new != centers[j])
            centers[j] = new
    n_swap = 0
    n_occ = sum(occupied)
    for j in range(k):
        if occupied[j] and n_occ > 1 and bool(draws.r2[j] > p2):
            others = [o for o in range(k) if occupied[o] and o != j]
            other = others[int(torch.argmax(draws.g2[j, others]))]
            ci, oi = centers[j], centers[other]
            centers[j], centers[other] = oi, ci
            a[ci], a[oi] = a[oi].clone(), a[ci].clone()
            n_swap += 1
    return a, torch.tensor(centers), n_rep, n_swap


def coordinate(feats: torch.Tensor, val: torch.Tensor, draws, swarm: dict):
    """The coordinator over one round's upload and val scores."""
    _, a0 = kmeans(feats.float(), swarm["k"], swarm["kmeans_iters"], draws.kmeans_u)
    return brain_storm(a0, val, swarm["k"], swarm["p1"], swarm["p2"], draws)


def eq2(params: dict, a: torch.Tensor, w: torch.Tensor, k: int) -> dict:
    """Paper Eq. 2: each cluster's members take its ``w``-weighted mean."""
    out = {}
    for path, x in params.items():
        y = x.clone()
        for j in range(k):
            m = torch.nonzero(a == j)[:, 0]
            if len(m):
                wm = (w[m] / w[m].sum()).reshape((-1,) + (1,) * (x.dim() - 1))
                y[m] = (wm * x[m]).sum(0)
        out[path] = y
    return out


def adam_step(p: dict, g: dict, m: dict, v: dict, t: int, opt: dict):
    """One client's adam step in place (the global gradient norm clipped to
    ``grad_clip`` first)."""
    norm = torch.sqrt(sum((x.float() ** 2).sum() for x in g.values()))
    scale = torch.clamp(opt["grad_clip"] / (norm + 1e-9), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    for path in p:
        gs = g[path] * scale
        m[path].mul_(b1).add_((1 - b1) * gs)
        v[path].mul_(b2).add_((1 - b2) * gs * gs)
        upd = (m[path] / bc1.item()) / (torch.sqrt(v[path] / bc2.item()) + opt["eps"])
        p[path].sub_(opt["lr"] * upd)


def client_loss(fam, cfg: dict, params: dict, inputs, labels, precision: str):
    """Mean cross-entropy in fp32 over the labels that are not -1."""
    logits = fam.forward(params, inputs, cfg, precision)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), ignore_index=-1)


def accuracy(fam, cfg: dict, params: dict, inputs, labels, precision: str) -> float:
    with torch.no_grad():
        logits = fam.forward(params, inputs, cfg, precision)
    mask = labels >= 0
    hits = (torch.argmax(logits.float(), dim=-1) == labels) & mask
    return float(hits.sum()) / max(int(mask.sum()), 1)


def eval_accuracy(fam_name: str, cfg: dict, weights: dict, val: list,
                  precision: str = "float32") -> torch.Tensor:
    """(N,) each client's val accuracy under ``weights`` ({path: (N, ...)},
    on the host or the device), one client on the val rows' device at a
    time."""
    fam = family(fam_name)
    dev = val[0][1].device
    return torch.tensor([accuracy(fam, cfg, {p: x[c].to(dev).float() for p, x in weights.items()},
                                  *val[c], precision) for c in range(len(val))])


def run_rounds(fam_name: str, cfg: dict, opt: dict, swarm: dict, start: dict, train: list,
               val: list, n_samples: torch.Tensor, draws: list, precision: str = "float32",
               follow: Readings = None, keep_eval_weights: bool = False) -> Readings:
    """The rounds of ``draws`` from the weights ``start`` ({path: (N, ...)}).

    ``train`` and ``val`` hold each client's real rows as (inputs,
    labels). The products run in ``precision``; ``follow`` makes Eq. 2
    take another side's assignments; ``keep_eval_weights`` keeps a host
    copy of the weights each eval scored, so that the eval can be judged
    as the program's is."""
    fam = family(fam_name)
    N = n_samples.shape[0]
    params = {p: x.detach().clone().float() for p, x in start.items()}
    m = {p: torch.zeros_like(x) for p, x in params.items()}
    v = {p: torch.zeros_like(x) for p, x in params.items()}
    out = Readings()
    t = 0
    for r, d in enumerate(draws):
        step_losses = []
        for i in range(d.batch_idx.shape[0]):
            t += 1
            total = 0.0
            for c in range(N):
                rows = d.batch_idx[i, c]
                pc = {p: x[c].detach().requires_grad_() for p, x in params.items()}
                loss = client_loss(fam, cfg, pc, train[c][0][rows], train[c][1][rows], precision)
                grads = torch.autograd.grad(loss, list(pc.values()))
                total += float(loss.detach())
                with torch.no_grad():
                    adam_step({p: params[p][c] for p in params}, dict(zip(pc, grads)),
                              {p: m[p][c] for p in m}, {p: v[p][c] for p in v}, t, opt)
            if t == 1:
                out.first_moment = leaf_norms(m).cpu()
            step_losses.append(total / N)
        out.losses.append(torch.tensor(step_losses, dtype=torch.float64))
        with torch.no_grad():
            if keep_eval_weights:
                out.eval_weights.append({p: x.to("cpu", copy=True) for p, x in params.items()})
            acc = [accuracy(fam, cfg, {p: x[c] for p, x in params.items()}, *val[c], precision)
                   for c in range(N)]
            out.val.append(torch.tensor(acc, dtype=torch.float32))
            feats = features(params)
            out.features.append(feats)
            a, centers, n_rep, n_swap = coordinate(feats, out.val[-1].to(feats.device), d, swarm)
            out.assignments.append(a.cpu())
            out.centers.append(centers.cpu())
            out.events.append((n_rep, n_swap))
            used = a if follow is None else follow.assignments[r].to(a.device)
            params = eq2(params, used.long(), n_samples.float(), swarm["k"])
    out.change = leaf_norms(params, start).cpu()
    return out
