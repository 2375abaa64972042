"""Stateful host wrapper over the round engine, sim regime (counterpart
of ``repro.core.swarm``): the port's normal entry point.

:class:`SwarmTrainer` owns a :class:`~repro_torch.core.engine.SwarmState`
and advances it one :func:`~repro_torch.core.engine.swarm_round` per
round, keeping ``round`` / ``fit`` / ``client_scores`` /
``mean_accuracy`` / ``history``. It runs on ``cuda`` unless built with
``device="cpu"``. :func:`eval_client` is the one-client eval loop of the
centralized baseline (:mod:`repro_torch.core.baselines`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import OptimizerConfig, SwarmConfig
from repro_torch.core.engine import (EngineConfig, RoundDraws, RoundMetrics,
                                     SwarmState, make_batch, make_client_eval,
                                     make_swarm_data, make_swarm_state, pad_eval_split,
                                     resolve_local_steps, run_rounds, stack_eval_split,
                                     swarm_round)
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


def eval_client(eval_fn, cfg, params, X, y, batch: int = 64) -> float:
    """Masked fixed-shape evaluation of ONE client (pads with label -1
    rows), on the device of ``params``: the centralized baseline's eval,
    and the oracle of the engine's client-stacked eval."""
    device = next(iter(tree_leaves(params))).device
    n = len(y)
    correct, total = 0.0, 0
    for s in range(0, n, batch):
        k = len(y[s:s + batch])
        xb, yb = pad_eval_split(X[s:s + batch], y[s:s + batch], batch)
        m = eval_fn(params, make_batch(cfg, xb, yb, device))
        correct += float(m["acc"]) * k
        total += k
    return correct / max(total, 1)


@dataclass
class RoundLog:
    round: int
    mean_val_acc: float
    assignments: np.ndarray
    centers: np.ndarray
    events: List[str]
    train_loss: float


def _round_log(r: int, m: RoundMetrics) -> RoundLog:
    events = ["replace"] * int(m.n_replaced) + ["swap"] * int(m.n_swapped)
    return RoundLog(r, float(m.mean_val_acc), m.assignments.cpu().numpy(),
                    m.centers.cpu().numpy(), events, float(m.train_loss))


class SwarmTrainer:
    def __init__(self, model: Model, clients_data: List[dict], swarm: SwarmConfig,
                 opt_cfg: OptimizerConfig, seed: int = 0, *, batch_size: int = 16,
                 aggregation: str = "bso", lr: Optional[float] = None, device=None):
        if aggregation not in ("bso", "fedavg", "none"):
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.data = clients_data
        self.swarm = swarm
        self.n = len(clients_data)
        self.batch_size = batch_size
        self.aggregation = aggregation
        self.lr = lr if lr is not None else opt_cfg.lr
        self.opt = make_optimizer(opt_cfg)
        self.engine_cfg = EngineConfig(
            model=model, opt=self.opt,
            local_steps=resolve_local_steps(swarm, clients_data, batch_size),
            batch_size=batch_size, lr=self.lr, aggregation=aggregation,
            n_clusters=swarm.n_clusters, p1=swarm.p1, p2=swarm.p2,
            kmeans_iters=swarm.kmeans_iters)
        self.swarm_data = make_swarm_data(self.cfg, clients_data, device=self.device)
        self.state: SwarmState = make_swarm_state(model, self.opt, clients_data, seed,
                                                  device=self.device)
        self._veval = make_client_eval(model)
        self._eval_splits: Dict[str, dict] = {"val": self.swarm_data.val}
        self.history: List[RoundLog] = []

    @property
    def params(self):
        return self.state.params

    @property
    def opt_state(self):
        return self.state.opt_state

    def client_scores(self, split: str = "val") -> np.ndarray:
        """Per-client masked accuracy on ``split``."""
        if split not in self._eval_splits:
            self._eval_splits[split] = stack_eval_split(self.cfg, self.data, split,
                                                        device=self.device)
        scores = self._veval(self.state.params, self._eval_splits[split])
        return scores.cpu().numpy().astype(np.float32)

    def mean_accuracy(self, split: str = "test") -> float:
        """Paper Eq. 3: the mean of per-client accuracy."""
        return float(self.client_scores(split).mean())

    def round(self, r: Optional[int] = None, draws: RoundDraws = None) -> RoundLog:
        """One protocol round; ``draws`` injects its random inputs."""
        r = len(self.history) if r is None else r
        self.state, m = swarm_round(self.state, self.swarm_data, self.engine_cfg, draws=draws)
        log = _round_log(r, m)
        self.history.append(log)
        return log

    def fit(self, rounds: Optional[int] = None, verbose: bool = False):
        rounds = rounds or self.swarm.rounds
        for _ in range(rounds):
            log = self.round()
            if verbose:
                print(f"[{self.aggregation}] round {log.round:3d} "
                      f"val_acc={log.mean_val_acc:.4f} loss={log.train_loss:.4f} "
                      + ("; ".join(log.events) if log.events else ""))
        return self.history

    def fit_scanned(self, rounds: Optional[int] = None, draws=None):
        """The same rounds as :meth:`fit` as one :func:`engine.run_rounds`
        call (``draws``: a list of :class:`RoundDraws`, one a round),
        appending the same history. The rounds still run one after
        another; the reference scans them into one device program."""
        rounds = rounds or self.swarm.rounds
        self.state, ms = run_rounds(self.state, self.swarm_data, self.engine_cfg, rounds,
                                    draws=draws)
        start = len(self.history)
        for i in range(rounds):
            self.history.append(_round_log(start + i, RoundMetrics(*(f[i] for f in ms))))
        return self.history
