"""Faults planted under the timed path, to show that the check catches
them (``calibrate.py`` on the chip, ``test_swarmbench_faults.py`` on the
CPU). Each wraps one function of ``repro_torch.core.engine`` that
``swarm_round`` calls:

- ``unchanged``: the local phase returns the state it was given (a step
  that returns its state unchanged);
- ``half_batch``: every local batch loses its second half, the loss is
  the mean over the rest;
- ``no_eq2``: Eq. 2 is left out (the exchange between the clients);
- ``val_altered``: the first client's val answers are altered where
  eval produces them (its accuracy set to 0 or 1, whichever lies at
  least 0.5 away);
- ``coord_altered``: where the coordinator produces them, the first
  client's cluster is moved by one (a no-op at k = 1) and the first
  cluster's center moved to the next client (an answer altered);
- ``upload_altered``: where K1's upload is produced, the first two
  clients' rows trade places (statistics of the wrong client: an answer
  altered that moves no cluster at k = 1)."""
from __future__ import annotations

from contextlib import contextmanager

FAULTS = ("unchanged", "half_batch", "no_eq2", "val_altered", "coord_altered",
          "upload_altered")


def _unchanged(f):
    def g(step, params, opt_state, *a, **k):
        return params, opt_state, f(step, params, opt_state, *a, **k)[2]
    return g


def _half_batch(f):
    def g(*a, **k):
        return {key: v[:, : v.shape[1] // 2] for key, v in f(*a, **k).items()}
    return g


def _no_eq2(f):
    def g(cfg, params, opt_state, *a, **k):
        return params, opt_state
    return g


def _val_altered(f):
    def g(*a, **k):
        v = f(*a, **k).clone()
        v[0] = 0.0 if v[0] >= 0.5 else 1.0
        return v
    return g


def _coord_altered(f):
    def g(params, val, cfg, *a, **k):
        assignments, centers, n_rep, n_swap = f(params, val, cfg, *a, **k)
        assignments, centers = assignments.clone(), centers.clone()
        assignments[0] = (assignments[0] + 1) % cfg.n_clusters
        centers[0] = (centers[0] + 1) % assignments.shape[0]
        return assignments, centers, n_rep, n_swap
    return g


def _upload_altered(f):
    def g(*a, **k):
        feats = f(*a, **k)
        order = [1, 0, *range(2, feats.shape[0])]
        return feats[order]
    return g


PLANTS = {"unchanged": ("local_phase", _unchanged),
          "half_batch": ("sample_round_batch", _half_batch),
          "no_eq2": ("_aggregate", _no_eq2),
          "val_altered": ("eval_swarm", _val_altered),
          "coord_altered": ("_coordinate", _coord_altered),
          "upload_altered": ("swarm_distribution_matrix", _upload_altered)}


@contextmanager
def planted(name: str):
    from repro_torch.core import engine
    attr, wrap = PLANTS[name]
    orig = getattr(engine, attr)
    setattr(engine, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(engine, attr, orig)
