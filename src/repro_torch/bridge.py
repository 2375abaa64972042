"""Weights and state carried between the reference package and the port.

The reference hands its trees across as nested dicts and lists of
numpy arrays (``jax.tree.map(np.asarray, params)``). The port keeps the
reference's key names and layouts (HWIO conv weights, the LM's stacked
``(L, ...)`` layers and its ``(B, S, KV, hd)`` KV cache included), so a
round trip is the identity and the per-tensor statistics columns line
up. The Table-II method rows, the grid rows (with their churn rows) and
method-stacked states cross the same way, and so does an LM swarm's
state (client-stacked LM trees in either layout, through
:func:`state_from_numpy`; its ``RoundDraws`` are the CNN round's).
"""
from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.bool_): torch.bool,
}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")           # a contiguous copy; a () array stays ()
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, as JAX hands it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):   # an fp8 KV cache
        return torch.from_numpy(a.view(np.uint8)).view(getattr(torch, a.dtype.name)).to(device)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"no torch dtype for numpy {a.dtype}")
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        import ml_dtypes
        return t.view(torch.uint8).numpy().view(getattr(ml_dtypes, str(t.dtype)[6:]))
    return t.numpy()


def tree_from_numpy(tree, device="cpu"):
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on ``device``, dtype kept."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_from_numpy(v, device) for v in tree]
    return _leaf_from_numpy(tree, device)


def tree_to_numpy(tree):
    """Inverse of :func:`tree_from_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_numpy(v) for v in tree]
    return _leaf_to_numpy(tree)


# model parameters, optimizer state (adam's {"step", "m", "v"}) and the
# LM's KV cache are all nested dicts and lists of arrays; the names say
# which tree a caller moves
params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy
opt_state_from_numpy = tree_from_numpy
opt_state_to_numpy = tree_to_numpy
cache_from_numpy = tree_from_numpy
cache_to_numpy = tree_to_numpy


def state_from_numpy(state, device="cpu", *, seed: int = 0):
    """A reference ``SwarmState`` as a dict of numpy arrays (``params``,
    ``opt_state``, ``round``, ``n_samples``, ``staleness``) -> the port's
    :class:`~repro_torch.core.engine.SwarmState`. JAX's PRNG key has no
    torch counterpart: the state's generator is seeded from ``seed`` and
    its churn generator is ``make_churn_generator(seed)``, as
    ``make_swarm_state`` makes them. A missing or None ``staleness`` (a
    state from before the churn axis) becomes zeros."""
    from repro_torch.core.engine import SwarmState, make_churn_generator
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_samples = _leaf_from_numpy(state["n_samples"], device)
    staleness = state.get("staleness")
    return SwarmState(
        params=tree_from_numpy(state["params"], device),
        opt_state=tree_from_numpy(state["opt_state"], device),
        generator=gen,
        round=int(np.asarray(state["round"])),
        n_samples=n_samples,
        staleness=(torch.zeros(n_samples.shape, dtype=torch.int32, device=device)
                   if staleness is None else _leaf_from_numpy(staleness, device)),
        churn_generator=make_churn_generator(seed, device))


def state_to_numpy(state) -> dict:
    """Inverse of :func:`state_from_numpy` (the generators stay behind)."""
    return {"params": tree_to_numpy(state.params),
            "opt_state": tree_to_numpy(state.opt_state),
            "round": np.int32(state.round),
            "n_samples": _leaf_to_numpy(state.n_samples),
            "staleness": None if state.staleness is None else _leaf_to_numpy(state.staleness)}


def method_params_from_numpy(method, device="cpu"):
    """A reference ``MethodParams`` as a mapping (or its ``_asdict()``)
    of numpy arrays, one row or a stacked (M, ...) sweep config -> the
    port's :class:`~repro_torch.core.engine.MethodParams`."""
    from repro_torch.core.engine import MethodParams
    return MethodParams(*(_leaf_from_numpy(method[f], torch.device(device))
                          for f in MethodParams._fields))


def method_params_to_numpy(method) -> dict:
    """Inverse of :func:`method_params_from_numpy`."""
    return {f: _leaf_to_numpy(t) for f, t in zip(method._fields, method)}


def churn_params_from_numpy(churn, device="cpu"):
    """A reference ``ChurnParams`` (or a mapping of its fields) of numpy
    arrays, one row or stacked -> the port's
    :class:`~repro_torch.core.engine.ChurnParams`; ``mask`` may be None."""
    from repro_torch.core.engine import ChurnParams
    if not isinstance(churn, dict):
        churn = churn._asdict()
    dev = torch.device(device)
    mask = churn.get("mask")
    return ChurnParams(_leaf_from_numpy(churn["dropout"], dev),
                       _leaf_from_numpy(churn["stale_decay"], dev),
                       None if mask is None else _leaf_from_numpy(np.asarray(mask, bool), dev))


def churn_params_to_numpy(churn) -> dict:
    """Inverse of :func:`churn_params_from_numpy` (a dict)."""
    return {f: None if t is None else _leaf_to_numpy(t) for f, t in zip(churn._fields, churn)}


def grid_point_from_numpy(point, device="cpu"):
    """A reference ``GridPoint`` as a mapping (or its ``_asdict()``) of
    numpy arrays, its ``method`` a mapping or a ``MethodParams`` and its
    ``churn`` None, a mapping or a ``ChurnParams``, one row or a stacked
    (G, ...) grid config -> the port's
    :class:`~repro_torch.core.engine.GridPoint`."""
    from repro_torch.core.engine import GridPoint
    method = point["method"]
    if not isinstance(method, dict):
        method = method._asdict()
    dev = torch.device(device)
    churn = point.get("churn")
    return GridPoint(method_params_from_numpy(method, device),
                     *(_leaf_from_numpy(point[f], dev) for f in GridPoint._fields[1:-1]),
                     churn=None if churn is None else churn_params_from_numpy(churn, device))


def grid_point_to_numpy(point) -> dict:
    """Inverse of :func:`grid_point_from_numpy` (``method`` and ``churn``
    as dicts)."""
    return {"method": method_params_to_numpy(point.method),
            **{f: _leaf_to_numpy(t) for f, t in zip(point._fields[1:-1], point[1:-1])},
            "churn": None if point.churn is None else churn_params_to_numpy(point.churn)}


def _row(tree, m):
    if isinstance(tree, dict):
        return {k: _row(v, m) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_row(v, m) for v in tree]
    return None if tree is None else np.asarray(tree)[m]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack([t[i] for t in trees]) for i in range(len(trees[0]))]
    return None if trees[0] is None else np.stack(trees)


def sweep_state_from_numpy(state, device="cpu", *, seeds):
    """A reference method-stacked ``SwarmState`` (every field with a
    leading (M,) axis) as a dict of numpy arrays -> the port's list of M
    states, row m's generator seeded from ``seeds[m]``."""
    return [state_from_numpy(_row(state, m), device, seed=s) for m, s in enumerate(seeds)]


def sweep_state_to_numpy(states) -> dict:
    """Inverse of :func:`sweep_state_from_numpy`: the rows stacked on a
    leading (M,) axis (the generators stay behind)."""
    return _stack([state_to_numpy(s) for s in states])
