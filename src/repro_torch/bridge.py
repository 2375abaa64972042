"""Weights and state carried between the reference package and the port.

The reference hands its trees across as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``). The port keeps the reference's
key names and layouts (HWIO conv weights included), so a round trip is
the identity and the per-tensor statistics columns line up.
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
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, as JAX hands it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"no torch dtype for numpy {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``, dtype kept."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def tree_to_numpy(tree):
    """Inverse of :func:`tree_from_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)


# model parameters and optimizer state (adam's {"step", "m", "v"}) are
# both nested dicts of arrays; the names say which tree a caller moves
params_from_numpy = tree_from_numpy
params_to_numpy = tree_to_numpy
opt_state_from_numpy = tree_from_numpy
opt_state_to_numpy = tree_to_numpy


def state_from_numpy(state, device="cpu", *, seed: int = 0):
    """A reference ``SwarmState`` as a dict of numpy arrays (``params``,
    ``opt_state``, ``round``, ``n_samples``) -> the port's
    :class:`~repro_torch.core.engine.SwarmState`. JAX's PRNG key has no
    torch counterpart: the state's generator is seeded from ``seed``."""
    from repro_torch.core.engine import SwarmState
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return SwarmState(
        params=tree_from_numpy(state["params"], device),
        opt_state=tree_from_numpy(state["opt_state"], device),
        generator=gen,
        round=int(np.asarray(state["round"])),
        n_samples=_leaf_from_numpy(state["n_samples"], device))


def state_to_numpy(state) -> dict:
    """Inverse of :func:`state_from_numpy` (the generator stays behind)."""
    return {"params": tree_to_numpy(state.params),
            "opt_state": tree_to_numpy(state.opt_state),
            "round": np.int32(state.round),
            "n_samples": _leaf_to_numpy(state.n_samples)}
