"""npz + JSON-manifest checkpoints (counterpart of ``repro.checkpoint.ckpt``),
in the reference's file format.

``save_checkpoint(path, tree)`` writes ``path.npz``, one array a leaf
under its ``"a/0/c"`` tree path, and ``path.json``, a manifest of
``step``, ``extra`` and each leaf's shape and dtype name. Restoring
goes into an example tree, whose structure, shapes and dtypes are
checked against the file, so nested dicts and lists round-trip without
pickling. Single models and client-stacked swarm trees alike.

bf16 leaves: numpy has no bfloat16, so the reference's ``np.savez``
stores one as raw two-byte ``V2`` values, and only the manifest says
``"bfloat16"``. The port writes bf16 the same way (the ``.npy`` header
reads ``|V2`` where ml_dtypes' reads ``<V2``; both load as the same
bytes) and reads a leaf by its manifest dtype, so it restores the bf16
files the reference writes (which the reference's own reader cannot).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.utils.tree import tree_paths_and_leaves

_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int32: "int32", torch.int64: "int64",
          torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
          torch.bool: "bool"}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def save_checkpoint(path, tree, *, step: int = 0, extra: dict = None) -> None:
    """Write ``tree`` (nested dicts and lists of tensors, on any device)
    to ``path.npz`` and its manifest to ``path.json``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pairs = tree_paths_and_leaves(tree)
    for p, leaf in pairs:
        if leaf.dtype not in _NAMES:
            raise TypeError(f"leaf '{p}': no checkpoint dtype for {leaf.dtype}")
    arrays = {p: _to_numpy(leaf) for p, leaf in pairs}
    np.savez(path.with_suffix(".npz"), **arrays)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {p: {"shape": list(leaf.shape), "dtype": _NAMES[leaf.dtype]}
                   for p, leaf in pairs},
    }
    path.with_suffix(".json").write_text(json.dumps(manifest, indent=1))


def restore_into(example_tree, path, *, device=None):
    """Returns ``(tree, step)``. ``example_tree`` supplies the structure,
    each leaf's shape and the dtype it is cast to; its leaves may be on
    the ``meta`` device. Leaves land on ``device``, else on the example
    leaf's device. Raises ``KeyError`` for a leaf the file lacks and
    ``ValueError`` for a shape that differs."""
    path = Path(path)
    manifest = json.loads(path.with_suffix(".json").read_text())
    names = dict(tree_paths_and_leaves(example_tree))
    out = {}
    with np.load(path.with_suffix(".npz")) as data:
        for key, leaf in names.items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf '{key}'")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for '{key}': {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            dtype_name = manifest["leaves"].get(key, {}).get("dtype", arr.dtype.name)
            out[key] = _from_numpy(arr, dtype_name).to(
                device=leaf.device if device is None else device, dtype=leaf.dtype)
    return _fill(example_tree, out), manifest["step"]


def _fill(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _fill(v, leaves, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, leaves, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return leaves[prefix[:-1]]

