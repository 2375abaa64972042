"""One-call servers over the engine, and the train-to-serve bridge
(counterpart of ``repro.serve.api``).

:func:`load_checkpoint` restores a client-stacked swarm checkpoint (the
reference's file format, :mod:`repro_torch.checkpoint`) whose manifest
``extra`` carries ``model_config``, ``n_clients`` and ``client_weights``,
as the reference's fleet export writes them, and :func:`reduce_clients`
collapses its client axis to the single served model.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.checkpoint import restore_into
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.serve.engine import ClassifyResult, ImageClassifier, ServeEngine, ServeResult
from repro_torch.serve.scheduler import BucketSpec, Request, default_bucket_layout
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def reduce_clients(sparams, weights, client: str = "mean"):
    """Collapse the leading client axis: ``"mean"`` is Eq. 2 with one
    global cluster (the weights normalised, the sum in fp32, cast back);
    ``"client:i"`` serves client ``i``'s model verbatim."""
    if client == "mean":
        def mean(x):
            w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
            w = w / torch.clamp(w.sum(), min=1e-9)
            wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
            return (x.float() * wb).sum(0).to(x.dtype)
        return tree_map(mean, sparams)
    if client.startswith("client:"):
        i = int(client.split(":", 1)[1])
        return tree_map(lambda x: x[i], sparams)
    raise ValueError(f"unknown reduction '{client}' (want 'mean' or 'client:<i>')")


def stacked_example(model: Model, n: int):
    """The tree of ``n`` client-stacked models on the ``meta`` device:
    one init traced under ``FakeTensorMode`` (shapes and dtypes only, no
    storage, no random draws), each leaf given a leading ``(n,)`` axis.
    ``restore_into`` reads only its structure, shapes and dtypes."""
    with FakeTensorMode():
        one = model.init(torch.Generator().manual_seed(0))
    return tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype, device="meta"), one)


def load_checkpoint(path, *, client: str = "mean", use_pallas: Optional[bool] = None,
                    device=None) -> Tuple[Model, object]:
    """Restore a swarm checkpoint into ``(model, params)`` ready to serve,
    on ``cuda`` unless ``device`` is given: rebuild the config from the
    manifest (``build_model`` is a cache hit for an equal config), restore
    the client stack into :func:`stacked_example`'s tree and reduce it
    with :func:`reduce_clients` and the manifest's ``client_weights``.
    ``use_pallas`` replaces the config's flag, which the port carries
    and ignores."""
    dev = resolve_device(device)
    path = Path(path)
    extra = json.loads(path.with_suffix(".json").read_text()).get("extra", {})
    if "model_config" not in extra:
        raise ValueError(f"{path}: manifest has no 'model_config' (a swarm checkpoint "
                         "carries its ModelConfig in extra)")
    cfg = ModelConfig(**extra["model_config"])
    if use_pallas is not None and use_pallas != cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    model = build_model(cfg)
    n = int(extra.get("n_clients", 1))
    sparams, _step = restore_into(stacked_example(model, n), path, device=dev)
    weights = np.asarray(extra.get("client_weights", [1.0] * n), np.float32)
    return model, reduce_clients(sparams, weights, client)


def make_engine(model: Model, params, *, max_seq: int = 0,
                buckets: Optional[Sequence[BucketSpec]] = None, slots: int = 8,
                n_buckets: int = 2, prefill_chunk: int = 0, device=None) -> ServeEngine:
    """A :class:`ServeEngine` with an explicit bucket layout or the
    default pow2 ladder up to ``max_seq``; on ``cuda`` unless ``device``
    is given."""
    if buckets is None:
        if max_seq <= 0:
            raise ValueError("need max_seq (or explicit buckets)")
        buckets = default_bucket_layout(max_seq, slots=slots, n_buckets=n_buckets)
    return ServeEngine(model, params, buckets, prefill_chunk=prefill_chunk, device=device)


def generate(model: Model, params, prompts: Sequence[np.ndarray], max_new_tokens: int = 16, *,
             eos_id: int = -1, max_seq: int = 0, buckets=None, slots: int = 8,
             n_buckets: int = 2, prefill_chunk: int = 0, return_engine: bool = False,
             device=None) -> List[ServeResult]:
    """Batch-generate through the continuous-batching engine: submit every
    prompt, drain, return the :class:`ServeResult` of each in submission
    order."""
    if max_seq <= 0 and buckets is None:
        max_seq = max(len(p) + max_new_tokens for p in prompts)
    eng = make_engine(model, params, max_seq=max_seq, buckets=buckets, slots=slots,
                      n_buckets=n_buckets, prefill_chunk=prefill_chunk, device=device)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=np.asarray(p, np.int32),
                           max_new_tokens=max_new_tokens, eos_id=eos_id))
    eng.run_until_drained()
    results = [eng.results[rid] for rid in range(len(prompts))]
    return (results, eng) if return_engine else results


def classify(model: Model, params, images: Sequence[np.ndarray],
             batch_buckets: Sequence[int] = (1, 4, 8), device=None) -> List[ClassifyResult]:
    """Batched image-classification scoring for the paper's CNN models,
    the DR-grading serve path."""
    clf = ImageClassifier(model, params, batch_buckets, device=device)
    return clf.classify([Request(rid=i, image=np.asarray(im)) for i, im in enumerate(images)])
