"""Unified model interface (counterpart of ``repro.models.model``).

``build_model(cfg)`` returns a :class:`Model` whose members are plain
functions over parameter trees, so the swarm layer can vmap them over
a client-stacked tree with ``torch.func``. The CNN family and the
dense, moe, ssm and hybrid decoder-only LMs (with their caches and
decode step), the vlm (whose batches add ``"vision_embed"``) and the
encoder-decoder (``"audio_embed"``, a dict cache ``{"self", "cross_k",
"cross_v"}``) are ported, and the swarm trains them through these
functions (an LM's batches are ``{"tokens", "labels"}`` and its accuracy
counts unmasked tokens). Only the dense and moe families have a chunked
``prefill``, as in the reference: an SSM state cannot mask padded
prompt tails after the fact, and the reference gives vlm and encdec
none, so ssm, hybrid, vlm and encdec serve through the per-token loop
(``launch/serve.run_serve``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import cnn as cnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.layers import dtype_of
from repro_torch.sharding.rules import sharding_active
from repro_torch.utils.tree import tree_leaves, tree_map


def cross_entropy(logits, labels):
    """Mean cross-entropy in fp32; labels < 0 are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    if sharding_active():
        # a gather over vocab shards has no clean placement rule; the
        # select sums each shard's part (the reference's form, equal to
        # the gather: one term of the sum is not 0)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        label_logit = torch.sum(torch.where(vocab == safe[..., None], logits, 0.0), dim=-1)
    else:
        label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - label_logit, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def argmax_last(logits):
    """``torch.argmax`` over the last axis; under a placement context two
    reductions (the first index of the maximum, argmax's tie rule), which
    split over vocab shards where DTensor's argmax does not."""
    if not sharding_active():
        return torch.argmax(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    top = torch.amax(logits, dim=-1, keepdim=True)
    return torch.amin(torch.where(logits == top, vocab, logits.shape[-1]), dim=-1)


def accuracy(logits, labels):
    """Share of unmasked rows (labels >= 0) whose argmax is the label."""
    mask = labels >= 0
    hit = (argmax_last(logits) == labels) & mask
    return hit.sum() / torch.clamp(mask.sum(), min=1)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Any]        # generator -> params
    forward: Callable[[Any, dict], tuple]         # (params, batch) -> (logits, aux)
    loss: Callable[[Any, dict], tuple]            # (params, batch) -> (loss, metrics)
    init_cache: Optional[Callable] = None         # (batch, max_seq, device) -> cache
    decode_step: Optional[Callable] = None        # (params, tok, cache, pos) -> (logits, cache)
    prefill: Optional[Callable] = None            # (params, toks, cache, pos0) -> (logits, cache)

    def param_count(self, params) -> int:
        return sum(x.numel() for x in tree_leaves(params))


def _lm_loss(fwd):
    def loss(params, batch):
        logits, aux = fwd(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux,
                       "acc": accuracy(logits, batch["labels"])}
    return loss


@functools.cache
def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        def fwd(params, batch):
            logits = cnn_lib.apply_cnn(params, batch["images"], cfg)
            return logits, torch.zeros((), device=logits.device)

        def loss(params, batch):
            logits, _ = fwd(params, batch)
            ce = cross_entropy(logits, batch["labels"])
            return ce, {"loss": ce, "ce": ce, "acc": accuracy(logits, batch["labels"])}

        return Model(cfg, lambda gen: cnn_lib.init_cnn(gen, cfg), fwd, loss)

    if cfg.family == "encdec":
        def encdec_fwd(params, batch):
            return tf_lib.encdec_forward(params, batch, cfg)

        return Model(
            cfg,
            lambda gen: tf_lib.init_encdec(gen, cfg),
            encdec_fwd,
            _lm_loss(encdec_fwd),
            init_cache=lambda b, s, device: tf_lib.init_encdec_cache(cfg, b, s, device),
            decode_step=lambda p, t, c, pos: tf_lib.encdec_decode_step(p, t, c, pos, cfg),
        )

    # decoder-only families: dense / moe / ssm / hybrid / vlm
    def lm_fwd(params, batch):
        return tf_lib.lm_forward(params, batch, cfg)

    return Model(
        cfg,
        lambda gen: tf_lib.init_lm(gen, cfg),
        lm_fwd,
        _lm_loss(lm_fwd),
        init_cache=lambda b, s, device: tf_lib.init_lm_cache(cfg, b, s, device),
        decode_step=lambda p, t, c, pos: tf_lib.lm_decode_step(p, t, c, pos, cfg),
        prefill=(lambda p, t, c, pos0: tf_lib.lm_prefill(p, t, c, pos0, cfg))
        if cfg.family in ("dense", "moe") else None,
    )


# ---------------------------------------------------------------------------
# abstract inputs for the dry-run: ``meta`` tensors, nothing allocated


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins of one (arch x input shape) pair's inputs, the
    reference's shapes and dtypes: a whole batch for the train step or
    the forward, ``{"tokens": (B,1), "pos": ()}`` for the decode step
    (its cache is :func:`cache_specs`). encdec's text is ``min(448, S)``
    tokens beside S audio frames; vlm's is ``S - n_vision_tokens``."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def sd(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if cfg.family == "cnn":
        return {"images": sd((B, 32, 32, 3), torch.float32), "labels": sd((B,), i32)}
    act = dtype_of(cfg.dtype)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            S_dec = min(448, S)
            return {"audio_embed": sd((B, S, cfg.d_model), act),
                    "tokens": sd((B, S_dec), i32), "labels": sd((B, S_dec), i32)}
        if cfg.family == "vlm":
            S_text = S - cfg.n_vision_tokens
            return {"vision_embed": sd((B, cfg.n_vision_tokens, cfg.d_model), act),
                    "tokens": sd((B, S_text), i32), "labels": sd((B, S_text), i32)}
        return {"tokens": sd((B, S), i32), "labels": sd((B, S), i32)}
    return {"tokens": sd((B, 1), i32), "pos": sd((), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache tree of ``shape`` (batch, seq_len) on ``meta``."""
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len, torch.device("meta"))


def abstract_params(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors of the init's shapes and
    dtypes (the counterpart of ``jax.eval_shape(model.init)``): the init
    runs under ``FakeTensorMode``, so a full-size model never allocates."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = build_model(cfg).init(torch.Generator().manual_seed(0))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)
