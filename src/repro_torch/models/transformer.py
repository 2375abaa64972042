"""Model assembly for every family of the reference (counterpart of
``repro.models.transformer``).

``dense`` is ``[attn + MLP] x L`` (granite); ``moe`` is ``[attn + MoE]``
with leading dense layers (kimi-k2's first) or a dense layer every
``moe_every``-th (llama4-maverick); ``ssm`` is ``[Mamba2/SSD] x L``
(mamba2-370m); ``hybrid`` is a Mamba2 backbone with ONE shared
attention block (``params["shared_attn"]``) applied after every
``attn_every``-th layer (zamba2), its KV cache interleaved in the cache
list after that layer's SSM cache, as in the reference; ``vlm`` is the
dense stack with stub patch embeddings (``batch["vision_embed"]``)
prepended to the token stream (internvl2); ``encdec`` is a bidirectional
encoder and a causal decoder with cross-attention, sinusoidal positions
and an untied read-out (whisper). Any other family builds the dense
stack, as the reference's does. The decoder-only parameters come
in the reference's two layouts: ``"blocks"``, a list of per-layer dicts, or,
under ``cfg.scan_layers``, ``"layers": {"prefix": [...], "period0":
<leaves stacked on a leading L axis>}`` with the cache as
``{"prefix": [...], "body": {"period0": {"k", "v": (L,B,S,KV,hd)}}}``
(a moe model's period may hold several kinds, ``period0``,
``period1``, ...).
The port keeps the stacked tensors and loops over the layer index in
Python (per-layer views, so in-place cache writes land in the stacked
cache), so the bridge stays the identity. ssm and hybrid use the
``"blocks"`` list in both packages; encdec has its own
``"encoder"`` / ``"decoder"`` lists.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_embedding,
    apply_mlp,
    apply_norm,
    dense_init,
    dtype_of,
    init_embedding,
    init_mlp,
    init_norm,
    logits_from_embedding,
    sinusoidal_at,
    sinusoidal_positions,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding import shard_act
from repro_torch.utils.tree import tree_leaves, tree_map


def layer_kinds(cfg: ModelConfig):
    """Per-layer block kind list."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            kinds.append("ssm")
        elif cfg.family == "moe":
            if i < cfg.n_dense_layers or (cfg.moe_every > 1 and i % cfg.moe_every == 0):
                kinds.append("dense")
            else:
                kinds.append("moe")
        else:
            kinds.append("dense")
    return kinds


# ---------------------------------------------------------------------------
# single block


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, lead=()):
    if kind == "ssm":                    # never stacked: ssm and hybrid are not scannable
        return {"ssm_norm": init_norm(gen, cfg, cfg.d_model),
                "ssm": ssm_lib.init_ssm(gen, cfg)}
    p = {"attn_norm": init_norm(gen, cfg, cfg.d_model, lead),
         "attn": attn_lib.init_attention(gen, cfg, lead=lead),
         "mlp_norm": init_norm(gen, cfg, cfg.d_model, lead)}
    if kind == "moe":
        p["moe"] = init_moe(gen, cfg, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, lead)
    return p


def _ffn(p, h, cfg: ModelConfig, kind: str):
    """The block's feed-forward half: (out, aux loss)."""
    if kind == "moe":
        return apply_moe(p["moe"], h, cfg)
    return apply_mlp(p["mlp"], h, cfg), torch.zeros((), device=h.device)


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, device, lead=()):
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, device)
    return attn_lib.init_kv_cache(cfg, batch, max_seq, device, lead)


def apply_block(p, x, cfg: ModelConfig, kind: str, *, positions=None, cache=None, pos=None,
                sliding_window=0):
    """Returns (x, cache, aux_loss); the cache is written in place."""
    if kind == "ssm":
        h = apply_norm(p["ssm_norm"], x, cfg)
        if cache is None:
            out, _ = ssm_lib.apply_ssm(p["ssm"], h, cfg)
        else:
            out, cache = ssm_lib.apply_ssm_decode(p["ssm"], h, cache, cfg)
        return x + out, cache, torch.zeros((), device=x.device)
    h = apply_norm(p["attn_norm"], x, cfg)
    if cache is None:
        a = attn_lib.attend_full(p["attn"], h, cfg, positions=positions, causal=True,
                                 sliding_window=sliding_window)
    else:
        a, cache = attn_lib.attend_decode(p["attn"], h, cache, pos, cfg,
                                          sliding_window=sliding_window)
    x = x + a
    m, aux = _ffn(p, apply_norm(p["mlp_norm"], x, cfg), cfg, kind)
    return x + m, cache, aux


# ---------------------------------------------------------------------------
# layer plan


def _scannable(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "moe", "vlm")


def _scan_plan(cfg: ModelConfig):
    """(prefix_kinds, period_kinds, n_periods): leading unscanned layers
    and a repeating stacked period."""
    kinds = layer_kinds(cfg)
    prefix = kinds[: cfg.n_dense_layers]
    body = kinds[cfg.n_dense_layers:]
    period = max(cfg.moe_every, 1) if cfg.family == "moe" else 1
    if len(body) % period:
        extra = len(body) % period
        prefix = prefix + body[:extra]
        body = body[extra:]
    return prefix, body[:period], len(body) // period


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether hybrid's shared attention block runs after layer i."""
    return cfg.family == "hybrid" and bool(cfg.attn_every) and (i + 1) % cfg.attn_every == 0


def _each_layer(params, caches, cfg: ModelConfig):
    """(kind, block params, block cache or None) for every block in
    order, hybrid's shared attention block (kind ``"dense"``) after every
    ``attn_every``-th layer with the next cache of the list. Stacked
    leaves are indexed per layer: views, so writes into a layer's cache
    land in the stacked cache."""
    kinds = layer_kinds(cfg)
    if "blocks" in params:
        ci = 0
        for i, p in enumerate(params["blocks"]):
            blocks = [(kinds[i], p)]
            if _shared_after(cfg, i):
                blocks.append(("dense", params["shared_attn"]))
            for kind, bp in blocks:
                yield kind, bp, None if caches is None else caches[ci]
                ci += 1
        return
    lp = params["layers"]
    prefix, period_kinds, n_periods = _scan_plan(cfg)
    for i, p in enumerate(lp["prefix"]):
        yield prefix[i], p, None if caches is None else caches["prefix"][i]
    for layer in range(n_periods):
        for j, kind in enumerate(period_kinds):
            name = f"period{j}"
            cache = None if caches is None else tree_map(lambda t: t[layer], caches["body"][name])
            yield kind, tree_map(lambda t: t[layer], lp[name]), cache


# ---------------------------------------------------------------------------
# decoder-only LM


def init_lm(gen: torch.Generator, cfg: ModelConfig):
    kinds = layer_kinds(cfg)
    params: Dict[str, Any] = {
        "embedding": init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg),
        "final_norm": init_norm(gen, cfg, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                             dtype=dtype_of(cfg.param_dtype))}
    if cfg.family == "hybrid":
        params["shared_attn"] = init_block(gen, cfg, "dense")
    if cfg.scan_layers and _scannable(cfg):
        prefix, period_kinds, n_periods = _scan_plan(cfg)
        layers: Dict[str, Any] = {"prefix": [init_block(gen, cfg, k) for k in prefix]}
        for j, kind in enumerate(period_kinds):
            layers[f"period{j}"] = init_block(gen, cfg, kind, lead=(n_periods,))
        params["layers"] = layers
    else:
        params["blocks"] = [init_block(gen, cfg, kinds[i]) for i in range(cfg.n_layers)]
    return params


def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    if cfg.scan_layers and _scannable(cfg):
        prefix, period_kinds, n_periods = _scan_plan(cfg)
        return {"prefix": [block_cache(cfg, k, batch, max_seq, device) for k in prefix],
                "body": {f"period{j}": block_cache(cfg, kind, batch, max_seq, device,
                                                   lead=(n_periods,))
                         for j, kind in enumerate(period_kinds)}}
    caches = []
    for i, kind in enumerate(layer_kinds(cfg)):
        caches.append(block_cache(cfg, kind, batch, max_seq, device))
        if _shared_after(cfg, i):
            caches.append(block_cache(cfg, "dense", batch, max_seq, device))
    return caches


def _readout(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        logits = logits_from_embedding(params["embedding"],
                                       apply_norm(params["final_norm"], x, cfg))
    else:
        logits = _head(params, x, cfg)
    return shard_act(logits, *(("batch",) + ("seq",) * (logits.dim() - 2) + ("act_mlp",)))


def _head(params, x, cfg: ModelConfig):
    """The final norm, then the untied ``lm_head``."""
    x = apply_norm(params["final_norm"], x, cfg)
    return x @ params["lm_head"]["w"].to(x.dtype)


# ---------------------------------------------------------------------------
# rematerialisation (the reference's ``jax.checkpoint`` around a block)


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, in
    ``tree_leaves`` order: sorted dict keys, list indices) at its leaves."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(t, leaves) for t in tree]
    return next(leaves)


_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}


def _is_weight_product(func, args) -> bool:
    """A product with no batch dims: ``x @ w`` with a 2-D right operand,
    what ``checkpoint_dots_with_no_batch_dims`` saves (the attention
    einsums and the experts' bmm have batch dims and are recomputed)."""
    return func in _MATMULS and len(args) == 2 and args[1].dim() == 2 and args[0].dim() >= 2


class _RecordProducts(torch.overrides.TorchFunctionMode):
    """Keeps the output of every weight product, in call order."""

    def __init__(self):
        super().__init__()
        self.outputs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _is_weight_product(func, args):
            self.outputs.append(out)
        return out


class _ReplayProducts(torch.overrides.TorchFunctionMode):
    """Gives the i-th weight product its saved output, with the product's
    gradient, instead of computing it again."""

    def __init__(self, saved):
        super().__init__()
        self.saved = iter(saved)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if _is_weight_product(func, args):
            return _SavedProduct.apply(args[0], args[1], next(self.saved))
        return func(*args, **(kwargs or {}))


class _SavedProduct(torch.autograd.Function):
    """``x @ w`` whose value was kept: returns it, and in backward gives
    ``g @ w.T`` and ``x.T @ g``."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, saved):
        return saved.view_as(saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.T
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw, None


class _Remat(torch.autograd.Function):
    """``run(*consts, *tensors) -> (x, aux)`` keeping only its inputs
    (and, with ``save_products``, the outputs of its weight products) for
    backward, which runs it again through ``torch.func.vjp`` over
    ``tensors``. ``consts`` (the positions) get no gradient; they are
    inputs, not closure captures, because a generated vmap rule cannot
    see captured tensors. Written for ``torch.func`` (``setup_context``,
    a generated vmap rule): the port's train step takes gradients with
    ``grad_and_value``, under which ``torch.utils.checkpoint`` does not
    run."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, save_products, n_const, *tensors):
        if not save_products:
            return run(*tensors)
        with _RecordProducts() as rec:
            out = run(*tensors)
        return (*out, *rec.outputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, save_products, n_const, *tensors = inputs
        ctx.run, ctx.n_const, ctx.n_in = run, n_const, len(tensors)
        ctx.save_for_backward(*tensors, *output[2:])

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        consts, tensors = saved[:ctx.n_const], saved[ctx.n_const:ctx.n_in]
        products = saved[ctx.n_in:]

        def run(*t):
            if not products:
                return ctx.run(*consts, *t)
            with _ReplayProducts(products):
                return ctx.run(*consts, *t)
        _, vjp_fn = torch.func.vjp(run, *tensors)
        # vjp's gradients are differentiable and would keep the recomputed
        # block's graph, and so its activations, alive to the end of the
        # backward pass
        g_in = [None if g is None else g.detach() for g in vjp_fn(tuple(grads[:2]))]
        return (None, None, None, *([None] * ctx.n_const), *g_in)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn(p, x, positions) -> (x, aux)`` under ``cfg.remat``: ``"none"``
    as it is, ``"full"`` keeping only the block's inputs for backward (the
    reference's ``jax.checkpoint``), ``"dots"`` keeping also the outputs
    of its weight products (``checkpoint_dots_with_no_batch_dims``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")

    def rematted(p, x, positions):
        def run(positions_, x_, *leaves):
            return fn(_rebuild(p, iter(leaves)), x_, positions_)
        out = _Remat.apply(run, cfg.remat == "dots", 1, positions, x, *tree_leaves(p))
        return out[0], out[1]
    return rematted


def lm_forward(params, batch, cfg: ModelConfig):
    """Train/prefill forward. batch: {"tokens": (B,S)[, "vision_embed"
    (B,n_vis,d) for vlm]}: the vision rows, cast to the activation dtype,
    go before the token embeddings, positions run over the joined
    sequence and the vision rows' logits are sliced off. Returns
    (logits (B,S,V), aux)."""
    x = apply_embedding(params["embedding"], batch["tokens"], cfg)
    if cfg.family == "vlm":
        x = torch.cat([batch["vision_embed"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x = shard_act(x, "batch", "seq", "embed")
    aux_total = torch.zeros((), device=x.device)
    for kind, p, _ in _each_layer(params, None, cfg):
        def block(p_, x_, positions_, kind=kind):
            y, _, aux_ = apply_block(p_, x_, cfg, kind, positions=positions_,
                                     sliding_window=cfg.sliding_window)
            return y, aux_
        x, aux = _maybe_remat(block, cfg)(p, x, positions)
        aux_total = aux_total + aux
    logits = _readout(params, x, cfg)
    if cfg.family == "vlm":
        logits = logits[:, batch["vision_embed"].shape[1]:, :]
    return logits, aux_total


def lm_decode_step(params, tokens, caches, pos, cfg: ModelConfig):
    """tokens (B,1) int; pos a scalar or (B,) per-row positions.
    Returns (logits (B,1,V), caches), the caches written in place."""
    x = shard_act(apply_embedding(params["embedding"], tokens, cfg), "batch", "seq", "embed")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    for kind, p, cache in _each_layer(params, caches, cfg):
        x, _, _ = apply_block(p, x, cfg, kind, cache=cache, pos=pos,
                              sliding_window=cfg.sliding_window)
    return _readout(params, x, cfg), caches


# ---------------------------------------------------------------------------
# chunked prefill (serving): one forward with KV-cache writeback


def _prefill_block(p, x, cache, pos0: int, cfg: ModelConfig, kind: str):
    """Attention-backed kinds only: an SSM state updated by padded prompt
    tails cannot be masked after the fact, so ssm and hybrid serve
    through the per-token loop."""
    if kind != "dense" and kind != "moe":
        raise NotImplementedError(f"chunked prefill supports attention blocks, got '{kind}'")
    h = apply_norm(p["attn_norm"], x, cfg)
    a, cache = attn_lib.attend_prefill(p["attn"], h, cache, pos0, cfg,
                                       sliding_window=cfg.sliding_window)
    x = x + a
    m, _ = _ffn(p, apply_norm(p["mlp_norm"], x, cfg), cfg, kind)
    return x + m, cache


def lm_prefill(params, tokens, caches, pos0: int, cfg: ModelConfig):
    """tokens (B,C) at positions ``pos0 .. pos0+C-1``: one forward through
    the stack writing each layer's k, v into the cache (in place).
    Returns (logits (B,C,V), caches); the caller picks the row of each
    request's last real prompt token."""
    x = shard_act(apply_embedding(params["embedding"], tokens, cfg), "batch", "seq", "embed")
    for kind, p, cache in _each_layer(params, caches, cfg):
        x, _ = _prefill_block(p, x, cache, pos0, cfg, kind)
    return _readout(params, x, cfg), caches


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)


def init_encdec(gen: torch.Generator, cfg: ModelConfig):
    """``{"embedding", "enc_final_norm", "final_norm", "encoder": [dense
    block] x n_encoder_layers, "decoder": [dense block + "cross_norm",
    "cross_attn"] x n_layers, "lm_head"}``, the reference's tree."""
    encoder = [init_block(gen, cfg, "dense") for _ in range(cfg.n_encoder_layers)]
    decoder = []
    for _ in range(cfg.n_layers):
        b = init_block(gen, cfg, "dense")
        b["cross_norm"] = init_norm(gen, cfg, cfg.d_model)
        b["cross_attn"] = attn_lib.init_attention(gen, cfg)
        decoder.append(b)
    return {"embedding": init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg),
            "enc_final_norm": init_norm(gen, cfg, cfg.d_model),
            "final_norm": init_norm(gen, cfg, cfg.d_model),
            "encoder": encoder,
            "decoder": decoder,
            "lm_head": {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                        dtype=dtype_of(cfg.param_dtype))}}


def encdec_encode(params, audio_embed, cfg: ModelConfig):
    """audio_embed (B, S_enc, d), the frontend stub's frame embeddings ->
    the encoder's (B, S_enc, d): sinusoidal positions, bidirectional
    attention."""
    _, S, d = audio_embed.shape
    dt = dtype_of(cfg.dtype)
    x = audio_embed.to(dt) + sinusoidal_positions(S, d, audio_embed.device).to(dt)[None]
    for p in params["encoder"]:
        x = x + attn_lib.attend_full(p["attn"], apply_norm(p["attn_norm"], x, cfg), cfg,
                                     causal=False)
        x = x + apply_mlp(p["mlp"], apply_norm(p["mlp_norm"], x, cfg), cfg)
    return apply_norm(params["enc_final_norm"], x, cfg)


def encdec_forward(params, batch, cfg: ModelConfig):
    """batch: {"audio_embed": (B,S_enc,d), "tokens": (B,S_dec)}: causal
    self-attention, then cross-attention to the encoder's output, then
    the MLP, in each decoder block. Returns (logits (B,S_dec,V), 0)."""
    enc = encdec_encode(params, batch["audio_embed"], cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = apply_embedding(params["embedding"], tokens, cfg)
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for p in params["decoder"]:
        x = x + attn_lib.attend_full(p["attn"], apply_norm(p["attn_norm"], x, cfg), cfg,
                                     positions=positions, causal=True)
        x = x + attn_lib.attend_full(p["cross_attn"], apply_norm(p["cross_norm"], x, cfg), cfg,
                                     x_kv=enc, causal=False)
        x = x + apply_mlp(p["mlp"], apply_norm(p["mlp_norm"], x, cfg), cfg)
    return _head(params, x, cfg), torch.zeros((), device=x.device)


def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """``{"self": [k, v cache] x n_layers, "cross_k", "cross_v":
    (n_layers, B, encoder_seq, KV, hd)}``. The cross cache is zeros in
    ``cfg.dtype`` (not ``cache_dtype``), as the reference's: nothing
    runs the encoder into it when serving."""
    shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg.dtype)
    return {"self": [attn_lib.init_kv_cache(cfg, batch, max_seq, device)
                     for _ in range(cfg.n_layers)],
            "cross_k": torch.zeros(shape, dtype=dt, device=device),
            "cross_v": torch.zeros(shape, dtype=dt, device=device)}


def encdec_decode_step(params, tokens, caches, pos, cfg: ModelConfig):
    """tokens (B,1) int at ``pos``, one scalar position for every row (the
    reference's sinusoidal term takes no per-row positions): self-attention
    through the cache (written in place), cross-attention against
    ``cross_k[i]``, ``cross_v[i]`` with all ``encoder_seq`` keys valid.
    Returns (logits (B,1,V), caches)."""
    x = apply_embedding(params["embedding"], tokens, cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos.dim():
        raise ValueError(f"encdec decode takes one scalar position, got shape "
                         f"{tuple(pos.shape)}")
    x = x + sinusoidal_at(pos.reshape(1, 1), cfg.d_model).to(x.dtype)[None]
    for i, p in enumerate(params["decoder"]):
        a, _ = attn_lib.attend_decode(p["attn"], apply_norm(p["attn_norm"], x, cfg),
                                      caches["self"][i], pos, cfg)
        x = x + a
        cross = {"k": caches["cross_k"][i], "v": caches["cross_v"][i]}
        a, _ = attn_lib.attend_decode(p["cross_attn"], apply_norm(p["cross_norm"], x, cfg),
                                      cross, cfg.encoder_seq - 1, cfg, update_cache=False)
        x = x + a
        x = x + apply_mlp(p["mlp"], apply_norm(p["mlp_norm"], x, cfg), cfg)
    return _head(params, x, cfg), caches
