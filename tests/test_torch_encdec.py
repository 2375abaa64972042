"""The port's encdec and vlm families (whisper-base, internvl2-26b)
against the JAX reference on the CPU, on the reference's own weights
through the bridge: the configs, the sinusoidal positions, whisper's
encoder, forward, loss and gradients, its decode step on random
non-zero self and cross caches (also against the reference's Pallas
``flash_decode`` in interpret mode) and against its forward once the
cross cache holds the encoder's keys and values, its cache tree, the
per-token serve loop token for token, the engine's refusal; internvl's
forward with ``vision_embed`` in both layouts and its decode step at a
G = 6 smoke variant. fp32 smoke widths unless a test says otherwise."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serve import BucketSpec as JaxBucketSpec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train.steps import make_serve_step as jax_make_serve_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.launch.serve import loop_generate, run_serve  # noqa: E402
from repro_torch.models import build_model, layers, transformer  # noqa: E402
from repro_torch.serve import BucketSpec, ServeEngine  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

WHISPER, INTERNVL = "whisper-base", "internvl2-26b"


def _cfg(arch, **kw):
    """(reference config, the port's built from its asdict): smoke widths."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, expect, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(expect), rtol=rtol, atol=atol, err_msg=err_msg)


def _trees_close(got, expect, atol, rtol=0.0):
    tl = tree_paths_and_leaves(got)
    jl = tree_paths_and_leaves(_np(expect))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, a), (_, b) in zip(tl, jl):
        _close(a, b, atol, rtol, err_msg=p)


def _lm(arch, **kw):
    """(jcfg, cfg, reference model, port model, reference params, port params)."""
    jcfg, cfg = _cfg(arch, **kw)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(4))
    return jcfg, cfg, jm, tm, jp, bridge.params_from_numpy(_np(jp))


def _tokens(vocab, B, n, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


def _rows(cfg, B, n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)) * scale).astype(
        np.float32)


def _batch(cfg, B, S, seed=2):
    """A train batch of the family's layout, labels with a few masked."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": _tokens(cfg.vocab_size, B, S, seed),
             "labels": rng.integers(-1, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["audio_embed"] = _rows(cfg, B, cfg.encoder_seq, seed + 1)
    if cfg.family == "vlm":
        batch["vision_embed"] = _rows(cfg, B, cfg.n_vision_tokens, seed + 1)
    return batch


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_config_is_the_references_full_and_smoke(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())


def test_full_widths_are_the_published_ones():
    w, v = get_config(WHISPER), get_config(INTERNVL)
    assert (w.family, w.n_layers, w.n_encoder_layers, w.d_model, w.n_heads, w.head_dim,
            w.encoder_seq, w.vocab_size) == ("encdec", 6, 6, 512, 8, 64, 1500, 51865)
    assert (v.family, v.n_layers, v.d_model, v.n_heads, v.n_kv_heads, v.head_dim, v.d_ff,
            v.vocab_size, v.n_vision_tokens) == ("vlm", 48, 6144, 48, 8, 128, 16384, 92553, 256)


# ------------------------------------------------------------------ layers


def test_sinusoidal_positions_match_reference():
    """atol 2e-5: fp32 sin / cos of the same angles, at angles up to
    1,499 rad (a few ulp of the angle)."""
    for n, d in ((7, 16), (1500, 512)):
        _close(layers.sinusoidal_positions(n, d), jax_layers.sinusoidal_positions(n, d), 2e-5)
    pos = torch.tensor([[0], [3], [1499]], dtype=torch.int32)
    _close(layers.sinusoidal_at(pos, 512), jax_layers.sinusoidal_positions(1500, 512)[
        np.array([0, 3, 1499])], 2e-5)


# ------------------------------------------------------------------ whisper


def test_encdec_tree_matches_reference():
    jcfg, cfg, jm, tm, jp, _ = _lm(WHISPER)
    ours = [(p, tuple(t.shape), t.dtype) for p, t in
            tree_paths_and_leaves(tm.init(torch.Generator().manual_seed(0)))]
    theirs = [(p, tuple(a.shape), bridge.tree_from_numpy(a).dtype)
              for p, a in tree_paths_and_leaves(_np(jp))]
    assert ours == theirs
    assert {"encoder", "decoder", "lm_head", "enc_final_norm"} <= set(jp)
    assert len(jp["encoder"]) == cfg.n_encoder_layers and len(jp["decoder"]) == cfg.n_layers


def test_encdec_encode_matches_reference():
    """atol 2e-5: fp32, O(1) activations through 2 layers."""
    jcfg, cfg, jm, tm, jp, tp = _lm(WHISPER)
    audio = _rows(cfg, 2, cfg.encoder_seq, 3)
    _close(transformer.encdec_encode(tp, torch.from_numpy(audio), cfg),
           jax_tf.encdec_encode(jp, jnp.asarray(audio), jcfg), 2e-5)


def test_encdec_forward_loss_and_grads_match_reference():
    """Logits atol 1e-4 (fp32 logits of O(1) through the encoder and
    decoder), loss rtol 1e-5, every gradient leaf atol 2e-5 + rtol 1e-3
    against ``jax.grad``."""
    jcfg, cfg, jm, tm, jp, tp = _lm(WHISPER)
    batch = _batch(cfg, 2, 12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(tm.forward(tp, tb)[0], jm.forward(jp, jb)[0], 1e-4)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    tgrads, (tloss, tmet) = torch.func.grad_and_value(tm.loss, has_aux=True)(tp, tb)
    _close(tloss, jloss, 0, 1e-5)
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-7)
    _trees_close(tgrads, jgrads, 2e-5, 1e-3)


def _cross_and_self(cfg, jm, B, S, seed):
    """A reference cache of random non-zero self and cross entries."""
    rng = np.random.default_rng(seed)
    cache = _np(jm.init_cache(B, S))

    def fill(a):
        return (rng.normal(size=a.shape) * 0.7).astype(np.float32)

    return {"self": [{k: fill(v) for k, v in c.items()} for c in cache["self"]],
            "cross_k": fill(cache["cross_k"]), "cross_v": fill(cache["cross_v"])}


@pytest.mark.parametrize("pallas", [False, True])
def test_encdec_decode_step_matches_reference_on_nonzero_caches(pallas):
    """Decode steps at positions 0, 5 and 15 (the cache's last) on random
    non-zero self and cross caches: logits atol 1e-4 and the self cache
    as written, atol 1e-5, against the reference's jnp branch and its
    ``use_pallas=True`` branch (flash_decode in interpret mode)."""
    jcfg, cfg, jm, tm, jp, tp = _lm(WHISPER, use_pallas=pallas)
    B, S = 2, 16
    cache = _cross_and_self(cfg, jm, B, S, seed=5)
    jcache = jax.tree.map(jnp.asarray, cache)
    tcache = bridge.cache_from_numpy(cache)
    toks = _tokens(cfg.vocab_size, B, 3, seed=6)
    for i, pos in enumerate((0, 5, S - 1)):
        jl, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                                             jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), tcache, pos)
        _close(tl, jl, 1e-4, err_msg=f"pos {pos}")
    _trees_close(bridge.cache_to_numpy(tcache), jcache, 1e-5)


def test_encdec_decode_with_the_encoders_kv_is_the_forward():
    """With ``cross_k`` / ``cross_v`` set to each decoder layer's
    projections of the encoder's output, step-by-step decode gives the
    forward's logits (atol 1e-4): the cross path attends to all
    ``encoder_seq`` keys."""
    _, cfg, _, tm, _, tp = _lm(WHISPER)
    B, S = 2, 10
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S).items()}
    with torch.no_grad():
        full, _ = tm.forward(tp, batch)
        enc = transformer.encdec_encode(tp, batch["audio_embed"], cfg)
        cache = tm.init_cache(B, S, "cpu")
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        for i, p in enumerate(tp["decoder"]):
            a = p["cross_attn"]
            cache["cross_k"][i] = (enc @ a["wk"] + a["bk"]).reshape(B, -1, KV, hd)
            cache["cross_v"][i] = (enc @ a["wv"] + a["bv"]).reshape(B, -1, KV, hd)
        dec = torch.cat([tm.decode_step(tp, batch["tokens"][:, t:t + 1], cache, t)[0]
                         for t in range(S)], dim=1)
    torch.testing.assert_close(dec, full, rtol=0, atol=1e-4)


def test_encdec_decode_takes_a_scalar_position_only():
    _, cfg, _, tm, _, tp = _lm(WHISPER)
    cache = tm.init_cache(2, 8, "cpu")
    with pytest.raises(ValueError, match="one scalar position"):
        tm.decode_step(tp, torch.zeros((2, 1), dtype=torch.int32), cache,
                       torch.tensor([1, 2], dtype=torch.int32))
    out, _ = tm.decode_step(tp, torch.zeros((2, 1), dtype=torch.int32), cache,
                            torch.tensor(3, dtype=torch.int32))
    assert out.shape == (2, 1, cfg.padded_vocab)


@pytest.mark.parametrize("cache_dtype", ["", "float8_e4m3fn"])
def test_encdec_cache_tree_matches_reference(cache_dtype):
    """Structure, shapes and dtypes; under an fp8 ``cache_dtype`` the
    self cache is fp8 and the cross cache stays in ``cfg.dtype``."""
    jcfg, cfg = _cfg(WHISPER, cache_dtype=cache_dtype, dtype="bfloat16")
    theirs = jax_build_model(jcfg).init_cache(2, 9)
    ours = build_model(cfg).init_cache(2, 9, "cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in tree_paths_and_leaves(ours)] == \
        [(p, tuple(a.shape), bridge.tree_from_numpy(a).dtype)
         for p, a in tree_paths_and_leaves(_np(theirs))]
    assert ours["cross_k"].dtype == torch.bfloat16
    assert all(t.abs().max() == 0 for t in (ours["cross_k"], ours["cross_v"]))


def _reference_loop(jm, jp, prompts, T):
    """The reference's ``run_serve`` loop: ``prefill_into_cache``, then
    ``make_serve_step`` a token."""
    B, P = prompts.shape
    tok, cache = jax_prefill_into_cache(jm, jp, jnp.asarray(prompts), jm.init_cache(B, P + T + 1))
    step = jax.jit(jax_make_serve_step(jm))
    out = [tok]
    for i in range(T - 1):
        tok, _, cache = step(jp, out[-1][:, None], cache, jnp.asarray(P + i, jnp.int32))
        out.append(tok)
    return np.asarray(jnp.stack(out, axis=1), np.int32)


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_loop_generations_match_reference_token_for_token(arch):
    """The per-token loop on the same prompts and params as the
    reference's loop: every token equal (whisper against its all-zero
    cross cache, as both packages serve it)."""
    jcfg, cfg, jm, tm, jp, tp = _lm(arch)
    B, P, T = 2, 5, 6
    prompts = _tokens(cfg.vocab_size, B, P, seed=7)
    got = loop_generate(tm, tp, torch.from_numpy(prompts), T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _reference_loop(jm, jp, prompts, T))


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_run_serve_takes_the_loop_and_the_engine_refuses(arch):
    gen, info = run_serve(arch, batch=2, prompt_len=4, tokens=3, device="cpu")
    assert info["path"] == "loop" and gen.shape == (2, 3) and gen.dtype == np.int32
    assert ((0 <= gen) & (gen < get_config(arch).smoke().padded_vocab)).all()
    cut, _ = run_serve(arch, batch=2, prompt_len=4, tokens=3, device="cpu", layers=1)
    assert cut.shape == (2, 3)
    jcfg, cfg, jm, tm, jp, tp = _lm(arch)
    with pytest.raises(ValueError) as jerr:
        JaxServeEngine(jm, jp, (JaxBucketSpec(2, 16),))
    with pytest.raises(ValueError) as terr:
        ServeEngine(tm, tp, (BucketSpec(2, 16),), device="cpu")
    assert f"got family '{cfg.family}'" in str(terr.value) and "encdec/vlm" in str(terr.value)
    assert f"got family '{cfg.family}'" in str(jerr.value)


# ------------------------------------------------------------------ internvl


@pytest.mark.parametrize("scan", [False, True])
def test_vlm_forward_loss_and_grads_match_reference(scan):
    """``vision_embed`` before the tokens, the vision rows' logits sliced
    off, in both layouts: logits atol 1e-4, loss rtol 1e-5, gradients
    (the vision rows' too, through ``jax.grad`` of the batch) atol 2e-5 +
    rtol 1e-3."""
    jcfg, cfg, jm, tm, jp, tp = _lm(INTERNVL, scan_layers=scan)
    assert ("layers" in jp) == scan
    batch = _batch(cfg, 2, 10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits = tm.forward(tp, tb)[0]
    assert tlogits.shape == (2, 10, cfg.padded_vocab)
    _close(tlogits, jm.forward(jp, jb)[0], 1e-4)
    (jloss, _), (jgrads, jgv) = jax.jit(jax.value_and_grad(
        lambda p, ve: jm.loss(p, {**jb, "vision_embed": ve}), argnums=(0, 1),
        has_aux=True))(jp, jb["vision_embed"])
    (tgrads, tgv), (tloss, _) = torch.func.grad_and_value(
        lambda p, ve: tm.loss(p, {**tb, "vision_embed": ve}), argnums=(0, 1),
        has_aux=True)(tp, tb["vision_embed"])
    _close(tloss, jloss, 0, 1e-5)
    _trees_close(tgrads, jgrads, 2e-5, 1e-3)
    _close(tgv, jgv, 2e-5, 1e-3)


@pytest.mark.parametrize("pallas", [False, True])
def test_vlm_decode_at_six_query_heads_a_kv_head_matches_reference(pallas):
    """internvl's G = 6 (48/8 heads) at smoke width: 6 query heads on 1
    kv head, decode steps at positions 0, 4 and 11 on a random non-zero
    scanned cache; logits atol 1e-4 and the cache atol 1e-5, against the
    reference's jnp and Pallas (interpret mode) branches."""
    jcfg, cfg, jm, tm, jp, tp = _lm(INTERNVL, n_heads=6, n_kv_heads=1, use_pallas=pallas,
                                    scan_layers=True)
    assert cfg.n_heads // cfg.n_kv_heads == 6
    B, S = 2, 12
    rng = np.random.default_rng(9)
    cache = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.7).astype(np.float32),
                         _np(jm.init_cache(B, S)))
    jcache, tcache = jax.tree.map(jnp.asarray, cache), bridge.cache_from_numpy(cache)
    toks = _tokens(cfg.vocab_size, B, 3, seed=10)
    for i, pos in enumerate((0, 4, S - 1)):
        jl, jcache = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                                             jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]), tcache, pos)
        _close(tl, jl, 1e-4, err_msg=f"pos {pos}")
    _trees_close(bridge.cache_to_numpy(tcache), jcache, 1e-5)
    assert tm.prefill is None and jm.prefill is None
