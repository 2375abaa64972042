"""The port's dense LM against the JAX reference on the CPU: the config
carried 1:1, the layers (RMSNorm, split-half RoPE, swiglu), attention
(prefill, full, and decode with scalar, per-row, windowed and ring
positions, against the reference's ``use_pallas=True`` branch, whose
Pallas kernel runs in interpret mode here), and the whole stack's
prefill and decode logits in both parameter layouts, all on the
reference's own weights through the bridge. fp32 throughout
(``granite-3-2b``'s smoke config)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.utils.tree import tree_paths_and_leaves as jax_paths  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.models import attention, build_model, layers, transformer  # noqa: E402
from repro_torch.utils.tree import tree_map, tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

ARCH = "granite-3-2b"


def _cfg(**kw):
    """(reference config, the port's built from its asdict)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, expect, atol, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(expect), rtol=0, atol=atol, err_msg=err_msg)


# ------------------------------------------------------------------ config


def test_granite_config_is_the_references():
    ours, theirs = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.n_layers, ours.d_model, ours.n_heads, ours.n_kv_heads, ours.head_dim,
            ours.d_ff, ours.vocab_size) == (40, 2048, 32, 8, 64, 8192, 49155)
    assert ours.tie_embeddings and ours.scan_layers and ours.dtype == "bfloat16"
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-370m", "kimi-k2-1t-a32b",
                                  "whisper-base", "internvl2-26b", "squeezenet-dr"])
def test_every_reference_config_builds_the_ports_one_to_one(arch):
    jcfg = jax_get_config(arch)
    ours = ModelConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(ours) == dataclasses.asdict(jcfg)
    for prop in ("padded_vocab", "d_inner", "n_ssm_heads", "is_attention_free"):
        assert getattr(ours, prop) == getattr(jcfg, prop), prop


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_reference_arch_builds_in_the_port(arch):
    """The registered config builds (no init at full size), and at smoke
    size the port's parameter tree has the reference's paths, shapes and
    dtypes (the reference's through ``jax.eval_shape``)."""
    assert build_model(get_config(arch)).cfg.arch_id == arch
    jcfg = jax_get_config(arch).smoke()
    theirs = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    ours = build_model(ModelConfig(**dataclasses.asdict(jcfg))).init(
        torch.Generator().manual_seed(0))
    assert [(p, tuple(t.shape), str(t.dtype)[6:]) for p, t in tree_paths_and_leaves(ours)] == \
        [(p, tuple(a.shape), str(a.dtype)) for p, a in jax_paths(theirs)]


# ------------------------------------------------------------------ layers


def test_norm_rope_mlp_match_reference():
    """atol 1e-5: fp32, the same formulas, sums in another order."""
    jcfg, cfg = _cfg()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32) * 3.0
    scale = rng.normal(size=(cfg.d_model,)).astype(np.float32)
    _close(layers.apply_norm({"scale": _t(scale)}, _t(x), cfg),
           jax_layers.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), jcfg), 1e-5)

    xh = rng.normal(size=(2, 7, 4, cfg.head_dim)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 50, 500, 2047], [9, 8, 7, 6, 5, 4, 3]], np.int32)
    _close(layers.apply_rope(_t(xh), _t(pos), cfg.rope_theta),
           jax_layers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), jcfg.rope_theta), 1e-5)

    jp = jax_layers.init_mlp(jax.random.PRNGKey(1), jcfg)
    _close(layers.apply_mlp(bridge.params_from_numpy(_np(jp)), _t(x), cfg),
           jax_layers.apply_mlp(jp, jnp.asarray(x), jcfg), 1e-5)


def test_rope_is_split_half_not_interleaved():
    """The rotation pairs dim i with dim i + hd/2."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.tensor([[1]]), 10_000.0)
    assert out[..., 4].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[..., 1].item() == 0.0


# --------------------------------------------------------------- attention


def _attn_setup(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    jp = _np(jax_attn.init_attention(jax.random.PRNGKey(seed), jcfg))
    KV, hd = jcfg.n_kv_heads, jcfg.head_dim
    cache = {"k": rng.normal(size=(B, S, KV, hd)).astype(np.float32),
             "v": rng.normal(size=(B, S, KV, hd)).astype(np.float32)}
    return rng, jp, cache


@pytest.mark.parametrize("pos,window,ring", [
    (5, 0, False),                      # scalar pos
    ([3, 11], 0, False),                # per-row positions (serve slots)
    ([0, 23], 0, False),                # the first and the last slot
    ([9, 20], 6, False),                # sliding window, per-row
    (14, 6, False),                     # sliding window, scalar
    ([10, 3], 8, True),                 # ring cache: row 0 has wrapped
])
def test_attend_decode_matches_reference_pallas_path(pos, window, ring):
    """Against the reference's use_pallas=True branch (flash_decode in
    interpret mode): the output and the written cache. atol 1e-5."""
    jcfg, cfg = _cfg(use_pallas=True, sliding_window=window, cache_ring=ring)
    S = 8 if ring else 24
    B = 2
    rng, jp, cache = _attn_setup(jcfg, B, S, seed=3)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jpos = jnp.asarray(pos, jnp.int32)
    jout, jcache = jax_attn.attend_decode(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                                          jpos, jcfg, sliding_window=window)
    out, tcache = attention.attend_decode(bridge.params_from_numpy(jp), _t(x),
                                          bridge.cache_from_numpy(cache),
                                          torch.tensor(pos, dtype=torch.int32), cfg,
                                          sliding_window=window)
    _close(out, jout, 1e-5)
    _close(tcache["k"], jcache["k"], 1e-5)
    _close(tcache["v"], jcache["v"], 1e-5)


@pytest.mark.parametrize("pos0,window", [(0, 0), (8, 0), (8, 5), (20, 0)])
def test_attend_prefill_matches_reference(pos0, window):
    """A chunk of 8 at ``pos0`` into a cache of 24 (pos0=20 clamps the
    write to 16 as dynamic_update_slice does). atol 1e-5."""
    jcfg, cfg = _cfg(sliding_window=window)
    rng, jp, cache = _attn_setup(jcfg, 2, 24, seed=4)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    jout, jcache = jax_attn.attend_prefill(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache),
                                           jnp.int32(pos0), jcfg, sliding_window=window)
    out, tcache = attention.attend_prefill(bridge.params_from_numpy(jp), _t(x),
                                           bridge.cache_from_numpy(cache), pos0, cfg,
                                           sliding_window=window)
    _close(out, jout, 1e-5)
    _close(tcache["k"], jcache["k"], 1e-5)
    _close(tcache["v"], jcache["v"], 1e-5)


@pytest.mark.parametrize("window,chunked", [(0, False), (4, False), (0, True)])
def test_attend_full_matches_reference(monkeypatch, window, chunked):
    """Causal attention over a sequence; ``chunked`` lowers the q-chunk
    threshold on both sides so the chunked branch runs. atol 1e-5."""
    jcfg, cfg = _cfg(attn_chunk_q=4 if chunked else 0)
    if chunked:
        monkeypatch.setattr(jax_attn, "CHUNK_THRESHOLD", 8)
        monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 8)
    rng, jp, _ = _attn_setup(jcfg, 2, 1, seed=5)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    _close(attention.attend_full(bridge.params_from_numpy(jp), _t(x), cfg,
                                 sliding_window=window),
           jax_attn.attend_full(jp, jnp.asarray(x), jcfg, sliding_window=window), 1e-5)


def test_ring_cache_clamps_to_the_window():
    _, cfg = _cfg(sliding_window=8, cache_ring=True)
    c = attention.init_kv_cache(cfg, 2, 32, "cpu")
    assert c["k"].shape == (2, 8, cfg.n_kv_heads, cfg.head_dim)


# ------------------------------------------------------------------ stack


@pytest.mark.parametrize("scan", [False, True])
def test_lm_prefill_and_decode_logits_match_reference(scan):
    """Two prefill chunks, then two per-row decode steps, both layouts:
    logits at atol 1e-4, and the caches after. The reference decodes
    through its use_pallas=True branch."""
    jcfg, cfg = _cfg(scan_layers=scan, use_pallas=True)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(_np(jparams))
    assert ("layers" in tparams) == scan
    jcache = jm.init_cache(2, 24)
    tcache = bridge.cache_from_numpy(_np(jcache))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    for c0 in (0, 8):
        jl, jcache = jm.prefill(jparams, jnp.asarray(toks[:, c0:c0 + 8]), jcache, jnp.int32(c0))
        tl, tcache = tm.prefill(tparams, _t(toks[:, c0:c0 + 8]), tcache, c0)
        _close(tl, jl, 1e-4, f"prefill chunk at {c0}")
    pos = np.array([16, 11], np.int32)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, _t(tok), tcache, _t(pos))
        _close(tl, jl, 1e-4, f"decode step {step}")
        pos = pos + 1
    for (path, a), (jpath, b) in zip(tree_paths_and_leaves(bridge.cache_to_numpy(tcache)),
                                     jax_paths(_np(jcache))):
        assert path == jpath
        _close(a, b, 1e-4, path)


def test_lm_forward_and_loss_match_reference():
    jcfg, cfg = _cfg()
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = bridge.params_from_numpy(_np(jparams))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    labels = np.where(rng.uniform(size=(2, 10)) < 0.2, -1, toks).astype(np.int32)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tparams, {"tokens": _t(toks)})
    _close(tl, jl, 1e-4)
    jloss, _ = jm.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, tmetrics = tm.loss(tparams, {"tokens": _t(toks), "labels": _t(labels)})
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    assert set(tmetrics) == {"loss", "ce", "aux", "acc"}


# ------------------------------------------------------------------ bridge


@pytest.mark.parametrize("scan", [False, True])
def test_lm_param_and_cache_trees_round_trip_through_the_bridge(scan):
    """The reference's LM trees (lists included) keep their paths, leaf
    order, shapes and values through the bridge and back; the port's own
    init and cache have the same paths and shapes."""
    jcfg, cfg = _cfg(scan_layers=scan)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jtrees = {"params": _np(jm.init(jax.random.PRNGKey(0))), "cache": _np(jm.init_cache(3, 16))}
    ttrees = {"params": tm.init(torch.Generator().manual_seed(0)),
              "cache": tm.init_cache(3, 16, "cpu")}
    for name, jtree in jtrees.items():
        t = bridge.tree_from_numpy(jtree)
        back = bridge.tree_to_numpy(t)
        jl, bl = jax_paths(jtree), tree_paths_and_leaves(back)
        assert [p for p, _ in bl] == [p for p, _ in jl]
        for (p, a), (_, b) in zip(bl, jl):
            assert a.dtype == b.dtype, p
            np.testing.assert_array_equal(a, b, err_msg=p)
        own = tree_paths_and_leaves(ttrees[name])
        assert [(p, tuple(x.shape)) for p, x in own] == [(p, b.shape) for p, b in jl], name
    if not scan:
        assert tree_paths_and_leaves(ttrees["params"])[0][0] == "blocks/0/attn/wk"


def test_tree_map_keeps_lists():
    tree = {"a": [torch.ones(2), {"b": torch.zeros(1)}]}
    out = tree_map(lambda t: t + 1, tree)
    assert isinstance(out["a"], list) and out["a"][1]["b"].item() == 1.0


def test_decode_step_writes_the_cache_in_place_at_clamped_rows():
    """A position past the cache end writes the last row, as
    dynamic_update_slice clamps it, and the given cache is the one
    returned."""
    _, cfg = _cfg()
    tm = build_model(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    cache = tm.init_cache(2, 6, "cpu")
    logits, out = tm.decode_step(params, torch.tensor([[1], [2]]), cache, torch.tensor([2, 9]))
    assert out is cache and logits.shape == (2, 1, cfg.vocab_size)
    k = cache[0]["k"]
    assert k[0, 2].abs().sum() > 0 and k[1, 5].abs().sum() > 0
    assert k[0, :2].abs().sum() == 0 and k[1, :5].abs().sum() == 0


def test_serve_and_prefill_steps():
    """The steps wrap the model's prefill and greedy decode; a model
    without a chunked prefill has no prefill step."""
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    _, cfg = _cfg()
    tm = build_model(cfg)
    params = tm.init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(2))
    logits, cache = make_prefill_step(tm)(params, toks, tm.init_cache(2, 8, "cpu"), 0)
    expect, _ = tm.prefill(params, toks, tm.init_cache(2, 8, "cpu"), 0)
    assert torch.equal(logits, expect)
    nxt, step_logits, _ = make_serve_step(tm)(params, toks[:, :1], cache, 6)
    assert nxt.dtype == torch.int32 and torch.equal(nxt, step_logits[:, -1].argmax(-1).int())
    with pytest.raises(ValueError, match="no chunked-prefill"):
        make_prefill_step(build_model(get_config("squeezenet-dr")))


def test_transformer_layer_kinds_are_the_references():
    for arch in ("granite-3-2b", "kimi-k2-1t-a32b", "mamba2-370m"):
        jcfg = jax_get_config(arch)
        assert transformer.layer_kinds(ModelConfig(**dataclasses.asdict(jcfg))) == \
            jax_tf.layer_kinds(jcfg)
