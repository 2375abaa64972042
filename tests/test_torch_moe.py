"""The port's moe family, its serving and the fp8 KV cache against the JAX
reference on the CPU, on the reference's own weights through the bridge:
the configs, the router (fp32, top-k ties, the Switch aux), the
sort-based dispatch with and without capacity drops, the grouped
dispatch, ``apply_moe`` with its shared expert, the LM's forward (loss
and aux), prefill and decode in both parameter layouts, whole
generations through the engine token for token against the reference's
``generate``, ``compile_counts()`` after the reference's mixed-prompt
drain, and the fp8 cache: the cast, the cache written by prefill and
decode, decode logits against the reference's Pallas kernel (interpret
mode) and against the port's own bf16 cache. kimi-k2 and
llama4-maverick at their ``smoke()`` widths, fp32 unless a test says
otherwise."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as jax_serve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import flash_decode as jax_flash_decode  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.utils.tree import tree_paths_and_leaves as jax_paths  # noqa: E402
from repro_torch import bridge, serve  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import run_serve  # noqa: E402
from repro_torch.models import attention, build_model, moe  # noqa: E402
from repro_torch.serve import BucketSpec  # noqa: E402
from repro_torch.serve.engine import serving_params  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

ARCHS = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]
BUCKETS = (BucketSpec(batch=2, seq=16), BucketSpec(batch=2, seq=48))


def _cfg(arch, **kw):
    """(reference config, the port's built from its asdict), smoke widths."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, expect, atol, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(expect), rtol=0, atol=atol, err_msg=err_msg)


def _moe_params(jcfg, seed=0):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_numpy(_np(jp))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_are_the_references(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())
    assert ours.family == "moe" and ours.param_dtype == "bfloat16"


def test_kimi_is_the_width_the_card_serves():
    c = get_config("kimi-k2-1t-a32b")
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.n_experts, c.top_k,
            c.n_shared_experts, c.d_ff, c.vocab_size, c.n_dense_layers) == \
        (7168, 64, 8, 112, 384, 8, 1, 2048, 163840, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_is_the_references(arch):
    jcfg, cfg = _cfg(arch)
    full_j, full = jax_get_config(arch), get_config(arch)
    for n in (1, 4, 7, 32, 100, 2048, 8192):
        assert moe.expert_capacity(cfg, n) == jax_moe.expert_capacity(jcfg, n)
        assert moe.expert_capacity(full, n) == jax_moe.expert_capacity(full_j, n)


# ------------------------------------------------------------------- router


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """The same experts in the same order; gates at atol 1e-6 and the aux
    loss at 1e-6 (fp32 softmax and sums in another order)."""
    jcfg, cfg = _cfg(arch)
    jp, p = _moe_params(jcfg)
    xt = _x(cfg, 1, 40, seed=1)[0]
    jg, je, jaux = jax_moe._route(jp, jnp.asarray(xt), jcfg)
    g, e, aux = moe._route(p, _t(xt), cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(g, jg, 1e-6)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


def test_route_ties_take_the_lower_index_first():
    """A zero router gives every expert the same probability: top-k is
    experts 0..K-1 in order on both sides (jax.lax.top_k's rule; the
    port's stable descending sort keeps it)."""
    jcfg, cfg = _cfg("kimi-k2-1t-a32b")
    jp, p = _moe_params(jcfg)
    jp = {**jp, "router": {"w": jnp.zeros_like(jp["router"]["w"])}}
    p = {**p, "router": {"w": torch.zeros_like(p["router"]["w"])}}
    xt = _x(cfg, 1, 6, seed=2)[0]
    _, je, _ = jax_moe._route(jp, jnp.asarray(xt), jcfg)
    _, e, _ = moe._route(p, _t(xt), cfg)
    want = np.tile(np.arange(cfg.top_k), (6, 1))
    np.testing.assert_array_equal(np.asarray(je), want)
    np.testing.assert_array_equal(e.numpy(), want)


# ----------------------------------------------------------------- dispatch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_dispatch_compute_combine_matches_reference(arch, capacity_factor):
    """On the reference's routing: capacity 8 slots an expert at factor
    0.25 for 48 tokens drops tokens, at factor 8 none. atol 1e-5 (fp32
    products summed in another order). The kept sets are equal: the
    tokens whose output the capacity cut changes are the same tokens on
    both sides."""
    jcfg, cfg = _cfg(arch, capacity_factor=capacity_factor)
    jp, p = _moe_params(jcfg)
    xt = _x(cfg, 1, 48, seed=3)[0]
    jg, je, _ = jax_moe._route(jp, jnp.asarray(xt), jcfg)
    C = jax_moe.expert_capacity(jcfg, 48)
    jy = jax_moe._dispatch_compute_combine(jp, jnp.asarray(xt), jg, je, C, jcfg)
    y = moe._dispatch_compute_combine(p, _t(xt)[None], _t(jg)[None], _t(je)[None], C, cfg)[0]
    _close(y, jy, 1e-5)
    free = 48 * cfg.top_k                                     # no expert can overflow
    jy_free = jax_moe._dispatch_compute_combine(jp, jnp.asarray(xt), jg, je, free, jcfg)
    y_free = moe._dispatch_compute_combine(p, _t(xt)[None], _t(jg)[None], _t(je)[None], free,
                                           cfg)[0]
    j_cut = np.abs(np.asarray(jy) - np.asarray(jy_free)).max(-1) > 1e-6
    cut = (y - y_free).abs().amax(-1).numpy() > 1e-6
    np.testing.assert_array_equal(cut, j_cut)
    assert cut.any() == (capacity_factor < 1), cut


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("grouped", [False, True])
def test_apply_moe_matches_reference(arch, grouped):
    """The whole layer with its shared expert, globally and grouped (4
    groups of 24 tokens, each at least E): output at atol 1e-5, aux at
    1e-6."""
    jcfg, cfg = _cfg(arch, moe_grouped_dispatch=grouped, moe_groups=4)
    jp, p = _moe_params(jcfg, seed=4)
    assert ("shared_expert" in p) and p["router"]["w"].dtype == torch.float32
    x = _x(cfg, 2, 48, seed=5)
    jy, jaux = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    y, aux = moe.apply_moe(p, _t(x), cfg)
    _close(y, jy, 1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


def test_grouped_dispatch_matches_global_when_dropfree():
    """tests/test_perf_variants.py's property on the port: at capacity
    factor 8 no group drops a token, so the grouped forward is the global
    one (atol 1e-5)."""
    jcfg, cfg = _cfg("kimi-k2-1t-a32b", capacity_factor=8.0)
    m = build_model(cfg)
    mg = build_model(dataclasses.replace(cfg, moe_grouped_dispatch=True, moe_groups=4))
    params = bridge.params_from_numpy(_np(jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    toks = _t(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    a, _ = m.forward(params, {"tokens": toks})
    b, _ = mg.forward(params, {"tokens": toks})
    _close(a, b.detach().numpy(), 1e-5)


# -------------------------------------------------------------------- stack


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_loss_and_aux_match_reference(arch):
    """Logits at atol 1e-4, loss and aux at 1e-5."""
    jcfg, cfg = _cfg(arch)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = bridge.params_from_numpy(_np(jparams))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    labels = np.where(rng.uniform(size=(2, 12)) < 0.2, -1, toks).astype(np.int32)
    jl, jaux = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(tparams, {"tokens": _t(toks)})
    _close(tl, jl, 1e-4)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-5) and float(taux) > 0
    jloss, jmet = jm.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, tmet = tm.loss(tparams, {"tokens": _t(toks), "labels": _t(labels)})
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    assert float(tmet["aux"]) == pytest.approx(float(jmet["aux"]), abs=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan", [False, True])
def test_lm_prefill_and_decode_match_reference(arch, scan):
    """Two prefill chunks, then two per-row decode steps, in both
    parameter layouts (kimi's scanned stack: a dense prefix layer and a
    moe period; llama4's: one period of a dense and a moe layer): logits
    at atol 1e-4 and the caches after. The reference decodes through its
    Pallas kernel in interpret mode."""
    jcfg, cfg = _cfg(arch, scan_layers=scan, use_pallas=True)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(_np(jparams))
    assert ("layers" in tparams) == scan
    jcache = jm.init_cache(2, 24)
    tcache = bridge.cache_from_numpy(_np(jcache))
    rng = np.random.default_rng(8)
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan", [False, True])
def test_init_and_bridge_trees_are_the_references(arch, scan):
    """The port's init (bf16 params) has the reference's paths, shapes
    and dtypes, the router fp32; the reference's params cross the bridge
    and back bitwise."""
    jcfg, cfg = _cfg(arch, scan_layers=scan, param_dtype="bfloat16")
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jtree = _np(jm.init(jax.random.PRNGKey(0)))
    ttree = tm.init(torch.Generator().manual_seed(0))
    jl = jax_paths(jtree)
    tl = tree_paths_and_leaves(bridge.tree_to_numpy(ttree))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, a), (_, b) in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype, p
    assert any("router" in p and a.dtype == np.float32 for p, a in tl)
    back = tree_paths_and_leaves(bridge.tree_to_numpy(bridge.tree_from_numpy(jtree)))
    for (p, a), (_, b) in zip(back, jl):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), p


def test_expert_init_draws_a_slice_at_a_time(monkeypatch):
    """The expert tensors are drawn EXPERT_INIT_SLICE experts at a time:
    no fp32 draw holds more, and every expert's std is LeCun's."""
    sizes = []
    real = moe.dense_init

    def spy(gen, shape, **kw):
        sizes.append(tuple(shape))
        return real(gen, shape, **kw)

    monkeypatch.setattr(moe, "dense_init", spy)
    w = moe._expert_init(torch.Generator().manual_seed(0), (2, 19, 64, 32), torch.bfloat16)
    assert w.shape == (2, 19, 64, 32) and w.dtype == torch.bfloat16
    assert sizes == [(2, 8, 64, 32), (2, 8, 64, 32), (2, 3, 64, 32)]
    std = w.float().std(dim=(-2, -1))
    assert torch.allclose(std, torch.full_like(std, 64 ** -0.5), rtol=0.1)


def test_serving_params_keep_the_router_in_fp32():
    _, cfg = _cfg("kimi-k2-1t-a32b", param_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    sp = serving_params(params, torch.bfloat16)
    layer = sp["blocks"][1]
    assert layer["moe"]["router"]["w"].dtype == torch.float32
    assert layer["moe"]["experts"]["wi"].dtype == torch.bfloat16
    assert layer["moe"]["shared_expert"]["wi"].dtype == torch.bfloat16
    assert layer["attn_norm"]["scale"].dtype == torch.float32


# ------------------------------------------------------------------- engine


@pytest.fixture(scope="module", params=ARCHS)
def moe_lm(request):
    jcfg, cfg = _cfg(request.param)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(cfg), bridge.params_from_numpy(_np(jp))


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in lens]


def test_engine_generations_match_reference_token_for_token(moe_lm):
    """More requests than slots (admission mid-flight, prefill of the
    whole bucket batch, whose rows share the experts' capacity): every
    token equal to the reference's ``generate``."""
    jm, jp, tm, tp = moe_lm
    prompts = _prompts(tm.cfg.vocab_size, (3, 7, 12, 25, 5, 18), seed=0)
    want = jax_serve.generate(jm, jp, prompts, max_new_tokens=6, buckets=BUCKETS)
    got = serve.generate(tm, tp, prompts, max_new_tokens=6, buckets=BUCKETS, device="cpu")
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.bucket for r in got] == [r.bucket for r in want]


def test_compile_counts_after_the_mixed_drain_are_the_references(moe_lm):
    """tests/test_serve.py's program budget on the port: after the
    reference's mixed-prompt drain, 1 prefill shape and 1 decode shape a
    bucket, the reference's own census."""
    jm, jp, tm, tp = moe_lm
    prompts = _prompts(tm.cfg.vocab_size, (3, 7, 12, 25, 5, 18))
    _, jeng = jax_serve.generate(jm, jp, prompts, max_new_tokens=6, buckets=BUCKETS,
                                 return_engine=True)
    res, eng = serve.generate(tm, tp, prompts, max_new_tokens=6, buckets=BUCKETS,
                              return_engine=True, device="cpu")
    assert [len(r.tokens) for r in res] == [6] * 6 and eng.n_prefill_calls > 2
    want = {"b2xs16": {"prefill": 1, "decode": 1}, "b2xs48": {"prefill": 1, "decode": 1}}
    assert eng.compile_counts() == jeng.compile_counts() == want


def test_run_serve_takes_a_moe_arch():
    gen, info = run_serve("kimi-k2-1t-a32b", batch=2, prompt_len=5, tokens=3, device="cpu")
    assert gen.shape == (2, 3) and info["device"] == "cpu"


# ------------------------------------------------------------------ fp8 cache


def test_fp8_cast_is_the_references():
    """Round to nearest even in range, bitwise; NaN where |x| rounds past
    448 (the reference's astype), where torch's own cast saturates."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=20000) * np.exp(rng.normal(size=20000) * 2)).astype(np.float32)
    x = np.concatenate([x, np.float32([448, 463.9, 464, 464.1, 465, 1e4, -500, np.inf,
                                       -np.inf, 0, -0.0, 1e-9])])
    for dt in (np.float32, ml_dtypes.bfloat16):
        want = np.asarray(jnp.asarray(x.astype(dt)).astype(jnp.float8_e4m3fn))
        got = bridge.tree_to_numpy(attention.to_cache_dtype(
            bridge.tree_from_numpy(x.astype(dt)), torch.float8_e4m3fn))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.isnan(got.astype(np.float32)),
                                      np.isnan(want.astype(np.float32)))
        ok = ~np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(got[ok].view(np.uint8), want[ok].view(np.uint8))


def test_fp8_cache_crosses_the_bridge_bitwise():
    jcfg, _ = _cfg("granite-3-2b", cache_dtype="float8_e4m3fn")
    jc = _np(jax_build_model(jcfg).init_cache(2, 8))[0]
    assert jc["k"].dtype == ml_dtypes.float8_e4m3fn
    jc = {name: np.linspace(-3, 3, x.size).reshape(x.shape).astype(x.dtype)
          for name, x in jc.items()}
    t = bridge.cache_from_numpy(jc)
    assert t["k"].dtype == torch.float8_e4m3fn
    back = bridge.cache_to_numpy(t)
    assert back["k"].dtype == jc["k"].dtype
    assert np.array_equal(back["k"].view(np.uint8), jc["k"].view(np.uint8))


@pytest.mark.parametrize("D", [64, 112])
@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_reads_an_fp8_cache_as_the_pallas_kernel(D, window):
    """K3's plain version on a bf16 q against an fp8 k, v (kimi's D = 112
    among them) against the reference's Pallas kernel in interpret mode
    on the same bytes: the output in bf16 at atol 2e-2, the reference's
    tolerance for its kernel in bf16."""
    B, H, KV, S = 2, 8, 2, 40
    rng = np.random.default_rng(D + window)
    q = rng.normal(size=(B, H, 1, D)).astype(ml_dtypes.bfloat16)
    k, v = (rng.normal(size=(B, KV, S, D)).astype(ml_dtypes.float8_e4m3fn) for _ in range(2))
    pos = np.array([39, 17], np.int32)
    want = jax_flash_decode.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos), window=window, block_k=16,
                                         interpret=True)
    got = ref.decode_attention(*(bridge.tree_from_numpy(a) for a in (q, k, v)), _t(pos), window)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want).astype(np.float32), 2e-2)


def test_fp8_decode_matches_the_reference_pallas_path():
    """granite's smoke config (bf16 activations) with an fp8 cache, on the
    reference's weights: four decode steps through the reference's
    Pallas kernel (interpret mode) and through the port. Layer 0's cache
    is bitwise the reference's (the same bf16 k, v rounded to fp8); layer
    1's inputs already differ by bf16 rounding, so a few of its values
    round to the neighbouring fp8 value (at least 85% of its bytes
    equal). Logits at atol 0.1 of max |logit| ~3.5: with a bf16 cache
    the two sides differ by 0.025, and one fp8 step (2^-3 relative) in a
    key moves a logit by a few hundredths."""
    jcfg, cfg = _cfg("granite-3-2b", cache_dtype="float8_e4m3fn", dtype="bfloat16",
                     use_pallas=True)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(_np(jparams))
    jc, tc = jm.init_cache(2, 12), tm.init_cache(2, 12, "cpu")
    assert tc[0]["k"].dtype == torch.float8_e4m3fn
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    for t in range(4):
        jl, jc = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = tm.decode_step(tparams, _t(toks[:, t:t + 1]), tc, t)
        _close(tl.float(), np.asarray(jl).astype(np.float32), 0.1, f"step {t}")
    for i, (jl_, tl_) in enumerate(zip(_np(jc), bridge.cache_to_numpy(tc))):
        for name in ("k", "v"):
            a, b = tl_[name][:, :4], jl_[name][:, :4]
            assert a.dtype == b.dtype == ml_dtypes.float8_e4m3fn
            same = (a.view(np.uint8) == b.view(np.uint8)).mean()
            assert same == 1.0 if i == 0 else same > 0.85, (i, name, same)


def test_fp8_cache_close_to_bf16_on_the_port():
    """tests/test_perf_variants.py's bound on the port: ten decode steps
    with an fp8 cache against the same with a bf16 one, max |logit
    diff| / max |logit| below 0.2."""
    _, cfg = _cfg("granite-3-2b", dtype="bfloat16")
    cfg8 = dataclasses.replace(cfg, cache_dtype="float8_e4m3fn")
    m, m8 = build_model(cfg), build_model(cfg8)
    params = m.init(torch.Generator().manual_seed(0))
    c, c8 = m.init_cache(2, 10, "cpu"), m8.init_cache(2, 10, "cpu")
    assert c8[0]["k"].dtype == torch.float8_e4m3fn
    toks = torch.randint(0, cfg.vocab_size, (2, 10), generator=torch.Generator().manual_seed(1))
    for t in range(10):
        lr, c = m.decode_step(params, toks[:, t:t + 1], c, t)
        l8, c8 = m8.decode_step(params, toks[:, t:t + 1], c8, t)
    rel = float((lr.float() - l8.float()).abs().max()) / float(lr.float().abs().max())
    assert np.isfinite(rel) and 0 < rel < 0.2, rel


def test_fp8_cache_serves_through_the_engine():
    """kimi's smoke config in bf16 with an fp8 cache through the engine on
    the CPU: prefill writes and decode reads the fp8 cache (kept through
    uint8 views) and every request drains."""
    _, cfg = _cfg("kimi-k2-1t-a32b", dtype="bfloat16", param_dtype="bfloat16")
    m, m8 = build_model(cfg), build_model(dataclasses.replace(cfg, cache_dtype="float8_e4m3fn"))
    params = m.init(torch.Generator().manual_seed(0))
    prompts = _prompts(cfg.vocab_size, (3, 7, 12, 5))
    res, eng = serve.generate(m8, params, prompts, max_new_tokens=4, buckets=BUCKETS,
                              device="cpu", return_engine=True)
    assert all(leaf.dtype == torch.float8_e4m3fn
               for bs in eng.state for leaf in tree_leaves(bs.cache))
    assert [len(r.tokens) for r in res] == [4] * 4
    assert all(0 <= t < cfg.padded_vocab for r in res for t in r.tokens)


def test_moe_loss_under_vmap_equals_each_clients_own():
    """The dispatch is out of place, so ``torch.func.vmap`` (the swarm's
    client axis) takes its sort, count and scatter: the vmapped loss of
    3 client-stacked kimi smoke models equals each model's own, atol
    1e-6."""
    from repro_torch.utils.tree import tree_stack
    _, cfg = _cfg("kimi-k2-1t-a32b")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    models = [model.init(gen) for _ in range(3)]
    toks = torch.randint(0, cfg.vocab_size, (3, 2, 12), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    got = torch.func.vmap(lambda p, b: model.loss(p, b)[0])(tree_stack(models), batch)
    for i, p in enumerate(models):
        want, _ = model.loss(p, {k: v[i] for k, v in batch.items()})
        assert float(got[i]) == pytest.approx(float(want), abs=1e-6), i


# ------------------------------------------------------------------ the swarm


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_moe_swarm_round_matches_reference(arch):
    """One BSO-SL round of the ``smoke()`` config on 6 token clients, k 2,
    adam lr 2e-3 at eps 1e-6, batch 4, 2 local steps, the reference's
    draws injected; the checks and tolerances are
    ``torch_parity.assert_lm_round_matches_reference``'s. The round's train
    loss carries the router's aux loss, which is positive here."""
    from repro.data.tokens import make_token_swarm_data
    from torch_parity import assert_lm_round_matches_reference
    jcfg = jax_get_config(arch).smoke()
    clients = make_token_swarm_data(6, jcfg.vocab_size, n_seqs=12, seq_len=32)
    toks = jnp.asarray(clients[0]["train"][0][:4])
    jm = jax_build_model(jcfg)
    _, metrics = jm.loss(jm.init(jax.random.PRNGKey(0)), {"tokens": toks, "labels": toks})
    assert float(metrics["aux"]) > 0
    assert_lm_round_matches_reference(jcfg, ModelConfig(**dataclasses.asdict(jcfg)), clients,
                                      k=2, lr=2e-3, local_steps=2, batch=4, eps=1e-6)


def test_train_swarm_mode_runs_kimi_on_the_cpu(capsys):
    """``launch/train.py --mode swarm --arch kimi-k2-1t-a32b --rounds 1
    --device cpu`` trains the smoke config, as the reference's
    ``run_swarm`` does for an LM."""
    from repro_torch.launch import train
    acc = train.main(["--mode", "swarm", "--arch", "kimi-k2-1t-a32b", "--rounds", "1",
                      "--clients", "4", "--clusters", "2", "--local-steps", "2",
                      "--batch", "4", "--device", "cpu"])
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    assert "final mean test accuracy" in capsys.readouterr().out
