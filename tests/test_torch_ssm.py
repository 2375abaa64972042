"""The port's ssm and hybrid families (mamba2-370m, zamba2-1.2b) against
the JAX reference on the CPU, on the reference's own weights through the
bridge: the configs, the chunked SSD block (output, final state, the
split-prefill carry, its gradient), the recurrent decode step and its
in-place cache, the LM's forward and loss, its init and cache trees,
decode step by step (zamba2's shared attention held against the
reference's Pallas ``flash_decode`` in interpret mode), decode against
forward, the per-token serve loop token for token, the engine's
refusal, one whole swarm round on the reference's draws, and the
trainer's swarm mode. Smoke widths with ``ssm_chunk=8`` and S = 16 in
fp32 unless a test says otherwise."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.tokens import make_token_swarm_data  # noqa: E402
from repro.launch.serve import prefill_into_cache as jax_prefill_into_cache  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serve import BucketSpec as JaxBucketSpec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train.steps import make_serve_step as jax_make_serve_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.kernels import kmeans_assign, param_stats  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import loop_generate, run_serve  # noqa: E402
from repro_torch.models import build_model, ssm, transformer  # noqa: E402
from repro_torch.serve import BucketSpec, ServeEngine  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch_parity import assert_lm_round_matches_reference, pin_torch_threads  # noqa: E402

pin_torch_threads()

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
S = 16


def _cfg(arch, **kw):
    """(reference config, the port's built from its asdict): smoke widths,
    ``ssm_chunk=8`` unless given."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), **{"ssm_chunk": 8, **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, expect, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(expect), rtol=rtol, atol=atol, err_msg=err_msg)


def _ssm_params(jcfg, seed=0):
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_numpy(_np(jp))


def _x(cfg, B, n, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)) * scale).astype(np.float32)


def _lm(arch, **kw):
    """(jcfg, cfg, reference model, port model, reference params, port params)."""
    jcfg, cfg = _cfg(arch, **kw)
    jm, tm = jax_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(4))
    return jcfg, cfg, jm, tm, jp, bridge.params_from_numpy(_np(jp))


def _tokens(vocab, B, n, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_configs_are_the_references(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())
    assert (ours.d_inner, ours.n_ssm_heads) == (theirs.d_inner, theirs.n_ssm_heads)
    assert ours.family == {"mamba2-370m": "ssm", "zamba2-1.2b": "hybrid"}[arch]


def test_zamba2_fits_flash_decode_at_g1_d64():
    """zamba2's shared attention decodes through K3 at G = H/KV = 1 and
    D = 64, inside the kernel's limits; the split plan of its serve
    cache (4 rows, 32 kv heads, 129 columns on 132 SMs) covers every
    column."""
    from repro_torch.kernels import flash_decode
    cfg = get_config("zamba2-1.2b")
    G, D = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    assert (G, D) == (1, 64) and flash_decode.padded_dims(D) == D
    assert flash_decode.query_chunks(G) == (1, 1)
    chunk, n_split = flash_decode.split_plan(4, cfg.n_kv_heads, 129, D, 132)
    assert chunk * n_split >= 129 > chunk * (n_split - 1) and n_split <= flash_decode.MAX_SPLITS


# ------------------------------------------------------------------ SSD block


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 4e-2)])
def test_apply_ssm_matches_reference(arch, dtype, atol):
    """y and the final state. fp32: atol 2e-5 (O(1) outputs, sums of up to
    128 products in another order). bf16: in_proj, the conv and out_proj
    run in bf16 in both packages, but XLA on the CPU keeps a chain of bf16
    elementwise ops (the conv's four products and sums, its silu) in fp32
    and rounds once (excess precision), where the port rounds each op to
    bf16 (2^-8 relative); the fp32 state sums 16 such inputs: y within
    4e-2 and the state within 3e-2 (O(0.1-1) values; 1.8e-2 and 1.7e-2
    measured). A part of the fp32 section rounded to bf16 moves both by
    about as much as this noise, so the dtype rules are held by
    test_apply_ssm_keeps_the_reference_dtypes."""
    jcfg, cfg = _cfg(arch, dtype=dtype)
    jp, tp = _ssm_params(jcfg)
    x = _x(cfg, 2, S, 0)
    jy, jst = jax_ssm.apply_ssm(jp, jnp.asarray(x, jcfg.dtype), jcfg)
    ty, tst = ssm.apply_ssm(tp, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    assert ty.dtype == getattr(torch, dtype) and tst.dtype == torch.float32
    assert tuple(ty.shape) == jy.shape and tuple(tst.shape) == jst.shape
    _close(ty.float(), np.asarray(jy, np.float32), atol)
    _close(tst, jst, 3e-2 if dtype == "bfloat16" else 2e-5)


class _DtypeLog(TorchDispatchMode):
    """Every aten op run inside: (name, input dtypes, input storages,
    output dtypes)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if torch.is_tensor(t)]
        outs = [t.dtype for t in pytree.tree_leaves(out) if torch.is_tensor(t)]
        self.ops.append((func.overloadpacket.__name__, [t.dtype for t in ins],
                         {t.untyped_storage().data_ptr() for t in ins}, outs))
        return out


def _dtype_faults(fn, params, n_bf16_matmuls):
    """What of ``fn()`` (an SSD call in bf16) breaks the reference's dtype
    rules: the fp32 section (dt, A, the chunk tensors and their products,
    the state, the gated norm) must round nothing to bf16, so the one
    fp32 -> bf16 cast of an activation is the one before out_proj, with
    nothing computed in fp32 after it; the only bf16 matmuls are
    in_proj's, out_proj's and (in decode) the conv's; exp, cumsum,
    softplus and the norm's reductions run in fp32."""
    bf16, f32 = torch.bfloat16, torch.float32
    param_mem = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    with _DtypeLog() as log:
        fn()
    faults = []
    down = [i for i, (name, ins, mem, outs) in enumerate(log.ops)
            if name == "_to_copy" and ins == [f32] and outs == [bf16] and not mem & param_mem]
    if len(down) != 1:
        faults.append(f"{len(down)} activation casts to bf16, not 1")
    elif any(outs == [f32] for name, ins, mem, outs in log.ops[down[0]:]
             if name != "copy_" and not mem & param_mem):   # copy_: decode's cache write
        faults.append("fp32 work after the cast before out_proj")
    mm = [name for name, ins, _, outs in log.ops if name in ("mm", "bmm") and bf16 in ins]
    if len(mm) != n_bf16_matmuls:
        faults.append(f"bf16 matmuls {mm}, expected {n_bf16_matmuls}")
    faults += [f"{name} in bf16" for name, _, _, outs in log.ops
               if name in ("exp", "cumsum", "logaddexp", "mean", "sqrt", "div") and bf16 in outs]
    return faults


@pytest.mark.parametrize("entry", ["apply_ssm", "apply_ssm_decode"])
def test_apply_ssm_keeps_the_reference_dtypes(entry):
    """The reference's dtype rules on the port's bf16 SSD, read from the
    aten ops it runs (``_dtype_faults``). A mutation run planted nine
    faults, each rounding one fp32 tensor to bf16: in apply_ssm the chunk
    state, dt, the cumulative decay, the intra-chunk product, the chunk
    states' einsum inputs and the gated norm's input; in decode dt, the
    state and the gated norm's input. This check found all nine, while
    test_apply_ssm_matches_reference passed all nine within its bf16
    noise."""
    jcfg, cfg = _cfg("mamba2-370m", dtype="bfloat16")
    _, tp = _ssm_params(jcfg)
    x = torch.from_numpy(_x(cfg, 2, S, 0)).to(torch.bfloat16)
    if entry == "apply_ssm":
        faults = _dtype_faults(lambda: ssm.apply_ssm(tp, x, cfg), tp, 2)
    else:
        cache = ssm.init_ssm_cache(cfg, 2, "cpu")
        faults = _dtype_faults(lambda: ssm.apply_ssm_decode(tp, x[:, :1], cache, cfg), tp, 3)
        assert cache["conv"].dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    assert not faults, faults


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_ssm_split_prefill_carries_the_state(seed):
    """tests/test_properties.py's SSD property on the port (S = 32 at
    chunk 8): causal, and two halves with the carry (state + conv
    frames) passed equal the whole, rtol 1e-4 / atol 1e-5; the halves'
    carry is the reference's within 2e-5."""
    jcfg, cfg = _cfg("mamba2-370m")
    jp, tp = _ssm_params(jcfg)
    n = 32
    x = torch.from_numpy(_x(cfg, 1, n, seed, scale=0.1))
    y_full, state_full = ssm.apply_ssm(tp, x, cfg)
    x2 = x.clone()
    x2[0, n - 4] += 1.0
    y2, _ = ssm.apply_ssm(tp, x2, cfg)
    torch.testing.assert_close(y2[:, :n - 4], y_full[:, :n - 4], rtol=1e-4, atol=1e-5)
    assert (y2[:, n - 4:] - y_full[:, n - 4:]).abs().max() > 1e-6
    y_a, (st_a, conv_a) = ssm.apply_ssm(tp, x[:, :n // 2], cfg, return_carry=True)
    y_b, st_b = ssm.apply_ssm(tp, x[:, n // 2:], cfg, initial_state=st_a, initial_conv=conv_a)
    torch.testing.assert_close(torch.cat([y_a, y_b], 1), y_full, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(st_b, state_full, rtol=1e-4, atol=1e-5)
    _, (jst_a, jconv_a) = jax_ssm.apply_ssm(jp, jnp.asarray(x[:, :n // 2].numpy()), jcfg,
                                            return_carry=True)
    _close(st_a, jst_a, 2e-5)
    _close(conv_a, jconv_a, 2e-5)


def test_apply_ssm_refuses_a_ragged_chunk_as_the_reference():
    jcfg, cfg = _cfg("mamba2-370m")
    jp, tp = _ssm_params(jcfg)
    x = _x(cfg, 1, 12, 0)
    with pytest.raises(ValueError, match="seq 12 not divisible by ssm_chunk 8"):
        jax_ssm.apply_ssm(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="seq 12 not divisible by ssm_chunk 8"):
        ssm.apply_ssm(tp, torch.from_numpy(x), cfg)


def test_apply_ssm_gradient_is_finite_and_matches_reference():
    """d/d(params, x) of sum(y * w) through two chunks: finite (the mask
    sits before the exp) and within rtol 1e-4 / atol 1e-5 of jax.grad
    (fp32, O(1) gradients)."""
    jcfg, cfg = _cfg("zamba2-1.2b")
    jp, tp = _ssm_params(jcfg)
    x = _x(cfg, 2, S, 3)
    w = np.random.default_rng(4).normal(size=(2, S, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jax_ssm.apply_ssm(p, xx, jcfg)[0] * w)

    def tloss(p, xx):
        return (ssm.apply_ssm(p, xx, cfg)[0] * torch.from_numpy(w)).sum()

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tg_p, tg_x = torch.func.grad(tloss, argnums=(0, 1))(tp, torch.from_numpy(x))
    assert all(torch.isfinite(g).all() for g in tree_leaves(tg_p)) and torch.isfinite(tg_x).all()
    for (path, g), (_, jg) in zip(tree_paths_and_leaves(tg_p),
                                  tree_paths_and_leaves(_np(jg_p))):
        _close(g, jg, 1e-5, 1e-4, err_msg=path)
    _close(tg_x, jg_x, 1e-5, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm_decode_matches_reference_and_writes_in_place(arch):
    """From a random cache: the output within 2e-5, both cache leaves
    within 2e-5 (fp32), and the port's cache written in place."""
    jcfg, cfg = _cfg(arch)
    jp, tp = _ssm_params(jcfg)
    rng = np.random.default_rng(5)
    jc = jax_ssm.init_ssm_cache(jcfg, 2)
    cache_np = {k: rng.normal(size=v.shape).astype(np.float32) * 0.3 for k, v in jc.items()}
    x = _x(cfg, 2, 1, 6)
    jy, jnew = jax_ssm.apply_ssm_decode(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache_np),
                                        jcfg)
    tc = bridge.cache_from_numpy(cache_np)
    conv, state = tc["conv"], tc["state"]
    ty, tnew = ssm.apply_ssm_decode(tp, torch.from_numpy(x), tc, cfg)
    assert tnew is tc and tnew["conv"] is conv and tnew["state"] is state
    _close(ty, jy, 2e-5)
    _close(tnew["conv"], jnew["conv"], 2e-5)
    _close(tnew["state"], jnew["state"], 2e-5)
    for k, v in ssm.init_ssm_cache(cfg, 2, "cpu").items():
        assert tuple(v.shape) == jc[k].shape and str(v.dtype)[6:] == str(jc[k].dtype)


# ------------------------------------------------------------------ the LM


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_and_loss_match_reference(arch):
    """Logits within 1e-4, the loss within 1e-5 (fp32, O(1) logits)."""
    jcfg, cfg, jm, tm, jp, tp = _lm(arch)
    toks = _tokens(cfg.vocab_size, 2, S)
    labels = np.where(np.random.default_rng(2).uniform(size=toks.shape) < 0.2, -1,
                      toks).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, 1e-4)
    assert float(taux) == float(jaux) == 0.0
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)


def _shapes(tree):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree_paths_and_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_trees_are_the_references(arch):
    """The params' and the cache's paths, shapes and dtypes, in order:
    hybrid's ``shared_attn`` and its KV caches interleaved after every
    ``attn_every``-th layer's SSM cache; both through the bridge."""
    jcfg, cfg, jm, tm, jp, tp = _lm(arch)
    ours = tm.init(torch.Generator().manual_seed(0))
    assert _shapes(ours) == _shapes(_np(jp)) == _shapes(tp)
    assert ("shared_attn" in ours) == (arch == "zamba2-1.2b") and "blocks" in ours
    jc = _np(jm.init_cache(2, S))
    tc = tm.init_cache(2, S, "cpu")
    assert _shapes(tc) == _shapes(jc) == _shapes(bridge.cache_from_numpy(jc))
    n_shared = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    assert len(tc) == cfg.n_layers + n_shared
    assert tm.prefill is None and jm.prefill is None


@pytest.mark.parametrize("arch,kw", [("mamba2-370m", {}), ("zamba2-1.2b", {}),
                                     ("zamba2-1.2b", {"sliding_window": 6})],
                         ids=["mamba2", "zamba2", "zamba2-window6"])
def test_lm_decode_step_matches_reference(arch, kw):
    """S = 16 decode steps from the same prompt tokens, against the
    reference's ``use_pallas=True`` branch (zamba2's shared attention
    through ``flash_decode`` in interpret mode; the port's plain version
    on the CPU): logits within 1e-4 at every step, the caches within 1e-4
    at the end (fp32). With a window of 6, keys older than 6 positions
    drop out of the shared block's attention."""
    jcfg, cfg, jm, tm, jp, tp = _lm(arch, use_pallas=True, **kw)
    toks = _tokens(cfg.vocab_size, 2, S)
    jc = jm.init_cache(2, S)
    tc = bridge.cache_from_numpy(_np(jc))
    step = jax.jit(jm.decode_step)
    for t in range(S):
        jl, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.asarray(t, jnp.int32))
        tl, tc2 = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc, t)
        assert tc2 is tc
        _close(tl, jl, 1e-4, err_msg=f"step {t}")
    for (path, a), (_, b) in zip(tree_paths_and_leaves(tc), tree_paths_and_leaves(_np(jc))):
        _close(a, b, 1e-4, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_on_the_port(arch):
    """tests/test_models.py's test_decode_matches_forward on the port:
    S = 16 decode steps against one forward, rtol 2e-3 / atol 2e-4."""
    _, cfg = _cfg(arch)
    tm = build_model(cfg)
    params = tm.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, S, seed=2))
    with torch.no_grad():
        full, _ = tm.forward(params, {"tokens": toks})
        cache = tm.init_cache(2, S, "cpu")
        dec = torch.cat([tm.decode_step(params, toks[:, t:t + 1], cache, t)[0]
                         for t in range(S)], dim=1)
    torch.testing.assert_close(dec, full, rtol=2e-3, atol=2e-4)


def test_chunked_prefill_refuses_ssm_blocks_as_the_reference():
    jcfg, cfg, jm, tm, jp, tp = _lm("mamba2-370m")
    from repro.models import transformer as jax_tf
    toks = _tokens(cfg.vocab_size, 2, 4)
    msg = "chunked prefill supports attention blocks, got 'ssm'"
    with pytest.raises(NotImplementedError, match=msg):
        jax_tf.lm_prefill(jp, jnp.asarray(toks), jm.init_cache(2, 8), 0, jcfg)
    with pytest.raises(NotImplementedError, match=msg):
        transformer.lm_prefill(tp, torch.from_numpy(toks), tm.init_cache(2, 8, "cpu"), 0, cfg)


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("arch", ARCHS)
def test_loop_generations_match_reference_token_for_token(arch):
    """The per-token loop (teacher-forced prompt, then greedy decode) on
    the same prompts and params as the reference's ``run_serve`` loop
    (``prefill_into_cache`` + ``make_serve_step``): every token equal."""
    jcfg, cfg, jm, tm, jp, tp = _lm(arch, ssm_chunk=32)
    B, P, T = 2, 5, 6
    prompts = _tokens(cfg.vocab_size, B, P, seed=7)
    tok, cache = jax_prefill_into_cache(jm, jp, jnp.asarray(prompts), jm.init_cache(B, P + T + 1))
    step = jax.jit(jax_make_serve_step(jm))
    out = [tok]
    for i in range(T - 1):
        tok, _, cache = step(jp, out[-1][:, None], cache, jnp.asarray(P + i, jnp.int32))
        out.append(tok)
    expect = np.asarray(jnp.stack(out, axis=1), np.int32)
    got = loop_generate(tm, tp, torch.from_numpy(prompts), T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_the_family_with_the_references_message(arch):
    jcfg, cfg, jm, tm, jp, tp = _lm(arch, ssm_chunk=32)
    with pytest.raises(ValueError) as jerr:
        JaxServeEngine(jm, jp, (JaxBucketSpec(2, 16),))
    with pytest.raises(ValueError) as terr:
        ServeEngine(tm, tp, (BucketSpec(2, 16),), device="cpu")
    # the port's message also names vlm, which serves through the loop in both packages
    assert str(terr.value) == str(jerr.value).replace("repro.", "repro_torch.").replace(
        "ssm/hybrid/encdec", "ssm/hybrid/encdec/vlm")
    assert f"got family '{cfg.family}'" in str(terr.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serve_generates_through_the_loop(arch):
    gen, info = run_serve(arch, batch=2, prompt_len=4, tokens=3, device="cpu")
    assert info["path"] == "loop" and info["device"] == "cpu"
    assert gen.shape == (2, 3) and gen.dtype == np.int32
    assert ((0 <= gen) & (gen < get_config(arch).smoke().padded_vocab)).all()
    loop, _ = run_serve(arch, batch=2, prompt_len=4, tokens=3, engine="loop", device="cpu")
    np.testing.assert_array_equal(loop, gen)
    with pytest.raises(ValueError, match="ServeEngine serves attention-backed LMs"):
        run_serve(arch, batch=2, prompt_len=4, tokens=3, engine="engine", device="cpu")


# ------------------------------------------------------------------ the swarm


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_ssm_swarm_round_matches_reference(arch):
    """One BSO-SL round of the ``smoke()`` config (chunk 32 over 32-token
    sequences) on 6 token clients, k 2, adam lr 2e-3 at eps 1e-6, batch 4,
    2 local steps, the reference's draws injected; the checks and
    tolerances are ``torch_parity.assert_lm_round_matches_reference``'s."""
    jcfg = jax_get_config(arch).smoke()
    clients = make_token_swarm_data(6, jcfg.vocab_size, n_seqs=12, seq_len=32)
    assert_lm_round_matches_reference(jcfg, ModelConfig(**dataclasses.asdict(jcfg)), clients,
                                      k=2, lr=2e-3, local_steps=2, batch=4, eps=1e-6)


@pytest.mark.parametrize("arch,n_leaves", [("mamba2-370m", 434), ("zamba2-1.2b", 354)])
def test_full_depth_leaf_sets_fit_the_coordinator_kernels(arch, n_leaves):
    """The registered depth's leaves (9 an SSM layer; zamba2's lm_head and
    shared block): K1 takes them in chunks of ``MAX_LEAVES``, one launch
    a chunk, and K2's k = 2 centroids of F = 2 x leaves fit one C tile,
    staged in shared memory once a CTA. Counted at smoke widths:
    the leaf count does not depend on the widths."""
    cfg = dataclasses.replace(get_config(arch).smoke(), n_layers=get_config(arch).n_layers)
    leaves = tree_leaves(build_model(cfg).init(torch.Generator().manual_seed(0)))
    assert len(leaves) == n_leaves
    launches = param_stats.plan([x.numel() for x in leaves], 6)
    assert len(launches) == -(-n_leaves // param_stats.MAX_LEAVES)
    assert kmeans_assign.c_tiles(2, 2 * n_leaves) == (1, 1)


def test_train_swarm_mode_runs_mamba2_on_the_cpu(capsys):
    """``launch/train.py --mode swarm --arch mamba2-370m --rounds 1
    --device cpu``: the smoke config on 64-token sequences (chunk 32)."""
    acc = train.main(["--mode", "swarm", "--arch", "mamba2-370m", "--rounds", "1",
                      "--clients", "4", "--clusters", "2", "--local-steps", "2",
                      "--batch", "4", "--device", "cpu"])
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    out = capsys.readouterr().out
    assert "[bso] round   0" in out and "final mean test accuracy" in out
