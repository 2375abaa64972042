"""The port's flash_attention (K4) on the CPU against the JAX reference:
its plain version against the reference's oracle ``ref_attention`` and
against the reference's Pallas kernel in interpret mode, the rows with
no valid key (0, as the kernel gives), the shape rule, the (B,S,H,D)
entry point, and granite's attention composed from the kernel. Inputs
are made with numpy from a seed; bf16 inputs are the fp32 arrays rounded
to bf16 on both sides (round-to-nearest-even in both frameworks)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as k_attn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.layers import apply_rope  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

# tests/test_kernels.py's FLASH_CASES: B, H, KV, S, D, causal, window, bq, bk
FLASH_CASES = [
    (1, 4, 4, 128, 64, True, 0, 64, 64),
    (2, 8, 2, 256, 64, True, 0, 128, 128),
    (1, 8, 1, 256, 128, True, 0, 64, 128),
    (2, 4, 4, 128, 64, False, 0, 64, 64),
    (1, 4, 2, 256, 64, True, 64, 64, 64),
    (1, 2, 2, 512, 64, True, 128, 128, 256),
]
# the reference's own tolerances for its kernel against its oracle
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, H, KV, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32))


def _both(arrays, dtype):
    """The same inputs for both frameworks in ``dtype``."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_oracle(case, dtype):
    B, H, KV, S, D, causal, win, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, H, KV, S, S, D), dtype)
    expect = jax_ref.ref_attention(jq, jk, jv, causal=causal, window=win)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=win, block_q=bq, block_k=bk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(expect), rtol=tol, atol=tol)


# (B, H, KV, Sq, Sk, D, causal, window, q_offset, bq, bk)
INTERPRET_CASES = [
    (1, 4, 2, 64, 64, 32, True, 0, 0, 32, 32),          # every row has keys
    (1, 4, 2, 64, 64, 32, False, 16, 100, 32, 32),      # no row has a key
    (1, 2, 1, 64, 128, 32, True, 24, 140, 32, 64),      # some rows have none
]


@pytest.mark.parametrize("case", INTERPRET_CASES)
def test_matches_reference_kernel_in_interpret_mode(case):
    """Against the reference's Pallas kernel (interpret mode), including
    rows with no valid key, which both give 0."""
    B, H, KV, Sq, Sk, D, causal, win, off, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, H, KV, Sq, Sk, D, seed=1), "float32")
    expect = jax_ops.flash_attention(jq, jk, jv, causal=causal, window=win, block_q=bq,
                                     block_k=bk, q_offset=off, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=win, block_q=bq, block_k=bk,
                              q_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(expect), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", INTERPRET_CASES[1:])
def test_rows_without_a_key_are_zero_and_the_rest_are_the_oracles(case):
    """The reference's oracle gives the mean of v on a row with no valid
    key (a uniform softmax over -1e30 scores), its kernel 0; the port
    follows the kernel there and the oracle on every other row."""
    B, H, KV, Sq, Sk, D, causal, win, off, _, _ = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, H, KV, Sq, Sk, D, seed=2), "float32")
    got = _f32(ref.attention(tq, tk, tv, causal=causal, window=win, q_offset=off))
    oracle = _f32(jax_ref.ref_attention(jq, jk, jv, causal=causal, window=win, q_offset=off))
    pos = off + np.arange(Sq)[:, None]
    cols = np.arange(Sk)[None, :]
    valid = (cols <= pos) if causal else np.ones((Sq, Sk), bool)
    valid &= cols > pos - win
    has_key = valid.any(axis=1)
    assert not has_key.all()
    assert (got[:, :, ~has_key] == 0).all()
    assert np.abs(oracle[:, :, ~has_key]).max() > 0.05     # the oracle's mean of v
    np.testing.assert_allclose(got[:, :, has_key], oracle[:, :, has_key], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_constant_v_gives_that_constant(seed):
    """Softmax rows sum to 1 (port of tests/test_properties.py's rowsum
    property): constant v comes out as that constant."""
    rng = np.random.default_rng(seed)
    b, h = 1 + seed % 2, 1 + seed
    q = torch.from_numpy(rng.normal(size=(b, h, 128, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, h, 128, 64)).astype(np.float32))
    v = torch.full((b, h, 128, 64), 0.5)
    out = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(out.numpy(), 0.5, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,bq,bk", [(96, 96, 64, 64), (64, 100, 64, 64),
                                         (96, 96, 128, 128), (64, 100, 32, 128),
                                         (48, 64, 32, 64)])
def test_shape_rule_raises_where_the_reference_raises(Sq, Sk, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 1, Sq, Sk, 32), "float32")
    try:
        jax_ops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
        raises = False
    except ValueError:
        raises = True
    if raises:
        with pytest.raises(ValueError, match="must divide blocks"):
            ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
        with pytest.raises(ValueError, match="must divide blocks"):
            ops.flash_attention_bsh(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                                    block_q=bq, block_k=bk)
    else:
        assert ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk).shape == tq.shape


def test_bsh_layout_is_the_transposed_call():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 8, 2, 64, 64, 32, seed=3))
    expect = ops.flash_attention(q, k, v, causal=True, window=20, q_offset=5).transpose(1, 2)
    got = ops.flash_attention_bsh(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=True, window=20, q_offset=5)
    assert got.shape == (2, 64, 8, 32)
    assert torch.equal(got, expect)


def test_granite_attention_composed_from_the_kernel_matches_reference():
    """Port of tests/test_kernels.py's model-attention check at granite's
    smoke widths: _project_qkv -> RoPE -> flash_attention_bsh -> wo,
    against the reference's attend_full on the same weights. 1e-4, as
    the reference's test."""
    jcfg = jax_get_config("granite-3-2b").smoke()
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree.map(np.asarray, jax_attn.init_attention(jax.random.PRNGKey(0), jcfg))
    B, S = 2, 64
    x = (np.random.default_rng(4).standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    expect = np.asarray(jax_attn.attend_full(jp, jnp.asarray(x), jcfg))

    p = bridge.params_from_numpy(jp)
    xt = torch.from_numpy(x)
    q, k, v = attention._project_qkv(p, xt, xt, cfg)
    pos = torch.arange(S)[None, :]
    q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention_bsh(q, k, v, causal=True, block_q=32, block_k=32)
    got = o.reshape(B, S, -1) @ p["wo"]
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)


def test_the_dtype_chooses_the_kernel():
    """q, k, v all bf16 or all fp16 at D <= 128 run on the tensor cores;
    fp32 keeps the FMA kernel (TF32 would miss its 2e-5), and so do mixed
    types, an fp8 q, k or v, and any D above 128 (above 256 in slices of
    the output). An fp64 q or k, and a D below 1, are refused."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert k_attn.kernel_for(bf16) == "mma"
    assert k_attn.kernel_for(f16) == "mma"
    assert k_attn.kernel_for(f16, D=128) == k_attn.kernel_for(bf16, D=96) == "mma"
    assert k_attn.kernel_for(f32) == "fma"
    assert k_attn.kernel_for(bf16, f16, f16) == "fma"
    assert k_attn.kernel_for(f16, f16, torch.float8_e5m2) == "fma"
    assert k_attn.kernel_for(bf16, D=129) == k_attn.kernel_for(f16, D=256) == "fma"
    assert k_attn.kernel_for(bf16, D=257) == k_attn.kernel_for(f16, D=1024) == "fma"
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert k_attn.kernel_for(dt) == k_attn.kernel_for(dt, bf16, bf16, D=128) == "fma"
    with pytest.raises(TypeError, match="q must be of .*got torch.float64"):
        k_attn.kernel_for(torch.float64)
    with pytest.raises(TypeError, match="k must be of .*got torch.float64"):
        k_attn.kernel_for(f32, torch.float64)
    with pytest.raises(ValueError, match="D >= 1"):
        k_attn.kernel_for(bf16, D=0)


@pytest.mark.parametrize("dtype,B,H,Sq,D,bq,grid", [
    (torch.bfloat16, 4, 32, 2048, 64, 128, (32, 4, 16)),   # granite's prefill: (H, B, n_q)
    (torch.bfloat16, 1, 4, 100, 32, 128, (4, 1, 1)),
    (torch.bfloat16, 1, 4, 100, 128, 64, (4, 1, 2)),       # 16 rows a warp at D 128
    (torch.float32, 4, 32, 2048, 64, 64, (32, 32, 4)),     # (n_q, H, B)
    (torch.float32, 2, 8, 64, 128, 64, (1, 8, 2)),
])
def test_launch_plan_grid_covers_the_shape(dtype, B, H, Sq, D, bq, grid):
    kernel, got_bq, got = k_attn.launch_plan(dtype, B, H, Sq, D)
    assert kernel == k_attn.kernel_for(dtype) and (got_bq, got) == (bq, grid)
    n_q = grid[2] if kernel == "mma" else grid[0]
    assert (n_q - 1) * bq < Sq <= n_q * bq


@pytest.mark.parametrize("Sq,q_offset", [(2048, 0), (100, 0), (512, 1536)])
def test_causal_q_tiles_launch_heaviest_first(Sq, q_offset):
    """The tensor-core kernel's CTAs take the q tiles in falling order of
    the K/V tiles they walk, so the longest causal rows are in the first
    wave and the shortest fill the tail; the FMA kernel keeps rising
    order. Each order visits every q tile once."""
    for dtype in (torch.bfloat16, torch.float32):
        kernel, bq, grid = k_attn.launch_plan(dtype, 1, 1, Sq, 64)
        n_q = grid[2] if kernel == "mma" else grid[0]
        order = k_attn.q_tile_order(kernel, n_q)
        assert sorted(order) == list(range(n_q))
        work = [len(k_attn.tile_walk(t, bq, Sq, Sq + q_offset, True, 0, q_offset))
                for t in order]
        assert work == sorted(work, reverse=(kernel == "mma"))
        if kernel == "mma":
            assert order[0] == n_q - 1


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (2048, 2048, True, 0, 0), (100, 200, True, 0, 100), (200, 200, False, 0, 0),
    (256, 256, True, 100, 0), (512, 2048, True, 300, 1536), (64, 64, False, 16, 100),
    (100, 100, False, 70, 0), (128, 200, True, 64, 72),
])
def test_tile_walk_masks_every_tile_that_crosses_the_band(Sq, Sk, causal, window, q_offset):
    """Every valid (row, col) lies in a visited tile, and a tile that
    runs unmasked is valid for every row of the q tile below Sq: the
    mask-free fast path drops nothing."""
    pos = q_offset + np.arange(Sq)[:, None]
    cols = np.arange(Sk)[None, :]
    valid = (cols <= pos) if causal else np.ones((Sq, Sk), bool)
    if window > 0:
        valid &= cols > pos - window
    bk = k_attn.BLOCK_K
    for bq in (64, 128):
        n_masked = 0
        for qt in range(-(-Sq // bq)):
            rows = valid[qt * bq:(qt + 1) * bq]
            seen = np.zeros(Sk, bool)
            for t0, masked in k_attn.tile_walk(qt, bq, Sq, Sk, causal, window, q_offset):
                seen[t0:t0 + bk] = True
                n_masked += masked
                if not masked:
                    assert t0 + bk <= Sk and rows[:, t0:t0 + bk].all()
            assert not (rows.any(axis=0) & ~seen).any()
        assert n_masked > 0 or not valid.any()
