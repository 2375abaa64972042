"""The four kernels' whole input contract on the CPU: every input that
a Pallas kernel of the reference takes and its port's card kernel now
takes too (fp16 and fp8 leaves, any storage type of X and C and any
K*F, any head dim, any GQA group, mixed and fp8 caches, an fp8 q,
mixed-type attention), each through the port's plain version against
the reference's kernel in interpret mode on the same bytes (an fp8
output byte for byte, NaN and inf past fp8's range included); the
planners that route those inputs, in pure Python; the refusals that are
left (fp64, D <= 0); and two whole paths against the reference at smoke
widths (fp16 serving, the swarm upload of fp16 LM params).

Run it alone with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_contract.py
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as jax_serve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.diststats import _swarm_features  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge, serve  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.core.diststats import swarm_distribution_matrix  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as k_attn  # noqa: E402
from repro_torch.kernels import flash_decode as k_decode  # noqa: E402
from repro_torch.kernels import kmeans_assign as k_assign  # noqa: E402
from repro_torch.kernels import param_stats as k_stats  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import to_cache_dtype  # noqa: E402
from repro_torch.serve import BucketSpec  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_stack  # noqa: E402

# each storage type as numpy (ml_dtypes) holds it, and the unsigned view
# that carries its bytes into torch unchanged
_NP = {"float32": (np.float32, None), "bfloat16": (ml_dtypes.bfloat16, np.uint16),
       "float16": (np.float16, None), "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, np.uint8),
       "float8_e5m2": (ml_dtypes.float8_e5m2, np.uint8)}


def _both(x, dtype: str):
    """fp32 numpy values ``x`` rounded once to ``dtype`` (ml_dtypes'
    round to nearest even), as a torch tensor and a jax array holding the
    same bytes."""
    np_dt, raw = _NP[dtype]
    a = np.asarray(x, np.float32).astype(np_dt)
    t = torch.from_numpy(a.view(raw).copy()).view(getattr(torch, dtype)) if raw \
        else torch.from_numpy(a.copy())
    return t, jnp.asarray(a)


def _half_tol(expect: np.ndarray) -> float:
    """2e-2 of the output's largest magnitude: the reference's own 2e-2
    for its bf16 kernel against its oracle, scaled (outputs are means of
    O(1) values, so a flat 2e-2 would pass dropped keys)."""
    return 2e-2 * float(np.abs(expect).max())


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("dtype", ["float16", "float8_e4m3fn", "float8_e5m2"])
def test_param_stats_plain_matches_pallas_on_fp16_and_fp8_leaves(dtype):
    """The plain version against ``param_stats_batched`` (interpret) leaf
    by leaf, on the bytes of one rounding: mean rtol 1e-5 / atol 1e-6,
    var rtol 1e-4 / atol 1e-6 (the one-leaf tests' tolerances: fp32 sums
    in other orders, the Pallas kernel's shifted against two passes)."""
    rng = np.random.default_rng(7)
    x = [rng.normal(size=(5, 2, 33)) * 0.3 + 1.5, rng.normal(size=(5, 7)) * 2.0 - 0.5]
    pairs = [_both(a, dtype) for a in x]
    got = ref.param_stats_leaves([t for t, _ in pairs]).numpy()
    for i, (_, j) in enumerate(pairs):
        m, v = jops.param_stats_batched(j)
        np.testing.assert_allclose(got[:, i, 0], np.asarray(m), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[:, i, 1], np.asarray(v), rtol=1e-4, atol=1e-6)


def test_param_stats_leaf_records_carry_every_storage_type():
    """The table record (struct Leaf) of a leaf of each storage type: its
    code in the dtype field (csrc/param_stats.cu's switch), fp64 refused;
    no client limit in the wrapper."""
    src = (_build.CSRC / "param_stats.cu").read_text()
    for dt, code in _build.STORAGE_CODES.items():
        rec = k_stats.leaf_record(0x1000, 56, 7, 2, 3, 1, dt)
        assert len(rec) == 40
        assert k_stats.LEAF_RECORD.unpack(rec) == (0x1000, 56, 7, 2, 3, 1, code, 0)
        assert f"case {code}:" in src or code == 4          # 4 is the switch's default
    assert [str(t)[6:] for t in _build.STORAGE_CODES] == [
        "float32", "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2"]
    with pytest.raises(TypeError, match="float64"):
        k_stats.leaf_record(0, 1, 0, 1, -1, -1, torch.float64)
    assert not hasattr(k_stats, "MAX_CLIENTS")
    (ln,) = k_stats.plan([56], 70_000)
    assert ln.n_ctas == 70_000 and ln.n_parts == 0


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("N,F,K,xdt,cdt,ka", [
    (64, 56, 3, "bfloat16", "float16", None),
    (48, 4100, 4, "bfloat16", "float16", None),       # K*F 16,400: 5 chunks of F
    (40, 2600, 5, "float32", "float32", 3),           # K*F 13,000 with k_active
    (40, 130, 100, "float16", "bfloat16", 97),        # K*F 13,000: 13 centroid blocks
    (33, 40, 6, "float8_e4m3fn", "float8_e5m2", None),
])
def test_kmeans_assign_plain_matches_pallas_on_every_type_and_size(N, F, K, xdt, cdt, ka):
    """Ids equal to ``kmeans_assign`` (interpret), which upcasts X and C
    as the plain version does; with ``k_active`` against the reference's
    kernel on the live centroids alone (a dead one is never chosen)."""
    rng = np.random.default_rng(N + F + K)
    X, jX = _both(rng.normal(size=(N, F)), xdt)
    C, jC = _both(rng.normal(size=(K, F)), cdt)
    got = ref.kmeans_assign(X, C, ka).numpy()
    expect = np.asarray(jops.kmeans_assign(jX, jC if ka is None else jC[:ka]))
    np.testing.assert_array_equal(got, expect)
    assert k_assign.c_tiles(K, F) == (math.ceil(K / 8), math.ceil(F / 1024))


def test_kmeans_assign_c_tiles():
    """C in tiles of 8 centroids by 1,024 features; one tile (staged
    once a CTA) at every coordinator shape of the paths: the round's
    (3, 56), the LM swarm's (2, 222), mamba2's (2, 868)."""
    assert (k_assign.TILE_K, k_assign.CHUNK_F) == (8, 1024)
    for K, F in ((3, 56), (2, 222), (2, 868), (8, 1024), (1, 1)):
        assert k_assign.c_tiles(K, F) == (1, 1)
    assert k_assign.c_tiles(64, 191) == (8, 1)
    assert k_assign.c_tiles(5, 2456) == (1, 3)
    assert k_assign.c_tiles(64, 260) == (8, 1)
    assert k_assign.c_tiles(16, 4096) == (2, 4)
    assert k_assign.c_tiles(1, 100_000) == (1, 98)
    src = (_build.CSRC / "kmeans_assign.cu").read_text()
    assert "constexpr int kBlockK = 8;" in src
    assert "constexpr int kChunkF = 1024;" in src


# ------------------------------------------------------------------ K3

# B, H, KV, S, D, q dtype, k dtype, v dtype, pos, window
DECODE_CASES = [
    (2, 4, 2, 96, 80, "float32", "float32", "float32", [95, 40], 0),
    (2, 4, 1, 64, 96, "float16", "float16", "float16", 50, 0),
    (1, 4, 2, 64, 192, "bfloat16", "bfloat16", "bfloat16", [63], 24),
    (1, 48, 1, 40, 32, "float16", "float8_e5m2", "float8_e5m2", [39], 0),     # G 48
    (2, 16, 1, 48, 64, "float32", "float32", "float32", [47, 3], 0),          # MQA
    (2, 8, 2, 64, 64, "bfloat16", "float16", "float16", [63, 31], 16),
    (2, 6, 3, 50, 40, "float16", "float8_e4m3fn", "float8_e5m2", 33, 0),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_on_the_widened_contract(case):
    """The plain version against ``flash_decode`` (interpret) on the same
    bytes: fp32 2e-5 (the reference's kernel against its oracle), half
    types 2e-2 of the largest output (the same, scaled)."""
    B, H, KV, S, D, qdt, kdt, vdt, pos, window = case
    rng = np.random.default_rng(S + D + H)
    q, jq = _both(rng.normal(size=(B, H, 1, D)), qdt)
    k, jk = _both(rng.normal(size=(B, KV, S, D)), kdt)
    v, jv = _both(rng.normal(size=(B, KV, S, D)), vdt)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    jpos = jnp.asarray(pos, jnp.int32)
    got = ref.decode_attention(q, k, v, tpos, window)
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    expect = np.asarray(jops.flash_decode(jq, jk, jv, jpos, window=window).astype(jnp.float32))
    tol = 2e-5 if qdt == "float32" else _half_tol(expect)
    np.testing.assert_allclose(got.float().numpy(), expect, rtol=0, atol=tol)


# B, H, KV, S, D, q dtype, k dtype, v dtype, pos, window: an fp8 q on
# bf16, fp8 and fp32 caches; D above 256, ragged, with windows and per-row pos
DECODE_WIDE_CASES = [
    (1, 4, 2, 24, 64, "float8_e4m3fn", "bfloat16", "bfloat16", [23], 0),
    (2, 4, 1, 20, 40, "float8_e5m2", "float8_e4m3fn", "float8_e5m2", [19, 6], 8),
    (1, 2, 2, 16, 32, "float8_e4m3fn", "float32", "float32", 11, 0),
    (1, 2, 1, 12, 257, "float32", "float32", "float32", [11], 0),
    (2, 4, 2, 20, 320, "bfloat16", "float16", "float16", [19, 7], 0),
    (1, 2, 1, 24, 512, "float16", "bfloat16", "bfloat16", [23], 10),
    (1, 2, 2, 12, 1000, "float32", "float32", "float32", [9], 4),
    (1, 2, 1, 16, 320, "float8_e5m2", "bfloat16", "float8_e4m3fn", [15], 0),
]


def _assert_out(got, expect_j, qdt):
    """fp8 outputs byte for byte; fp32 within 2e-5, half types within
    2e-2 of the largest output (the widened contract's tolerances)."""
    expect_j = np.asarray(expect_j)
    if qdt.startswith("float8"):
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), expect_j.view(np.uint8))
        return
    expect = expect_j.astype(np.float32)
    tol = 2e-5 if qdt == "float32" else _half_tol(expect)
    np.testing.assert_allclose(got.float().numpy(), expect, rtol=0, atol=tol)


@pytest.mark.parametrize("case", DECODE_WIDE_CASES)
def test_flash_decode_plain_matches_pallas_on_any_d_and_an_fp8_q(case):
    """The plain version against ``flash_decode`` (interpret) on the same
    bytes, at the inputs the card's kernel takes since its last gaps
    closed: an fp8 q (its output in q's type) and D above 256."""
    B, H, KV, S, D, qdt, kdt, vdt, pos, window = case
    rng = np.random.default_rng(S + D + H)
    q, jq = _both(rng.normal(size=(B, H, 1, D)), qdt)
    k, jk = _both(rng.normal(size=(B, KV, S, D)), kdt)
    v, jv = _both(rng.normal(size=(B, KV, S, D)), vdt)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    got = ref.decode_attention(q, k, v, tpos, window)
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    _assert_out(got, jops.flash_decode(jq, jk, jv, jnp.asarray(pos, jnp.int32), window=window),
                qdt)


# values of constant V rows: each output dim is its value (a softmax
# average of equal rows), on both sides of fp8's edges: e4m3 NaN above
# 464, e5m2 inf from 61,440
OVERFLOW_V = [460.0, -466.0, 470.0, -300.0, 61000.0, 62000.0, -62500.0, 1.5]


@pytest.mark.parametrize("qdt", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_outputs_round_past_the_range_as_the_reference(qdt):
    """Constant V rows of the values ``OVERFLOW_V`` under an fp8 q, K3
    and K4: the plain versions' output bytes equal the reference's
    kernels' (interpret), NaN and inf where they are, and each carries
    the value's fp8 byte by ml_dtypes' rounding."""
    rng = np.random.default_rng(9)
    D, S = 16, 16
    vals = np.resize(np.asarray(OVERFLOW_V, np.float32), D)
    q, jq = _both(rng.normal(size=(1, 2, 1, D)), qdt)
    k, jk = _both(rng.normal(size=(1, 1, S, D)), "bfloat16")
    v, jv = _both(np.broadcast_to(vals, (1, 1, S, D)), "float32")
    got = ref.decode_attention(q, k, v, S - 1)
    _assert_out(got, jops.flash_decode(jq, jk, jv, jnp.int32(S - 1)), qdt)
    want = vals.astype(_NP[qdt][0]).view(np.uint8)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy()[0, 0, 0], want)
    q, jq = _both(rng.normal(size=(1, 2, S, D)), qdt)
    got = ref.attention(q, k, v)
    _assert_out(got, jops.flash_attention(jq, jk, jv, block_q=S, block_k=S), qdt)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy()[0, 1, 5], want)


def test_flash_decode_planners():
    """Any D <= 256 on the next of (32, 64, 128, 256), any larger D in
    slices of 256 (the wide kernel, tiles of 32 keys); any G in the
    fewest chunks of at most 8 query rows, of one size; the split plan
    counts the chunks and the slices; the type codes of every storage
    type, q's included; the refusals left (D <= 0, fp64)."""
    assert [k_decode.padded_dims(D) for D in (1, 32, 33, 64, 80, 96, 112, 128, 192, 256)] == \
        [32, 32, 64, 64, 128, 128, 128, 128, 256, 256]
    assert [(k_decode.padded_dims(D), k_decode.slices(D)) for D in (257, 320, 512, 1000, 1024)] \
        == [(512, 2), (512, 2), (512, 2), (1024, 4), (1024, 4)]
    assert k_decode.slices(256) == 1
    for D in (0, -3):
        with pytest.raises(ValueError, match="D >= 1"):
            k_decode.padded_dims(D)
    assert [k_decode.query_chunks(G) for G in (1, 6, 8, 9, 12, 48, 64, 37)] == \
        [(1, 1), (6, 1), (8, 1), (5, 2), (6, 2), (8, 6), (8, 8), (8, 5)]
    for G in range(1, 130):
        gc, n = k_decode.query_chunks(G)
        assert gc <= k_decode.MAX_GROUP and (n - 1) * gc < G <= n * gc
    # G 48 on one kv head at B 4: 24 (row, chunk) pairs want ceil(4 x 132 /
    # 24) = 22 ranges of the 256 tiles of 8 keys, 12 tiles each; with G 1
    # the 4 pairs would take the cap of 64 ranges
    assert k_decode.split_plan(4, 1, 2048, 192, 132, G=48) == (96, 22)
    assert k_decode.split_plan(4, 1, 2048, 192, 132) == (32, 64)
    # MQA, G 64 at B 2: 16 pairs, 33 ranges wanted of 512 tiles of 16 keys
    assert k_decode.split_plan(2, 1, 8192, 128, 132, G=64) == (256, 32)
    # D 512 at (4,16,1,512) on 4 kv heads: 4 x 4 x 2 slices = 32 CTAs a
    # split want 17 ranges of the 128 tiles of 32 keys, 8 tiles each
    assert k_decode.split_plan(4, 4, 4096, 512, 132, G=4) == (256, 16)
    assert k_decode.split_plan(1, 8, 2048, 1024, 132) == (128, 16)
    codes = k_decode.type_codes(torch.bfloat16, torch.float8_e5m2, torch.float16)
    assert codes == (1, 4, 2)
    assert k_decode.type_codes(torch.float8_e4m3fn, torch.float32, torch.float8_e5m2) == (3, 0, 4)
    assert k_decode.type_codes(torch.float8_e5m2, torch.bfloat16, torch.bfloat16) == (4, 1, 1)
    with pytest.raises(TypeError, match="q must be of .*float64"):
        k_decode.type_codes(torch.float64, torch.float16, torch.float16)
    with pytest.raises(TypeError, match="float64"):
        k_decode.type_codes(torch.float16, torch.float64, torch.float16)
    src = (_build.CSRC / "flash_decode.cu").read_text()
    assert f"constexpr int kMaxGroup = {k_decode.MAX_GROUP};" in src
    assert f"constexpr int kWideSlice = {k_decode.WIDE_SLICE};" in src
    assert f"constexpr int kWideTile = {k_decode.WIDE_TILE};" in src


def test_flash_decode_stages_unaligned_rows_with_plain_loads():
    """16-byte cp.async only where each row's D elements are whole
    16-byte chunks: D 80 in fp16 (160 B) and in fp8 (80 B) are, D 33 in
    fp16 (66 B) and D 40 in fp8 (40 B) are not."""
    def kv(D, dt):
        return torch.zeros((1, 2, 8, D), dtype=dt)
    assert k_decode.stages_by_cp_async(kv(80, torch.float16), kv(80, torch.float8_e5m2))
    assert not k_decode.stages_by_cp_async(kv(33, torch.float16), kv(33, torch.float16))
    assert not k_decode.stages_by_cp_async(kv(80, torch.float16), kv(40, torch.float8_e4m3fn)[..., :40])
    assert not k_decode.stages_by_cp_async(kv(40, torch.float8_e4m3fn), kv(40, torch.float16))


# ------------------------------------------------------------------ K4

# B, H, KV, S, D, q / k / v dtypes, causal, window, block
ATTN_CASES = [
    (1, 4, 2, 64, 64, ("float16",) * 3, True, 0, 32),
    (1, 2, 1, 64, 96, ("bfloat16",) * 3, True, 16, 32),
    (1, 2, 2, 32, 256, ("float16",) * 3, False, 0, 32),
    (1, 4, 2, 64, 64, ("bfloat16", "float16", "float16"), True, 0, 64),
    (1, 2, 1, 64, 80, ("float32", "bfloat16", "float8_e5m2"), True, 0, 32),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_on_the_widened_contract(case):
    """The plain version against ``flash_attention`` (interpret), which
    casts each of q, k, v to fp32: an fp32 q 2e-5, half types 2e-2 (the
    reference's tolerances for its kernel against its oracle)."""
    B, H, KV, S, D, dts, causal, window, blk = case
    rng = np.random.default_rng(S + D)
    q, jq = _both(rng.normal(size=(B, H, S, D)), dts[0])
    k, jk = _both(rng.normal(size=(B, KV, S, D)), dts[1])
    v, jv = _both(rng.normal(size=(B, KV, S, D)), dts[2])
    got = ref.attention(q, k, v, causal=causal, window=window)
    expect = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                             block_q=blk, block_k=blk).astype(jnp.float32))
    tol = 2e-5 if dts[0] == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), expect, rtol=tol, atol=tol)


# B, H, KV, S, D, q / k / v dtypes, causal, window, block: an fp8 q on
# bf16, fp8 and fp32 k and v; D above 256 with and without a window
ATTN_WIDE_CASES = [
    (1, 2, 1, 16, 64, ("float8_e4m3fn", "bfloat16", "bfloat16"), True, 0, 16),
    (1, 2, 2, 16, 32, ("float8_e5m2", "float8_e5m2", "float8_e4m3fn"), True, 6, 8),
    (1, 2, 1, 16, 48, ("float8_e4m3fn", "float32", "float32"), False, 0, 16),
    (1, 2, 1, 16, 320, ("bfloat16",) * 3, True, 0, 16),
    (1, 2, 1, 16, 512, ("float32",) * 3, True, 5, 8),
    (1, 2, 2, 8, 1000, ("float16", "float16", "bfloat16"), False, 0, 8),
]


@pytest.mark.parametrize("case", ATTN_WIDE_CASES)
def test_flash_attention_plain_matches_pallas_on_any_d_and_an_fp8_q(case):
    """The plain version against ``flash_attention`` (interpret): an fp8
    q's output byte for byte, the rest at the widened contract's
    tolerances."""
    B, H, KV, S, D, dts, causal, window, blk = case
    rng = np.random.default_rng(S + D + 1)
    q, jq = _both(rng.normal(size=(B, H, S, D)), dts[0])
    k, jk = _both(rng.normal(size=(B, KV, S, D)), dts[1])
    v, jv = _both(rng.normal(size=(B, KV, S, D)), dts[2])
    got = ref.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _assert_out(got, jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                          block_q=blk, block_k=blk), dts[0])


@pytest.mark.parametrize("dts,D,kernel,bq,grid", [
    (("float16",) * 3, 64, "mma", 128, (32, 4, 16)),
    (("bfloat16",) * 3, 96, "mma", 64, (32, 4, 32)),
    (("float16",) * 3, 128, "mma", 64, (32, 4, 32)),
    (("bfloat16",) * 3, 256, "fma", 64, (32, 32, 4)),
    (("bfloat16", "float16", "float16"), 64, "fma", 64, (32, 32, 4)),
    (("float16", "float16", "float8_e5m2"), 64, "fma", 64, (32, 32, 4)),
    (("float32",) * 3, 80, "fma", 64, (32, 32, 4)),
])
def test_flash_attention_launch_plan_routes_by_types_and_d(dts, D, kernel, bq, grid):
    """The kernel is fixed by (types, D) up front at (B 4, H 32, Sq
    2,048): the tensor cores for one half type at D <= 128, the FMA
    kernel for the rest."""
    dt = tuple(getattr(torch, t) for t in dts)
    assert k_attn.launch_plan(dt, 4, 32, 2048, D) == (kernel, bq, grid)
    assert k_attn.kernel_for(*dt, D=D) == kernel


def test_flash_attention_padded_dims_and_refusals():
    """Any D on the FMA kernel above 128 (in slices of 128 output dims
    above 256, one more grid column each); an fp8 q on the FMA kernel;
    the refusals left (D <= 0, fp64)."""
    assert [k_attn.padded_dims(D) for D in (1, 32, 48, 80, 96, 128, 129, 200, 256)] == \
        [32, 32, 64, 128, 128, 128, 256, 256, 256]
    assert [(k_attn.padded_dims(D), k_attn.slices(D)) for D in (257, 320, 512, 1000)] == \
        [(384, 3), (384, 3), (512, 4), (1024, 8)]
    assert k_attn.launch_plan(torch.bfloat16, 1, 8, 1024, 320) == ("fma", 64, (48, 8, 1))
    assert k_attn.launch_plan(torch.bfloat16, 1, 1, 64, 257) == ("fma", 64, (3, 1, 1))
    for bad in (0, -1):
        with pytest.raises(ValueError, match="D >= 1"):
            k_attn.launch_plan(torch.bfloat16, 1, 1, 64, bad)
    for fp8 in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert k_attn.launch_plan(fp8, 4, 32, 2048, 64) == ("fma", 64, (32, 32, 4))
        assert k_attn.kernel_for(fp8, torch.bfloat16, torch.bfloat16, D=64) == "fma"
    with pytest.raises(TypeError, match="q must be of .*float64"):
        k_attn.launch_plan(torch.float64, 1, 1, 64, 64)
    with pytest.raises(TypeError, match="float64"):
        k_attn.kernel_for(torch.float16, torch.float16, torch.float64)
    q = torch.zeros((1, 2, 16, 8), dtype=torch.float16)
    assert not k_attn.stages_by_vectors(q[..., :7], q[..., :7], q[..., :7])
    assert k_attn.stages_by_vectors(q, q, q)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert f"constexpr int kWideSlice = {k_attn.WIDE_SLICE};" in src


# -------------------------------------------------------------- fp8 cache


def test_e5m2_cache_writes_round_as_the_references_astype():
    """``to_cache_dtype`` into float8_e5m2 against ml_dtypes' ``astype``,
    byte for byte: round to nearest even (ties included), subnormals down
    to 2^-16 and below, inf past 57,344 (from 61,440, the midpoint to the
    next step), signs, inf itself; NaN stays NaN."""
    rng = np.random.default_rng(5)
    steps = np.array([2.0 ** e * (1 + m / 4) for e in range(-16, 16) for m in range(4)])
    mids = (steps[1:] + steps[:-1]) / 2                         # exact ties
    x = np.concatenate([rng.normal(size=2000) * 10.0 ** rng.integers(-6, 5, size=2000),
                        steps, mids, -mids, np.nextafter(mids, 0), np.nextafter(mids, 1e9),
                        [0.0, -0.0, 2.0 ** -17, 3 * 2.0 ** -18, 2.0 ** -18, 57344.0, 57343.0,
                         61439.0, 61440.0, 61441.0, -61440.0, 1e6, -1e6, np.inf, -np.inf]])
    x = x.astype(np.float32)
    got = to_cache_dtype(torch.from_numpy(x), torch.float8_e5m2).view(torch.uint8).numpy()
    expect = x.astype(ml_dtypes.float8_e5m2).view(np.uint8)
    np.testing.assert_array_equal(got, expect)
    nan = to_cache_dtype(torch.tensor([float("nan")]), torch.float8_e5m2).float()
    assert torch.isnan(nan).all()
    # an e5m2 cache crosses the bridge with its bytes
    cache = bridge.cache_from_numpy(x.astype(ml_dtypes.float8_e5m2))
    assert cache.dtype == torch.float8_e5m2
    np.testing.assert_array_equal(cache.view(torch.uint8).numpy(), expect)
    np.testing.assert_array_equal(bridge.cache_to_numpy(cache).view(np.uint8), expect)


# ------------------------------------------------------------ whole paths


def test_fp16_serve_of_granite_smoke_matches_the_reference_token_for_token():
    """granite-3-2b's smoke config with ``dtype="float16"`` served by the
    port's engine on the CPU and by the reference's ``generate`` from the
    same (fp32) weights, cast to fp16 by each: the same tokens."""
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").smoke(), dtype="float16")
    jm = jax_build_model(jcfg)
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    tp = tm.init(torch.Generator().manual_seed(0))
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (3, 9, 14)]
    buckets = (BucketSpec(batch=4, seq=24),)
    want = jax_serve.generate(jm, jp, prompts, max_new_tokens=4, buckets=buckets)
    got = serve.generate(tm, tp, prompts, max_new_tokens=4, buckets=buckets, device="cpu")
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_swarm_upload_of_fp16_lm_params_matches_the_references_pallas_features():
    """``swarm_distribution_matrix`` of client-stacked fp16 LM params
    (granite's smoke config, ``param_dtype="float16"``, 3 clients) against
    the reference's ``_swarm_features(use_pallas=True)``, its K1 in
    interpret mode, on the same fp16 bytes: rtol 1e-5 / atol 1e-6 on
    [mean, log1p(var)] (K1's tolerance; log1p keeps var's relative
    error)."""
    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), param_dtype="float16")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(4)
    tparams = tree_stack([model.init(gen) for _ in range(3)])
    assert {x.dtype for x in tree_leaves(tparams)} == {torch.float16}
    stacked = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    expect = np.asarray(_swarm_features(stacked, use_pallas=True))
    got = swarm_distribution_matrix(tparams, 3).numpy()
    assert got.shape == expect.shape == (3, 2 * len(tree_leaves(tparams)))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
