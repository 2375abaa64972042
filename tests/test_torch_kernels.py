"""The port's kernels: plain versions against the JAX reference's
oracles and Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them), and device dispatch. The CUDA
kernels themselves are held on the card in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as k_decode  # noqa: E402
from repro_torch.kernels import kmeans_assign as k_assign  # noqa: E402
from repro_torch.kernels import param_stats as k_stats  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()


def _bf16_from_torch(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape", [(3, 1000), (8, 33, 7), (2, 70000), (5, 7), (1, 4096),
                                   (14, 8, 128), (14, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_param_stats_matches_reference_kernel_and_oracle(shape, dtype):
    """Against the Pallas kernel (interpret) and the jnp oracle on the
    same values (bf16 inputs are the same bf16 numbers on both sides).
    rtol 1e-5 / atol 1e-6: fp32 sums of up to 7e4 terms in another
    order."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 2.0 + 1.3).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x) if dtype == "float32" else _bf16_from_torch(tx)
    m, v = ref.param_stats_batched(tx)
    assert m.dtype == v.dtype == torch.float32 and m.shape == (shape[0],)
    for jm, jv in (jax_ref.ref_param_stats_batched(jx), jax_ops.param_stats_batched(jx)):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mean,n", [(1e4, 4096), (1e3, 300_001), (-5e3, 70_000)])
def test_plain_param_stats_large_mean_keeps_variance(mean, n):
    """mean^2 >> var: the two-pass plain version must not cancel."""
    x = np.random.default_rng(0).normal(size=(2, n)).astype(np.float32) * 0.5 + mean
    m, v = ref.param_stats_batched(torch.from_numpy(x))
    jm, jv = jax_ref.ref_param_stats_batched(jnp.asarray(x))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-3)
    assert (v > 0.2).all()


def test_plain_param_stats_empty_is_nan():
    m, v = ref.param_stats_batched(torch.zeros((3, 0)))
    assert m.shape == (3,) and torch.isnan(m).all() and torch.isnan(v).all()


@pytest.mark.parametrize("N,F,K", [(14, 56, 3), (14, 6, 3), (37, 10, 3), (130, 260, 5),
                                   (3, 4, 3), (1000, 260, 37)])
def test_plain_kmeans_assign_matches_reference_kernel_and_oracle(N, F, K):
    rng = np.random.default_rng(N * F + K)
    X = rng.normal(size=(N, F)).astype(np.float32)
    C = rng.normal(size=(K, F)).astype(np.float32)
    got = ref.kmeans_assign(torch.from_numpy(X), torch.from_numpy(C))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref.ref_kmeans_assign(X, C)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ops.kmeans_assign(X, C)))


def test_plain_kmeans_assign_ties_go_to_first_centroid():
    X = torch.tensor([[0.0, 0.0], [1.0, 1.0]])
    C = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    assert ref.kmeans_assign(X, C).tolist() == [0, 0]


@pytest.mark.parametrize("N,F,K", [(14, 56, 5), (14, 56, 3), (37, 10, 4), (130, 260, 6)])
def test_plain_kmeans_assign_k_active_matches_reference_assign(N, F, K):
    """K2's plain version with ``k_active`` against the reference's
    masked assign (``repro.core.kmeans.assign``) for every k_active from
    -1 to K + 1 (an int and a () int32 tensor), and against the Pallas
    kernel (interpret) with the dead centroids moved far away, an
    independent check. The dead rows of C are copies of rows of X, so
    they are nearer than every live centroid."""
    from repro.core.kmeans import assign as jax_assign
    rng = np.random.default_rng(N + F + K)
    X = rng.normal(size=(N, F)).astype(np.float32)
    C = rng.normal(size=(K, F)).astype(np.float32)
    C[K // 2:] = X[:K - K // 2]
    tX, tC = torch.from_numpy(X), torch.from_numpy(C)
    for ka in range(-1, K + 2):
        got = ref.kmeans_assign(tX, tC, ka)
        assert got.dtype == torch.int32
        assert torch.equal(got, ref.kmeans_assign(tX, tC, torch.tensor(ka, dtype=torch.int32)))
        expect = np.asarray(jax_assign(jnp.asarray(X), jnp.asarray(C), jnp.int32(ka)))
        np.testing.assert_array_equal(got.numpy(), expect, err_msg=f"k_active={ka}")
        if ka >= 1:
            far = C.copy()
            far[ka:] = 1e6
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ops.kmeans_assign(X, far)),
                                          err_msg=f"k_active={ka}")
        if ka <= 0:
            assert not got.any(), "no live centroid: every id is 0"
        else:
            assert int(got.max()) < ka
    assert torch.equal(ref.kmeans_assign(tX, tC, None), ref.kmeans_assign(tX, tC))
    assert torch.equal(ref.kmeans_assign(tX, tC, K), ref.kmeans_assign(tX, tC))


def test_plain_kmeans_assign_k_active_ties_go_to_first_live_centroid():
    X = torch.zeros((5, 4))
    C = torch.zeros((4, 4))
    assert ref.kmeans_assign(X, C, torch.tensor(3)).tolist() == [0] * 5
    C[0] = 1.0
    assert ref.kmeans_assign(X, C, torch.tensor(3)).tolist() == [1] * 5
    assert ref.kmeans_assign(X, C, torch.tensor(1)).tolist() == [0] * 5


# the reference's decode cases (tests/test_kernels.py DECODE_CASES):
# B, H, KV, S, D, pos, window
DECODE_CASES = [
    (2, 4, 2, 512, 64, 100, 0),
    (1, 8, 2, 1024, 128, 1023, 0),
    (2, 4, 4, 512, 64, 300, 128),
    (1, 4, 1, 256, 64, 0, 0),
    (2, 4, 2, 200, 64, 150, 0),
    (1, 4, 2, 80, 64, 79, 32),
]
DECODE_BLOCK_K = {512: 128, 1024: 256, 256: 64, 200: 64, 80: 64}


def _decode_inputs(B, H, KV, S, D, dtype, seed):
    """The same q, k, v on both sides: numpy draws, cast to ``dtype`` in
    torch, and the very same bf16 numbers handed to JAX."""
    rng = np.random.default_rng(seed)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(getattr(torch, dtype))
                  for s in ((B, H, 1, D), (B, KV, S, D), (B, KV, S, D)))
    conv = (lambda t: jnp.asarray(t.numpy())) if dtype == "float32" else _bf16_from_torch
    return (tq, tk, tv), tuple(conv(t) for t in (tq, tk, tv))


def _assert_decode_close(got, jax_outs, dtype):
    """fp32 2e-5, bf16 2e-2: the reference's own tolerances
    (tests/test_kernels.py)."""
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == getattr(torch, dtype)
    for expect in jax_outs:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_attention_matches_reference_kernel_and_oracle(case, dtype):
    """Against the jnp oracle and the Pallas kernel in interpret mode."""
    B, H, KV, S, D, pos, win = case
    (tq, tk, tv), (jq, jk, jv) = _decode_inputs(B, H, KV, S, D, dtype, seed=S + pos)
    got = ref.decode_attention(tq, tk, tv, pos, window=win)
    _assert_decode_close(got, (
        jax_ref.ref_decode_attention(jq, jk, jv, pos, window=win),
        jax_ops.flash_decode(jq, jk, jv, jnp.asarray(pos, jnp.int32), window=win,
                             block_k=DECODE_BLOCK_K[S])), dtype)


@pytest.mark.parametrize("pos_list,S,win,bk", [
    ([3, 100, 511], 512, 0, 128),
    ([0, 37], 96, 0, 64),
    ([10, 250], 256, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_attention_vector_pos_matches_reference(pos_list, S, win, bk, dtype):
    """(B,) per-row positions, the serve engine's layout; each row also
    agrees with a scalar-pos call on that row alone."""
    B, H, KV, D = len(pos_list), 4, 2, 64
    (tq, tk, tv), (jq, jk, jv) = _decode_inputs(B, H, KV, S, D, dtype, seed=S + win)
    pos = torch.tensor(pos_list, dtype=torch.int32)
    jpos = jnp.asarray(pos_list, jnp.int32)
    got = ref.decode_attention(tq, tk, tv, pos, window=win)
    _assert_decode_close(got, (
        jax_ref.ref_decode_attention(jq, jk, jv, jpos, window=win),
        jax_ops.flash_decode(jq, jk, jv, jpos, window=win, block_k=bk)), dtype)
    for b, p in enumerate(pos_list):
        one = ref.decode_attention(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1], p, window=win)
        assert torch.equal(one, got[b:b + 1])


def test_plain_decode_attention_reads_a_strided_cache():
    """The serve cache is (B,S,KV,D); the plain version, like the kernel,
    takes its (B,KV,S,D) transposed view without a copy by the caller.
    atol 1e-6: the einsum may sum a strided operand in another order."""
    cache = torch.randn(2, 40, 2, 64)
    q = torch.randn(2, 4, 1, 64)
    view = cache.transpose(1, 2)
    assert not view.is_contiguous()
    torch.testing.assert_close(ref.decode_attention(q, view, view, 17),
                               ref.decode_attention(q, view.contiguous(), view.contiguous(), 17),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("B,KV,S,D,expect", [
    (4, 8, 2048, 64, (128, 16)),        # the serve path's buckets: 4 tiles of 32 keys
    (4, 8, 1024, 64, (64, 16)),
    (1, 2, 80, 64, (32, 3)),            # ragged S: the last range is short
    (64, 8, 2048, 64, (1024, 2)),       # many (row, kv head) pairs: few splits
    (1, 8, 300, 256, (8, 38)),
    (1, 1, 32768, 64, (512, 64)),       # a long cache: capped at MAX_SPLITS ranges
    (4, 8, 2048, 112, (128, 16)),       # kimi-k2's D: tiles of 16 keys at 128 padded dims
    (4, 8, 1000, 112, (64, 16)),
])
def test_decode_split_plan(B, KV, S, D, expect):
    chunk, n_split = k_decode.split_plan(B, KV, S, D, 132)
    assert (chunk, n_split) == expect
    tile = k_decode.TILE_ELEMS // k_decode.padded_dims(D)
    assert chunk % tile == 0 and (n_split - 1) * chunk < S <= n_split * chunk
    assert n_split <= k_decode.MAX_SPLITS


def test_decode_merge_counter_is_zeroed_once_per_device_and_stream(monkeypatch):
    """The fused merge's counters: torch.zeros at first use, the same
    buffer on the next call from that (device, stream), another for
    another stream, and a larger one (the outgrown one kept) when more
    (row, kv head) pairs arrive."""
    monkeypatch.setattr(k_decode, "_counters", {})
    monkeypatch.setattr(k_decode, "_retired", [])
    cpu = torch.device("cpu")
    a = k_decode.merge_counter(cpu, 7, 32)
    assert a.dtype == torch.int32 and a.numel() >= 32 and not a.any()
    a[0] = 5                                  # a later call must see the same buffer
    assert k_decode.merge_counter(cpu, 7, 32) is a
    assert k_decode.merge_counter(cpu, 8, 32) is not a
    big = k_decode.merge_counter(cpu, 7, 10_000)
    assert big.numel() >= 10_000 and not big.any() and k_decode._retired == [a]


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x = torch.randn(4, 9)
    X, C = torch.randn(6, 5), torch.randn(2, 5)
    q, kv = torch.randn(2, 4, 1, 32), torch.randn(2, 2, 10, 32)
    before = (k_stats.param_stats_leaves.launches, k_assign.kmeans_assign.launches,
              k_decode.flash_decode.launches)
    m, v = ops.param_stats_batched(x)
    rm, rv = ref.param_stats_batched(x)
    assert torch.equal(m, rm) and torch.equal(v, rv)
    both = ops.param_stats_leaves([x, x[:, :4].to(torch.bfloat16).contiguous()])
    assert torch.equal(both, ref.param_stats_leaves([x, x[:, :4].to(torch.bfloat16)]))
    assert torch.equal(ops.kmeans_assign(X, C), ref.kmeans_assign(X, C))
    ka = torch.tensor(1, dtype=torch.int32)
    assert torch.equal(ops.kmeans_assign(X, C, ka), ref.kmeans_assign(X, C, ka))
    assert torch.equal(ops.flash_decode(q, kv, kv, 7, window=3),
                       ref.decode_attention(q, kv, kv, 7, window=3))
    assert (k_stats.param_stats_leaves.launches, k_assign.kmeans_assign.launches,
            k_decode.flash_decode.launches) == before


def test_other_devices_go_to_the_kernels_which_refuse_them(monkeypatch):
    """No quiet fallback: a tensor that is not on the CPU reaches the
    kernel wrapper, which raises unless it is on a CUDA device. The
    attention kernels are dispatcher ops, which give a ``meta`` tensor
    its output's shape (the dry-run's shape propagation) without running
    the plain version or the kernel."""
    with pytest.raises(ValueError, match="CUDA"):
        ops.param_stats_batched(torch.empty((2, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(torch.empty((2, 3), device="meta"), torch.empty((1, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        k_stats.param_stats_batched(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        k_assign.kmeans_assign(torch.zeros(2, 3), torch.zeros(1, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(torch.empty((2, 3), device="meta"), torch.empty((1, 3), device="meta"),
                          torch.empty((), dtype=torch.int32, device="meta"))
    meta = torch.empty((2, 4, 1, 64), device="meta")

    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")
    monkeypatch.setattr(ref, "decode_attention", refuse)
    before = k_decode.flash_decode.launches
    out = ops.flash_decode(meta, torch.empty((2, 2, 8, 64), device="meta"),
                           torch.empty((2, 2, 8, 64), device="meta"), 3)
    assert out.device.type == "meta" and out.shape == meta.shape
    assert k_decode.flash_decode.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        k_decode.flash_decode(torch.zeros(2, 4, 1, 64), torch.zeros(2, 2, 8, 64),
                              torch.zeros(2, 2, 8, 64), 3)


@pytest.mark.parametrize("n,expect", [(9216, 1), (5, 1), (0, 1), (16384, 1), (16385, 2),
                                      (1_000_003, 62), (16_777_216, 1024),
                                      (16_777_221, 1025)])
def test_param_stats_slices_per_client(n, expect):
    """A row up to ROW_PER_CTA elements (every row of squeezenet-dr's
    round, 9,216 at most) is one CTA with no merge; a longer one splits
    into ROW_PER_CTA slices."""
    assert k_stats.slices(n) == expect


def _cnn_leaf_sizes(arch):
    """Elements a client of each floating leaf of a CNN, in sorted path
    order (as swarm_distribution_matrix hands them to the kernel)."""
    params = build_model(get_config(arch)).init(torch.Generator().manual_seed(0))
    pairs = sorted(tree_paths_and_leaves(params), key=lambda kv: kv[0])
    return [leaf.numel() for _, leaf in pairs if leaf.is_floating_point()]


@pytest.mark.parametrize("arch,T", [("squeezenet-dr", 28), ("alexnet-dr", 10), ("vgg-dr", 12),
                                    ("inception-dr", 20)])
def test_param_stats_plan_makes_every_cnn_round_one_launch(arch, T):
    sizes = _cnn_leaf_sizes(arch)
    assert len(sizes) == T
    (ln,) = k_stats.plan(sizes, 14)
    assert (ln.start, ln.stop) == (0, T)
    assert ln.n_ctas == 14 * sum(k_stats.slices(n) for n in sizes)


@pytest.mark.parametrize("sizes,N,expect", [
    # the round: one launch, a CTA a (leaf, client), nothing splits
    (_cnn_leaf_sizes("squeezenet-dr"), 14, [(0, 28, 392, 0, 0)]),
    # a split leaf between two short ones: 3 slices a client, after 2 CTAs
    ([7, 40_000, 0], 2, [(0, 3, 2 + 6 + 2, 6, 2)]),
    # more leaves than the table: chunks of MAX_LEAVES, numbered afresh
    ([5] * 130, 3, [(0, 64, 192, 0, 0), (64, 128, 192, 0, 0), (128, 130, 6, 0, 0)]),
])
def test_param_stats_plan_offsets_slices_and_chunks(sizes, N, expect):
    launches = k_stats.plan(sizes, N)
    assert [(ln.start, ln.stop, ln.n_ctas, ln.n_parts, ln.n_counters)
            for ln in launches] == expect
    for ln in launches:
        chunk = sizes[ln.start:ln.stop]
        assert ln.slices == tuple(k_stats.slices(n) for n in chunk)
        # each leaf's CTAs follow the one before's, client-major
        assert ln.cta0 == tuple(N * sum(ln.slices[:i]) for i in range(len(chunk)))
        split = [i for i, s in enumerate(ln.slices) if s > 1]
        assert [ln.part0[i] for i in split] == [N * sum(ln.slices[j] for j in split[:k])
                                               for k in range(len(split))]
        assert [ln.ctr0[i] for i in split] == [N * k for k in range(len(split))]
        assert all(ln.part0[i] == ln.ctr0[i] == -1 for i in range(len(chunk)) if i not in split)


def test_param_stats_plan_of_a_2_31_element_row():
    """A row of 2^31 elements (and one more) plans without allocating:
    ROW_PER_CTA slices, partials and CTAs within int32."""
    n = 2**31
    (ln,) = k_stats.plan([n + 1, 3], 1)
    assert ln.slices == (n // k_stats.ROW_PER_CTA + 1, 1)
    assert ln.n_ctas == ln.slices[0] + 1 and ln.n_parts == ln.slices[0] and ln.n_counters == 1
    assert ln.cta0 == (0, ln.slices[0]) and ln.part0 == (0, -1) and ln.ctr0 == (0, -1)
    assert (ln.slices[0] - 1) * k_stats.ROW_PER_CTA < n + 1 <= ln.slices[0] * k_stats.ROW_PER_CTA


def test_param_stats_table_record_is_the_kernels_struct():
    """The wrapper's record and constants against csrc/param_stats.cu:
    a 40-byte Leaf, and the table and slice sizes the kernel assumes."""
    rec = k_stats.LEAF_RECORD
    assert rec.size == 40 and rec.format == "<Qqiiiiii"   # 8, 8, then six 4-byte fields
    src = (_build.CSRC / "param_stats.cu").read_text()
    assert f"constexpr int kMaxLeaves = {k_stats.MAX_LEAVES};" in src
    assert "static_assert(sizeof(Leaf) == 40" in src
    assert k_stats.ROW_PER_CTA % 8 == 0          # a slice starts on a 16-byte vector


def _leaf_list(seed):
    """One seeded list of client-stacked leaves: ragged sizes, fp32 and
    bf16 alternating, an empty leaf; the same numbers on both sides."""
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, 4), (5,), (70_001,), (0,), (2, 33), (1,), (9216,), (16_385,)]
    out = []
    for i, s in enumerate(shapes):
        x = (rng.normal(size=(6,) + s) * rng.uniform(0.01, 2.0) + rng.normal()).astype(np.float32)
        out.append(torch.from_numpy(x).to(torch.float32 if i % 2 == 0 else torch.bfloat16))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_param_stats_leaves_matches_reference_per_leaf(seed):
    """(N, T, 2) against the Pallas kernel (interpret) and the jnp oracle
    leaf by leaf; rtol 1e-5 / atol 1e-6 as the one-leaf tests. The empty
    leaf is NaN on every side."""
    leaves = _leaf_list(seed)
    got = ref.param_stats_leaves(leaves)
    assert got.shape == (6, len(leaves), 2) and got.dtype == torch.float32
    for t, x in enumerate(leaves):
        jx = jnp.asarray(x.numpy()) if x.dtype == torch.float32 else _bf16_from_torch(x)
        for jm, jv in (jax_ref.ref_param_stats_batched(jx), jax_ops.param_stats_batched(jx)):
            np.testing.assert_allclose(got[:, t, 0].numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got[:, t, 1].numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    assert torch.isnan(got[:, 3]).all()


def test_param_stats_leaves_off_one_cuda_device_reaches_the_kernel_which_refuses():
    """A list that is not all on the CPU is the kernel's, and the kernel
    takes only leaves on one CUDA device; an empty list is refused."""
    cpu = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.param_stats_leaves([cpu, torch.empty((2, 3), device="meta")])
    with pytest.raises(ValueError, match="CUDA"):
        k_stats.param_stats_leaves([cpu])
    with pytest.raises(ValueError, match="at least one leaf"):
        ops.param_stats_leaves([])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_library_path_names_source_hash():
    p = _build.library_path("param_stats")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libparam_stats-")
    assert p.suffix == ".so" and p != _build.library_path("kmeans_assign")


@pytest.mark.parametrize("shape", [(7,), (33, 65), (3, 5, 17)])
def test_param_stats_one_tensor_matches_the_reference(shape):
    """``ops.param_stats`` (K1 at N = 1) against the reference's
    ``ops.param_stats`` (its Pallas kernel in interpret mode) and
    ``diststats.tensor_stats``, and the port's ``tensor_stats`` against
    the reference's, fp32 within 1e-6."""
    from repro.core import diststats as jax_diststats
    from repro_torch.core import diststats
    x = np.random.default_rng(len(shape)).normal(1.0, 2.0, size=shape).astype(np.float32)
    m, v = ops.param_stats(torch.from_numpy(x))
    jm, jv = jax_ops.param_stats(jnp.asarray(x))
    tm, tv = diststats.tensor_stats(torch.from_numpy(x))
    rm, rv = jax_diststats.tensor_stats(jnp.asarray(x))
    assert m.shape == v.shape == ()
    for got, want in ((m, jm), (v, jv), (tm, rm), (tv, rv), (m, rm), (v, rv)):
        np.testing.assert_allclose(float(got), float(np.asarray(want).reshape(())), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("k_active", [None, 2, 0])
def test_kmeans_assign_matches_the_references(k_active):
    """``core.kmeans.assign`` (K2's plain version on a CPU tensor) against
    the reference's ``core.kmeans.assign``, with and without
    ``k_active``: equal ids."""
    import importlib
    jax_kmeans = importlib.import_module("repro.core.kmeans")
    kmeans = importlib.import_module("repro_torch.core.kmeans")
    rng = np.random.default_rng(7)
    X = rng.normal(size=(40, 12)).astype(np.float32)
    C = X[[3, 17, 29, 31]] + 0.01
    got = kmeans.assign(torch.from_numpy(X), torch.from_numpy(C), k_active)
    want = jax_kmeans.assign(jnp.asarray(X), jnp.asarray(C), k_active)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
