"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is
false. This file imports neither JAX nor the JAX package, so it runs on
the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_attention as k_attn  # noqa: E402
from repro_torch.kernels import flash_decode as k_decode  # noqa: E402
from repro_torch.kernels import kmeans_assign as k_assign  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import param_stats as k_stats  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

# the squeezenet-dr leaf shapes, client-stacked over 14 clients
SQUEEZENET_LEAVES = [(3, 3, 3, 32), (32,), (1, 1, 32, 8), (8,), (1, 1, 8, 32), (32,),
                     (3, 3, 8, 32), (32,), (1, 1, 64, 16), (16,), (3, 3, 16, 64), (64,),
                     (1, 1, 128, 5), (5,)]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' matmuls in full fp32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_stats_kernel_matches_plain_on_the_card(cuda, dtype):
    """rtol 1e-5 / atol 1e-6: fp32 Welford partials merged in another
    order than the plain two-pass version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    cases = [torch.randn((14,) + s, generator=gen, device=cuda) * 0.1 for s in SQUEEZENET_LEAVES]
    cases.append(torch.randn((3, 1_000_003), generator=gen, device=cuda) * 0.5 + 1e4)
    cases.append(torch.randn((1, 1 << 24), generator=gen, device=cuda))
    for x in cases:
        x = x.to(getattr(torch, dtype))
        m, v = k_stats.param_stats_batched(x)
        rm, rv = ref.param_stats_batched(x)
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-6)
    m, v = k_stats.param_stats_batched(torch.zeros((2, 0), device=cuda))
    assert torch.isnan(m).all() and torch.isnan(v).all()


def _mixed_leaves(dev, gen, N=14, split=(1 << 16) + 5):
    """The squeezenet-dr leaves of N clients, fp32 and bf16 in turn, an
    empty leaf, and a leaf whose rows split over several CTAs."""
    out = [(torch.randn((N,) + s, generator=gen, device=dev) * 0.1 + 0.02 * i)
           .to(torch.float32 if i % 2 else torch.bfloat16)
           for i, s in enumerate(SQUEEZENET_LEAVES)]
    out.insert(3, torch.zeros((N, 0), device=dev))
    out.append(torch.randn((N, split), generator=gen, device=dev) * 0.5 + 3.0)
    return out


def _assert_stats_close(got, expect):
    """mean rtol 1e-5 / atol 1e-6, var rtol 1e-4 / atol 1e-6 (NaN where
    the plain version is NaN): fp32 Welford partials merged in another
    order than the plain two-pass version."""
    torch.testing.assert_close(got[..., 0], expect[..., 0], rtol=1e-5, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(got[..., 1], expect[..., 1], rtol=1e-4, atol=1e-6, equal_nan=True)


@pytest.mark.cuda
def test_param_stats_leaves_kernel_matches_plain_in_one_launch(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    leaves = _mixed_leaves(cuda, gen)
    assert k_stats.slices(leaves[-1].shape[1]) > 1
    before = k_stats.param_stats_leaves.launches
    got = ops.param_stats_leaves(leaves)
    assert k_stats.param_stats_leaves.launches == before + 1
    assert got.shape == (14, len(leaves), 2)
    _assert_stats_close(got, ref.param_stats_leaves(leaves))
    assert torch.isnan(got[:, 3]).all()


@pytest.mark.cuda
def test_param_stats_leaves_past_the_table_take_one_launch_a_chunk(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    leaves = [torch.randn((3, 1 + i % 17), generator=gen, device=cuda)
              for i in range(k_stats.MAX_LEAVES * 2 + 3)]
    before = k_stats.param_stats_leaves.launches
    got = k_stats.param_stats_leaves(leaves)
    assert k_stats.param_stats_leaves.launches == before + 3
    _assert_stats_close(got, ref.param_stats_leaves(leaves))


@pytest.mark.cuda
def test_param_stats_batched_is_the_one_leaf_entry_of_the_same_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((5, 3, 40_000), generator=gen, device=cuda).to(torch.bfloat16)
    before = k_stats.param_stats_leaves.launches
    m, v = ops.param_stats_batched(x)
    assert k_stats.param_stats_leaves.launches == before + 1
    both = k_stats.param_stats_leaves([x])
    assert torch.equal(m, both[:, 0, 0]) and torch.equal(v, both[:, 0, 1])
    rm, rv = ref.param_stats_batched(x)
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_param_stats_graph_replays_find_the_merge_counters_at_zero(cuda):
    """A call with split rows captured in a CUDA graph (its counters made
    before the capture, on the capture's stream) and replayed three
    times on new inputs written in place: each replay equals an eager
    call and the plain version, which the last CTA of a split row can
    only give if it found its counter back at 0."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    leaves = _mixed_leaves(cuda, gen, split=(1 << 18) + 3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        k_stats.param_stats_leaves(leaves)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = k_stats.param_stats_leaves(leaves)
    for _ in range(3):
        for x in leaves:
            x.copy_(torch.randn(x.shape, generator=gen, device=cuda) * 2.0 - 1.0)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, k_stats.param_stats_leaves(leaves), rtol=0, atol=0,
                                   equal_nan=True)
        _assert_stats_close(out, ref.param_stats_leaves(leaves))


@pytest.mark.cuda
def test_param_stats_refuses_what_it_does_not_take(cuda):
    """A leaf off the card, fp64, non-contiguous or of another client
    axis is refused; an fp16 leaf beside an fp32 one is taken and matches
    the plain version."""
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        k_stats.param_stats_leaves([x, torch.zeros((4, 8))])
    h = torch.randn((4, 8), device=cuda).to(torch.float16)
    _assert_stats_close(k_stats.param_stats_leaves([x, h]), ref.param_stats_leaves([x, h]))
    with pytest.raises(TypeError, match="float64"):
        k_stats.param_stats_leaves([x, torch.zeros((4, 8), device=cuda, dtype=torch.float64)])
    with pytest.raises(ValueError, match="contiguous"):
        k_stats.param_stats_leaves([x, torch.zeros((8, 4), device=cuda).t()])
    with pytest.raises(ValueError, match="one client axis"):
        k_stats.param_stats_leaves([x, torch.zeros((5, 8), device=cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float16", "float8_e4m3fn", "float8_e5m2"])
def test_param_stats_takes_fp16_and_fp8_leaves_and_any_client_count(cuda, dtype):
    """The squeezenet-dr leaves in fp16 and both fp8 types (rows of 5 to
    9,216 elements, most starting off a 16-byte boundary), an odd row and
    a row split over 5 CTAs, in one launch; then a (70,000, 56) stack,
    past the old limit of 65,535 clients. K1's tolerance against the
    plain version, which upcasts the same values."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    dt = getattr(torch, dtype)
    leaves = [(torch.randn((14,) + s, generator=gen, device=cuda) * 0.1 + 0.02 * i).to(dt)
              for i, s in enumerate(SQUEEZENET_LEAVES)]
    leaves += [torch.randn((14, 33), generator=gen, device=cuda).to(dt),
               torch.randn((14, (1 << 16) + 5), generator=gen, device=cuda).to(dt)]
    before = k_stats.param_stats_leaves.launches
    got = k_stats.param_stats_leaves(leaves)
    assert k_stats.param_stats_leaves.launches == before + 1
    _assert_stats_close(got, ref.param_stats_leaves(leaves))
    wide = torch.randn((70_000, 56), generator=gen, device=cuda).to(dt)
    m, v = k_stats.param_stats_batched(wide)
    rm, rv = ref.param_stats_batched(wide)
    _assert_stats_close(torch.stack([m, v], 1)[:, None], torch.stack([rm, rv], 1)[:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,K", [(14, 56, 3), (1000, 260, 37), (129, 7, 1), (500, 191, 64),
                                   (300, 1, 5), (300, 33, 7), (70_000, 56, 3)])
def test_kmeans_assign_kernel_matches_plain_on_the_card(cuda, N, F, K):
    gen = torch.Generator(device=cuda).manual_seed(N)
    X = torch.randn((N, F), generator=gen, device=cuda)
    C = torch.randn((K, F), generator=gen, device=cuda)
    before = k_assign.kmeans_assign.launches
    assert torch.equal(k_assign.kmeans_assign(X, C), ref.kmeans_assign(X, C))
    assert k_assign.kmeans_assign.launches == before + 1


@pytest.mark.cuda
def test_kmeans_assign_rows_on_duplicated_centroids_go_to_the_first(cuda):
    """Rows equal to one of two centroids that each appear twice: every
    distance pair ties exactly, and the first copy wins, as in the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    a, b = torch.randn((2, 56), generator=gen, device=cuda)
    C = torch.stack([a, b, a, b])
    X = torch.stack([a, b] * 20)
    got = k_assign.kmeans_assign(X, C)
    assert torch.equal(got, ref.kmeans_assign(X, C))
    assert got.tolist() == [0, 1] * 20


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,K", [(14, 56, 5), (14, 56, 3), (300, 200, 6), (70_000, 56, 4)])
def test_kmeans_assign_k_active_matches_plain_on_the_card(cuda, N, F, K):
    """Every k_active from -1 to K + 1 as a () int32 tensor on the card
    (F = 200 takes the streaming variant); the dead centroids are copies
    of rows of X, nearer than every live one. Each call is one launch
    that carried the operand."""
    gen = torch.Generator(device=cuda).manual_seed(N + K)
    X = torch.randn((N, F), generator=gen, device=cuda)
    C = torch.randn((K, F), generator=gen, device=cuda)
    C[K // 2:] = X[:K - K // 2]
    for ka in range(-1, K + 2):
        t = torch.tensor(ka, dtype=torch.int32, device=cuda)
        before = (k_assign.kmeans_assign.launches, k_assign.kmeans_assign.k_active_launches)
        got = ops.kmeans_assign(X, C, t)
        assert torch.equal(got, ref.kmeans_assign(X, C, t)), f"k_active={ka}"
        assert (k_assign.kmeans_assign.launches,
                k_assign.kmeans_assign.k_active_launches) == (before[0] + 1, before[1] + 1)
        if ka <= 0:
            assert not got.any()
    assert torch.equal(k_assign.kmeans_assign(X, C, torch.tensor(K, device=cuda)),
                       k_assign.kmeans_assign(X, C))


@pytest.mark.cuda
def test_kmeans_assign_k_active_replays_in_a_graph_with_the_buffer_value(cuda):
    """The operand is read on the device: a captured call replays with
    whatever the buffer holds."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    X = torch.randn((14, 56), generator=gen, device=cuda)
    C = torch.randn((5, 56), generator=gen, device=cuda)
    ka = torch.tensor(5, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_assign.kmeans_assign(X, C, ka)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k_assign.kmeans_assign(X, C, ka)
    for value in (1, 3, 0, 5, 2):
        ka.fill_(value)
        graph.replay()
        assert torch.equal(out, ref.kmeans_assign(X, C, value)), value


@pytest.mark.cuda
def test_kmeans_assign_refuses_a_k_active_it_does_not_take(cuda):
    X, C = torch.zeros((4, 8), device=cuda), torch.zeros((3, 8), device=cuda)
    for bad in (torch.tensor(2), torch.tensor([2], device=cuda),
                torch.tensor(2.0, device=cuda), torch.tensor(True, device=cuda), 2):
        with pytest.raises(ValueError, match="k_active"):
            k_assign.kmeans_assign(X, C, bad)


@pytest.mark.cuda
def test_kmeans_assign_refuses_centroids_past_shared_memory(cuda):
    """K = 64 at F = 260 (66,816 B of C and its norms, which the kernel
    before tiles refused) passes C in 8 tiles of 8 centroids: ids equal
    to the plain version. fp64 is refused."""
    gen = torch.Generator(device=cuda).manual_seed(260)
    X = torch.randn((4, 260), generator=gen, device=cuda)
    C = torch.randn((64, 260), generator=gen, device=cuda)
    assert k_assign.c_tiles(64, 260) == (8, 1)
    assert torch.equal(k_assign.kmeans_assign(X, C), ref.kmeans_assign(X, C))
    with pytest.raises(TypeError, match="float64"):
        k_assign.kmeans_assign(X.double(), C)


# (N, F, K, X dtype, C dtype, k_active): the storage types, and C past one
# tile (K above 8 or F chunked past 1,024), with k_active
KMEANS_CONTRACT_CASES = [
    (300, 56, 3, "bfloat16", "float16", None),
    (300, 4100, 4, "bfloat16", "float16", None),
    (257, 130, 5, "float16", "float8_e4m3fn", None),
    (257, 130, 5, "float8_e5m2", "float32", 3),
    (4096, 4096, 16, "bfloat16", "bfloat16", None),
    (4096, 4096, 16, "bfloat16", "bfloat16", 11),
    (1000, 200, 70, "float32", "float32", 65),
    (999, 100, 130, "float32", "bfloat16", 129),
    (70_000, 56, 3, "float8_e4m3fn", "float8_e4m3fn", None),
    # 12 centroids, 5 live: one tile, staged once a CTA for its 3 groups
    (20_000, 100, 12, "float32", "float32", 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KMEANS_CONTRACT_CASES)
def test_kmeans_assign_takes_every_storage_type_and_any_c(cuda, case):
    """Ids equal to the plain version, which upcasts X and C as the
    kernel does; every distance is computed in fp32 from the same
    upcast values."""
    N, F, K, xdt, cdt, ka = case
    gen = torch.Generator(device=cuda).manual_seed(N + F + K)
    X = torch.randn((N, F), generator=gen, device=cuda).to(getattr(torch, xdt))
    C = torch.randn((K, F), generator=gen, device=cuda).to(getattr(torch, cdt))
    ka_t = None if ka is None else torch.tensor(ka, dtype=torch.int32, device=cuda)
    got = k_assign.kmeans_assign(X, C, ka_t)
    assert torch.equal(got, ref.kmeans_assign(X, C, ka_t))


# chip_smoke.py phase 5: B, H, KV, S, D, pos, window, stored in the serve
# cache's (B,S,KV,D) layout (read through a transposed view)
DECODE_CASES = [
    (4, 32, 8, 1024, 64, [0, 1023, 517, 33], 0, True),
    (4, 32, 8, 2048, 64, [0, 2047, 1500, 7], 0, True),
    (4, 32, 8, 2048, 64, 900, 0, True),
    (4, 32, 8, 2048, 64, [2047, 3, 700, 0], 256, True),
    (4, 32, 8, 1000, 64, [999, 0, 512, 64], 0, True),
    (2, 8, 8, 200, 64, [150, 199], 0, False),
    (1, 8, 2, 1024, 128, 1023, 0, False),
    (1, 8, 1, 300, 256, 299, 0, False),
    (2, 4, 2, 96, 32, [0, 37], 0, False),
    # zamba2-1.2b's shared attention (chip_smoke.py phase 18): G = 1, D 64,
    # its 8,192 window wider than the cache; the per-token loop's cache of
    # 129 positions (a ragged last tile) at a scalar position, as the loop
    # passes it
    (4, 32, 32, 128, 64, [127, 0, 64, 100], 8192, True),
    (4, 32, 32, 129, 64, [128, 0, 64, 126], 8192, True),
    (4, 32, 32, 129, 64, 126, 8192, True),
    (4, 32, 32, 4096, 64, [4095, 2047, 17, 3000], 8192, True),
    # whisper-base (chip_smoke.py phase 19): G = 1, D 64; the loop's self
    # cache of 129 positions and the 1,500-key cross cache at its last key,
    # as encdec decode passes it
    (4, 8, 8, 129, 64, 126, 0, True),
    (4, 8, 8, 1500, 64, 1499, 0, True),
    (4, 8, 8, 1500, 64, [1499, 0, 750, 1124], 0, True),
    # internvl2-26b: G = 6 (48/8 heads of 128), six warps a CTA
    (4, 48, 8, 129, 128, 126, 0, True),
    (4, 48, 8, 129, 128, [128, 0, 64, 96], 0, True),
    (4, 48, 8, 4096, 128, 4093, 0, True),
    (4, 48, 8, 4096, 128, [4095, 0, 2048, 3071], 0, True),
]


def _assert_fp8_close(got, o32, rel=2e-5):
    """An fp8 output of a kernel against the plain version's fp32 output
    ``o32`` (the plain version on q upcast): each byte is the reference's
    rounding (``ref.astype``) of a value within ``rel`` of max |o32| of
    o32, so it equals the plain version's byte wherever o32 is farther
    than that from an fp8 rounding edge, and is its neighbour across the
    edge otherwise (the two sum in other orders). NaN only where one of
    the edges rounds to NaN."""
    tol = rel * o32.abs().nan_to_num(posinf=0, neginf=0).max().item()
    lo, hi = ref.astype(o32 - tol, got.dtype).float(), ref.astype(o32 + tol, got.dtype).float()
    g = got.float()
    nan = torch.isnan(g)
    inside = (g >= lo.nan_to_num(nan=-float("inf"))) & (g <= hi.nan_to_num(nan=float("inf")))
    ok = torch.where(nan, torch.isnan(lo) | torch.isnan(hi), inside)
    assert bool(ok.all()), f"{int((~ok).sum())} of {ok.numel()} fp8 outputs off the plain version"


def _decode_inputs(dev, B, H, KV, S, D, dtype, stored, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, 1, D), generator=gen, device=dev).to(dtype)
    shape = (B, S, KV, D) if stored else (B, KV, S, D)
    k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
    return (q, k.transpose(1, 2), v.transpose(1, 2)) if stored else (q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_decode_kernel_matches_plain_on_the_card(cuda, case, dtype):
    """fp32 2e-5, the reference's tolerance for its own kernel against its
    oracle; bf16 and fp16 2e-2 of the plain output's largest magnitude
    (its own 2e-2, scaled: the outputs are means of O(1) values over up
    to S keys, so a flat 2e-2 would pass a kernel that dropped keys)."""
    B, H, KV, S, D, pos, window, stored = case
    q, k, v = _decode_inputs(cuda, B, H, KV, S, D, getattr(torch, dtype), stored, seed=S + D)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda) if isinstance(pos, list) else pos
    got = k_decode.flash_decode(q, k, v, pos_t, window)
    expect = ref.decode_attention(q, k, v, pos_t, window).float()
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    if dtype == "float32":
        torch.testing.assert_close(got.float(), expect, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), expect, rtol=0,
                                   atol=2e-2 * expect.abs().max().item())


@pytest.mark.cuda
def test_ops_flash_decode_on_the_card_launches_the_kernel_only(cuda, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    q, k, v = _decode_inputs(cuda, 2, 8, 2, 64, 64, torch.bfloat16, True, seed=1)
    expect = ref.decode_attention(q, k, v, 40)
    monkeypatch.setattr(ref, "decode_attention", plain)
    before = k_decode.flash_decode.launches
    got = ops.flash_decode(q, k, v, 40)
    assert k_decode.flash_decode.launches == before + 1
    torch.testing.assert_close(got.float(), expect.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_decode_refuses_what_it_does_not_take(cuda):
    """D 48, D 264 and an fp32 q against a bf16 cache are taken and match
    the plain version, and so does an fp8 q (its bytes within the fp32
    tolerance, :func:`_assert_fp8_close`); an fp64 q or cache and a D of
    0 are refused."""
    gen = torch.Generator(device=cuda).manual_seed(48)
    q = torch.randn((1, 4, 1, 48), generator=gen, device=cuda)
    kv = torch.randn((1, 2, 8, 48), generator=gen, device=cuda)
    torch.testing.assert_close(k_decode.flash_decode(q, kv, kv, 3),
                               ref.decode_attention(q, kv, kv, 3), rtol=2e-5, atol=2e-5)
    q, kb = torch.randn((1, 4, 1, 64), generator=gen, device=cuda), \
        torch.randn((1, 2, 8, 64), generator=gen, device=cuda).to(torch.bfloat16)
    torch.testing.assert_close(k_decode.flash_decode(q, kb, kb, 3),
                               ref.decode_attention(q, kb, kb, 3), rtol=2e-5, atol=2e-5)
    q264, kv264 = torch.randn((1, 4, 1, 264), generator=gen, device=cuda), \
        torch.randn((1, 2, 8, 264), generator=gen, device=cuda)
    torch.testing.assert_close(k_decode.flash_decode(q264, kv264, kv264, 3),
                               ref.decode_attention(q264, kv264, kv264, 3), rtol=2e-5, atol=2e-5)
    for fp8 in (torch.float8_e4m3fn, torch.float8_e5m2):
        got = k_decode.flash_decode(q.to(fp8), kb, kb, 3)
        assert got.dtype == fp8
        _assert_fp8_close(got, ref.decode_attention(q.to(fp8).float(), kb, kb, 3))
    with pytest.raises(TypeError, match="q must be of .*float64"):
        k_decode.flash_decode(q.double(), kb, kb, 3)
    with pytest.raises(TypeError, match="float64"):
        k_decode.flash_decode(q, kb.double(), kb, 3)
    with pytest.raises(ValueError, match="D >= 1"):
        k_decode.flash_decode(q[..., :0], kb[..., :0], kb[..., :0], 3)


@pytest.mark.cuda
def test_flash_decode_graph_replays_find_the_merge_counters_at_zero(cuda):
    """One call captured in a CUDA graph and replayed three times on new
    inputs written in place: each replay equals the plain version, which
    it can only do if the last split of every (row, kv head) found its
    counter back at 0."""
    B, H, KV, S, D = 4, 32, 8, 2048, 64
    q, k, v = _decode_inputs(cuda, B, H, KV, S, D, torch.bfloat16, True, seed=11)
    pos = torch.tensor([2047, 1535, 1023, 511], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_decode.flash_decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k_decode.flash_decode(q, k, v, pos)
    gen = torch.Generator(device=cuda).manual_seed(12)
    for rep in range(3):
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
        pos.copy_(torch.randint(0, S, (B,), generator=gen, device=cuda, dtype=torch.int32))
        graph.replay()
        torch.testing.assert_close(out.float(), ref.decode_attention(q, k, v, pos).float(),
                                   rtol=2e-2, atol=2e-2, msg=lambda m: f"replay {rep}: {m}")


@pytest.mark.cuda
def test_flash_decode_two_calls_of_different_shapes_in_a_row(cuda):
    """Two shapes back to back on one stream share the counter buffer:
    the second, with more (row, kv head) pairs and another split plan,
    still merges right; then the first shape again."""
    shapes = [(2, 8, 2, 300, 64, [299, 5]), (4, 32, 8, 2048, 64, [2047, 0, 1000, 64]),
              (2, 8, 2, 300, 64, [17, 299])]
    for i, (B, H, KV, S, D, p) in enumerate(shapes):
        q, k, v = _decode_inputs(cuda, B, H, KV, S, D, torch.bfloat16, True, seed=20 + i)
        pos = torch.tensor(p, dtype=torch.int32, device=cuda)
        got = k_decode.flash_decode(q, k, v, pos)
        torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, pos).float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_pos_zero_in_every_row(cuda, dtype):
    """Only column 0 is valid: every split but the first is empty (l = 0)
    and the output is v's first row."""
    B, H, KV, S, D = 4, 32, 8, 2048, 64
    q, k, v = _decode_inputs(cuda, B, H, KV, S, D, getattr(torch, dtype), True, seed=30)
    pos = torch.zeros(B, dtype=torch.int32, device=cuda)
    got = k_decode.flash_decode(q, k, v, pos)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, pos).float(),
                               rtol=tol, atol=tol)
    first = v[:, :, 0].repeat_interleave(H // KV, dim=1)[:, :, None]
    torch.testing.assert_close(got.float(), first.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_smoke_generate_on_the_card_matches_the_cpu(cuda):
    """granite-3-2b's smoke config (fp32) through the engine on the card
    and on the CPU from the same weights: the same tokens, and the
    kernel launched once per layer per decode call."""
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config("granite-3-2b").smoke())
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n) for n in (3, 9, 14)]
    buckets = (serve.BucketSpec(2, 16), serve.BucketSpec(2, 48))
    before = k_decode.flash_decode.launches
    res, eng = serve.generate(model, params, prompts, max_new_tokens=5, buckets=buckets,
                              device=cuda, return_engine=True)
    assert k_decode.flash_decode.launches - before == model.cfg.n_layers * eng.n_decode_calls
    cpu = serve.generate(model, params, prompts, max_new_tokens=5, buckets=buckets, device="cpu")
    assert [r.tokens for r in res] == [r.tokens for r in cpu]


@pytest.mark.cuda
def test_apply_ssm_on_the_card_matches_the_cpu(cuda):
    """mamba2-370m's SSD block at smoke widths in fp32 (chunk 8, S 32,
    four chunks) from the same params and input: y and the final state
    within 1e-5 (the same fp32 operations, sums in another order), the
    carry-passing split too."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.utils.tree import tree_map

    cfg = replace(get_config("mamba2-370m").smoke(), ssm_chunk=8)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    pc = tree_map(lambda t: t.to(cuda), p)
    y, st = ssm.apply_ssm(p, x, cfg)
    yc, stc = ssm.apply_ssm(pc, x.to(cuda), cfg)
    torch.testing.assert_close(yc.cpu(), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stc.cpu(), st, rtol=1e-5, atol=1e-5)
    ya, (sa, ca) = ssm.apply_ssm(pc, x[:, :16].to(cuda), cfg, return_carry=True)
    yb, sb = ssm.apply_ssm(pc, x[:, 16:].to(cuda), cfg, initial_state=sa, initial_conv=ca)
    torch.testing.assert_close(torch.cat([ya, yb], 1).cpu(), y, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sb.cpu(), st, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_zamba2_smoke_decode_on_the_card_matches_the_cpu(cuda):
    """zamba2-1.2b's smoke config (fp32) through the per-token loop on the
    card and on the CPU from the same weights: the same tokens; the
    teacher-forced decode logits within 1e-4; K3 launched once per shared
    attention block per decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import loop_generate
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    model = build_model(get_config("zamba2-1.2b").smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    pc = tree_map(lambda t: t.to(cuda), params)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)))
    before = k_decode.flash_decode.launches
    toks = loop_generate(model, pc, prompts.to(cuda), 5)
    n_shared = cfg.n_layers // cfg.attn_every
    assert k_decode.flash_decode.launches - before == n_shared * (6 + 4)
    cpu = loop_generate(model, params, prompts, 5)
    assert torch.equal(toks.cpu(), cpu)
    seq = torch.cat([prompts, cpu], 1)
    with torch.no_grad():
        caches = [model.init_cache(2, 16, d) for d in (cuda, "cpu")]
        for t in range(seq.shape[1]):
            a, _ = model.decode_step(pc, seq[:, t:t + 1].to(cuda), caches[0], t)
            b, _ = model.decode_step(params, seq[:, t:t + 1], caches[1], t)
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_encdec_and_vlm_smoke_decode_on_the_card_match_the_cpu(cuda, arch):
    """The smoke config (fp32) through the per-token loop on the card and
    on the CPU from the same weights: the same tokens, K3 launched a
    decode step once a layer (twice for encdec: self and cross); the
    teacher-forced decode logits within 1e-4, whisper's against the same
    random non-zero cross cache on both."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import loop_generate
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    model = build_model(get_config(arch).smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    pc = tree_map(lambda t: t.to(cuda), params)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)))
    before = k_decode.flash_decode.launches
    toks = loop_generate(model, pc, prompts.to(cuda), 5)
    per_step = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
    assert k_decode.flash_decode.launches - before == per_step * (6 + 4)
    cpu = loop_generate(model, params, prompts, 5)
    assert torch.equal(toks.cpu(), cpu)
    seq = torch.cat([prompts, cpu], 1)
    with torch.no_grad():
        caches = [model.init_cache(2, 16, d) for d in (cuda, "cpu")]
        if cfg.family == "encdec":
            gen = torch.Generator().manual_seed(1)
            for name in ("cross_k", "cross_v"):
                caches[1][name].normal_(generator=gen)
                caches[0][name].copy_(caches[1][name])
        for t in range(seq.shape[1]):
            a, _ = model.decode_step(pc, seq[:, t:t + 1].to(cuda), caches[0], t)
            b, _ = model.decode_step(params, seq[:, t:t + 1], caches[1], t)
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_adafactor_and_microbatched_step_on_the_card_match_the_cpu(cuda):
    """whisper-base's smoke config (fp32): one adafactor update from the
    same gradients on the card and on the CPU, params and state within
    1e-5; one microbatched (2) sgd step, params within 1e-5 (sgd is linear
    in the gradient, which fp32 sums in other orders move by ~1e-7)."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.steps import make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    model = build_model(get_config("whisper-base").smoke())
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
             "audio_embed": torch.from_numpy(
                 rng.normal(size=(4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    grads, _ = torch.func.grad_and_value(model.loss, has_aux=True)(params, batch)
    ada = make_optimizer(OptimizerConfig(name="adafactor", lr=1e-3, grad_clip=1.0))
    on_card = tree_map(lambda t: t.to(cuda), [params, grads, batch])
    got = list(ada.update(on_card[1], ada.init(on_card[0]), on_card[0], 1e-3))
    want = list(ada.update(grads, ada.init(params), params, 1e-3))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    sgd = make_optimizer(OptimizerConfig(name="sgd", lr=1e-2, grad_clip=0.0))
    step = make_train_step(model, sgd, microbatches=2)
    got, _, _ = step(on_card[0], sgd.init(on_card[0]), on_card[2], 1e-2)
    want, _, _ = step(params, sgd.init(params), batch, 1e-2)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


# K3's fp8 cache and kimi-k2's head_dim 112: B, H, KV, S, D, q dtype, cache
# dtype, pos, window (the cache stored (B,S,KV,D), read through a view)
DECODE_FP8_D112_CASES = [
    (4, 64, 8, 1024, 112, "bfloat16", "bfloat16", [0, 1023, 517, 33], 0),
    (4, 64, 8, 2048, 112, "bfloat16", "bfloat16", [2047, 0, 1500, 7], 0),
    (4, 64, 8, 2048, 112, "float32", "float32", [2047, 3, 700, 1024], 256),
    (2, 16, 2, 333, 112, "float16", "float16", [332, 100], 0),
    (4, 32, 8, 2048, 64, "bfloat16", "float8_e4m3fn", [2047, 1535, 1023, 511], 0),
    (4, 32, 8, 2048, 64, "bfloat16", "float8_e4m3fn", [2047, 3, 700, 255], 256),
    (4, 64, 8, 2048, 112, "bfloat16", "float8_e4m3fn", [2047, 1535, 1023, 511], 0),
    (4, 64, 8, 2048, 112, "bfloat16", "float8_e4m3fn", [2047, 3, 700, 255], 256),
    (2, 8, 2, 500, 128, "float32", "float8_e4m3fn", [499, 0], 0),
    (2, 8, 2, 500, 32, "float16", "float8_e4m3fn", [250, 499], 100),
    (1, 8, 1, 300, 256, "bfloat16", "float8_e4m3fn", 299, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_FP8_D112_CASES)
def test_flash_decode_fp8_cache_and_d112_match_plain_on_the_card(cuda, case):
    """fp32 q on an fp32 cache 2e-5, else 2e-2 (the reference's
    tolerances); the plain version reads the fp8 cache upcast, as the
    kernel does, so the comparison holds the kernel's arithmetic."""
    B, H, KV, S, D, qdt, kvdt, pos, window = case
    gen = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn((B, H, 1, D), generator=gen, device=cuda).to(getattr(torch, qdt))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=cuda).to(getattr(torch, kvdt))
            .transpose(1, 2) for _ in range(2))
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda) if isinstance(pos, list) else pos
    got = k_decode.flash_decode(q, k, v, pos_t, window)
    expect = ref.decode_attention(q, k, v, pos_t, window)
    tol = 2e-5 if kvdt == "float32" else 2e-2
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_decode_refuses_mixed_caches(cuda):
    """Mixed caches (e4m3 k, bf16 v), an e5m2 cache and D 96 are taken
    now: each matches the plain version within bf16's 2e-2 (fp32 2e-5)."""
    gen = torch.Generator(device=cuda).manual_seed(112)
    q = torch.randn((1, 4, 1, 112), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((1, 2, 16, 112), generator=gen, device=cuda)
    k8 = k.to(torch.float8_e4m3fn)
    for kk, vv in ((k8, k8.to(torch.bfloat16)), (k.to(torch.float8_e5m2),) * 2):
        torch.testing.assert_close(k_decode.flash_decode(q, kk, vv, 3).float(),
                                   ref.decode_attention(q, kk, vv, 3).float(), rtol=2e-2,
                                   atol=2e-2)
    q96, kv96 = torch.randn((1, 4, 1, 96), generator=gen, device=cuda), \
        torch.randn((1, 2, 16, 96), generator=gen, device=cuda)
    torch.testing.assert_close(k_decode.flash_decode(q96, kv96, kv96, 3),
                               ref.decode_attention(q96, kv96, kv96, 3), rtol=2e-5, atol=2e-5)


# K3 over the widened contract: B, H, KV, S, D, q dtype, k dtype, v dtype,
# pos, window, stored as the serve cache (B,S,KV,D)
DECODE_CONTRACT_CASES = [
    (4, 32, 8, 4096, 80, "float16", "float16", "float16", [4095, 0, 2048, 3071], 0, True),
    (4, 32, 8, 2048, 96, "float16", "float16", "float16", 2047, 0, True),
    (2, 64, 1, 8192, 128, "bfloat16", "bfloat16", "bfloat16", [8191, 4000], 0, True),
    (4, 48, 1, 2048, 192, "float16", "float8_e5m2", "float8_e5m2", [2047, 1500, 1024, 7], 1024,
     True),
    (4, 48, 8, 1024, 192, "float32", "float32", "float32", [1023, 0, 500, 900], 0, False),
    (4, 32, 8, 2048, 64, "bfloat16", "float16", "float16", [2047, 1535, 1023, 511], 0, True),
    (2, 12, 2, 300, 33, "float32", "float32", "float32", [299, 5], 17, False),   # ragged D
    (2, 9, 1, 300, 40, "float16", "float8_e4m3fn", "float8_e5m2", [299, 120], 0, True),
    (1, 6, 3, 777, 256, "bfloat16", "float8_e5m2", "bfloat16", 776, 0, True),
    (2, 40, 4, 500, 1, "float32", "float32", "float32", [499, 0], 0, False),
    # granite's fp16 serve on an e5m2 cache (DP 64, G 4)
    (4, 32, 8, 2048, 64, "float16", "float8_e5m2", "float8_e5m2", [2047, 0, 1000, 1500], 0,
     True),
    (4, 32, 8, 2048, 64, "float16", "float8_e5m2", "float8_e5m2", [2047, 3, 700, 255], 256,
     True),
    (4, 32, 8, 1024, 64, "float16", "float8_e5m2", "float8_e5m2", 1023, 0, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CONTRACT_CASES)
def test_flash_decode_takes_any_d_group_and_cache_types(cuda, case):
    """Any D <= 256 (on the next layout), any G (query chunks of 8), k
    and v each of any storage type: fp32 q 2e-5 (with an fp32 cache),
    else 2e-2 of the plain output's largest magnitude, as the path
    cases; one launch a call."""
    B, H, KV, S, D, qdt, kdt, vdt, pos, window, stored = case
    gen = torch.Generator(device=cuda).manual_seed(S + D + H)
    q = torch.randn((B, H, 1, D), generator=gen, device=cuda).to(getattr(torch, qdt))
    shape = (B, S, KV, D) if stored else (B, KV, S, D)
    k = torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, kdt))
    v = torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, vdt))
    if stored:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda) if isinstance(pos, list) else pos
    before = k_decode.flash_decode.launches
    got = k_decode.flash_decode(q, k, v, pos_t, window)
    assert k_decode.flash_decode.launches == before + 1
    expect = ref.decode_attention(q, k, v, pos_t, window).float()
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    if (qdt, kdt, vdt) == ("float32",) * 3:
        torch.testing.assert_close(got.float(), expect, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), expect, rtol=0,
                                   atol=2e-2 * expect.abs().max().item())


@pytest.mark.cuda
def test_flash_decode_query_chunks_replay_in_a_graph(cuda):
    """G 48 in 6 query chunks on an e5m2 cache, captured once and
    replayed three times on new inputs: the (row, chunk) merge counters
    are back at 0 after every launch."""
    gen = torch.Generator(device=cuda).manual_seed(48)
    B, H, KV, S, D = 4, 48, 1, 2048, 192
    q = torch.randn((B, H, 1, D), generator=gen, device=cuda).to(torch.float16)
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=cuda).to(torch.float8_e5m2)
            .transpose(1, 2) for _ in range(2))
    pos = torch.tensor([2047, 1535, 1023, 511], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_decode.flash_decode(q, k, v, pos, 1024)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k_decode.flash_decode(q, k, v, pos, 1024)
    for _ in range(3):
        q.copy_(torch.randn(q.shape, generator=gen, device=cuda))
        k.copy_(torch.randn(k.shape, generator=gen, device=cuda))
        pos.copy_(torch.randint(0, S, (B,), generator=gen, device=cuda, dtype=torch.int32))
        graph.replay()
        expect = ref.decode_attention(q, k, v, pos, 1024).float()
        torch.testing.assert_close(out.float(), expect, rtol=0,
                                   atol=2e-2 * expect.abs().max().item())


# K3's last two gaps closed: D above 256 (the wide kernel) and an fp8 q.
# B, H, KV, S, D, q, k, v dtypes, pos, window, stored (B,S,KV,D)
DECODE_WIDE_CASES = [
    (2, 8, 2, 1000, 320, "float16", "float16", "float16", [999, 400], 0, True),
    (4, 16, 4, 4096, 512, "bfloat16", "bfloat16", "bfloat16", [4095, 3000, 2047, 100], 0, True),
    (1, 8, 2, 2048, 1024, "float32", "float32", "float32", [2047], 512, False),
    (2, 12, 2, 300, 257, "float32", "bfloat16", "float8_e5m2", [299, 0], 0, True),   # G 6
    (2, 6, 1, 300, 600, "float8_e5m2", "float8_e4m3fn", "float16", [299, 10], 64, True),
    (4, 32, 8, 2048, 64, "float8_e4m3fn", "float8_e4m3fn", "float8_e4m3fn",
     [2047, 1535, 1023, 511], 0, True),
    (4, 32, 8, 2048, 64, "float8_e5m2", "float8_e5m2", "float8_e5m2", [2047, 3, 700, 255], 256,
     True),
    (4, 32, 8, 2048, 64, "float8_e4m3fn", "bfloat16", "bfloat16", [2047, 1535, 1023, 511], 0,
     True),
    (4, 64, 8, 2048, 112, "float8_e4m3fn", "bfloat16", "bfloat16", [2047, 1000, 17, 1800], 0,
     True),
]


def _check_decode(cuda, case, gen):
    B, H, KV, S, D, qdt, kdt, vdt, pos, window, stored = case
    q = torch.randn((B, H, 1, D), generator=gen, device=cuda).to(getattr(torch, qdt))
    shape = (B, S, KV, D) if stored else (B, KV, S, D)
    k = torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, kdt))
    v = torch.randn(shape, generator=gen, device=cuda).to(getattr(torch, vdt))
    if stored:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = k_decode.flash_decode.launches
    got = k_decode.flash_decode(q, k, v, pos_t, window)
    assert k_decode.flash_decode.launches == before + 1
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    expect = ref.decode_attention(q.float(), k, v, pos_t, window)
    if qdt.startswith("float8"):
        _assert_fp8_close(got, expect)
    elif (qdt, kdt, vdt) == ("float32",) * 3:
        torch.testing.assert_close(got, expect, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), expect, rtol=0,
                                   atol=2e-2 * expect.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_WIDE_CASES)
def test_flash_decode_takes_any_d_and_an_fp8_q(cuda, case):
    """D 257 to 1,024 and an fp8 q (on fp8, bf16 and fp16 caches) launch
    the kernel once a call and match the plain version: fp32 2e-5, half
    types 2e-2 of the largest output, fp8 by :func:`_assert_fp8_close`."""
    _check_decode(cuda, case, torch.Generator(device=cuda).manual_seed(case[3] + case[4]))


# values of constant V rows on both sides of fp8's edges: e4m3 is NaN
# above 464, e5m2 inf from 61,440
OVERFLOW_V = [460.0, -466.0, 470.0, -300.0, 61000.0, 62000.0, -62500.0, 1.5]


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("D", [64, 320])
def test_fp8_outputs_past_the_range_equal_the_plain_bytes(cuda, qdt, D):
    """K3 and K4 on constant V rows of ``OVERFLOW_V``: the output bytes
    equal the plain version's, NaN and inf where they are."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    fp8 = getattr(torch, qdt)
    vals = torch.tensor(OVERFLOW_V, device=cuda).repeat(D // len(OVERFLOW_V) + 1)[:D]
    k = torch.randn((2, 2, 300, D), generator=gen, device=cuda).to(torch.bfloat16)
    v = vals.expand(2, 2, 300, D).contiguous()
    q = torch.randn((2, 8, 1, D), generator=gen, device=cuda).to(fp8)
    pos = torch.tensor([299, 40], dtype=torch.int32, device=cuda)
    got = k_decode.flash_decode(q, k, v, pos)
    assert torch.equal(got.view(torch.uint8), ref.decode_attention(q, k, v, pos).view(torch.uint8))
    assert torch.isnan(got.float()).any() or qdt == "float8_e5m2"
    assert torch.isinf(got.float()).any() or qdt == "float8_e4m3fn"
    q = torch.randn((2, 8, 128, D), generator=gen, device=cuda).to(fp8)
    got = k_attn.flash_attention(q, k, v, block_q=128, block_k=300)
    assert torch.equal(got.view(torch.uint8), ref.attention(q, k, v).view(torch.uint8))


@pytest.mark.cuda
def test_flash_decode_wide_path_replays_in_a_graph(cuda):
    """D 512 captured once and replayed three times on new inputs: each
    replay equals the plain version, so every (row, chunk, slice) merge
    counter is back at 0 after a launch."""
    gen = torch.Generator(device=cuda).manual_seed(512)
    B, H, KV, S, D = 4, 16, 4, 2048, 512
    q = torch.randn((B, H, 1, D), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=cuda).to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    pos = torch.tensor([2047, 1535, 1023, 511], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k_decode.flash_decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k_decode.flash_decode(q, k, v, pos)
    for _ in range(3):
        q.copy_(torch.randn(q.shape, generator=gen, device=cuda))
        v.copy_(torch.randn(v.shape, generator=gen, device=cuda))
        pos.copy_(torch.randint(0, S, (B,), generator=gen, device=cuda, dtype=torch.int32))
        graph.replay()
        expect = ref.decode_attention(q, k, v, pos).float()
        torch.testing.assert_close(out.float(), expect, rtol=0,
                                   atol=2e-2 * expect.abs().max().item())


def _moe_smoke(dtype="float32", **kw):
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = replace(get_config("kimi-k2-1t-a32b").smoke(), dtype=dtype, **kw)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "kimi-k2-1t-a32b"])
def test_graphed_engine_matches_the_cpu_and_counts_one_graph_a_bucket(cuda, arch):
    """The smoke config (fp32) through the engine on the card, each
    bucket's decode a CUDA graph, against the eager engine on the CPU:
    the same tokens; compile_counts() is 1 prefill shape and 1 decode
    graph a bucket, and K3 launched once a layer a decode call: the
    first tick's warm-up eagerly, the capture not at all, every replay
    counted by the engine."""
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    model = build_model(get_config(arch).smoke())
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n) for n in (3, 7, 12, 25, 5, 18)]
    buckets = (serve.BucketSpec(2, 16), serve.BucketSpec(2, 48))
    before = k_decode.flash_decode.launches
    res, eng = serve.generate(model, params, prompts, max_new_tokens=6, buckets=buckets,
                              device=cuda, return_engine=True)
    assert k_decode.flash_decode.launches - before == model.cfg.n_layers * eng.n_decode_calls
    assert [bs.graph_k3 for bs in eng.state] == [model.cfg.n_layers] * len(buckets)
    assert all(bs.graph is not None for bs in eng.state)
    assert eng.compile_counts() == {"b2xs16": {"prefill": 1, "decode": 1},
                                    "b2xs48": {"prefill": 1, "decode": 1}}
    cpu = serve.generate(model, params, prompts, max_new_tokens=6, buckets=buckets, device="cpu")
    assert [r.tokens for r in res] == [r.tokens for r in cpu]


@pytest.mark.cuda
def test_graph_replays_equal_an_eager_decode_loop(cuda):
    """kimi's smoke config in bf16 with an fp8 cache: one bucket's first 8
    ticks through the graph against an eager ``decode_step`` loop on the
    card from the same prefilled cache: the same tokens, bitwise (the
    same kernels on the same inputs)."""
    from repro_torch import serve
    from repro_torch.utils.tree import tree_map

    model, params = _moe_smoke("bfloat16", cache_dtype="float8_e4m3fn")
    eng = serve.make_engine(model, params, buckets=(serve.BucketSpec(4, 64),), device=cuda)
    snap = {}
    decode = eng._decode

    def spy(bs):
        if not snap:
            snap.update(cache=tree_map(torch.clone, bs.cache), tok=bs.last_tok.copy(),
                        pos=bs.pos.copy())
        out = decode(bs)
        snap.setdefault("ticks", []).append(out.copy())
        return out

    eng._decode = spy
    rng = np.random.default_rng(1)
    for rid, n in enumerate((5, 17, 30, 9)):
        eng.submit(serve.Request(rid=rid, prompt=rng.integers(0, model.cfg.vocab_size, n)
                                 .astype(np.int32), max_new_tokens=9))
    for _ in range(8):
        eng.step()
    cache = snap["cache"]
    tok = torch.as_tensor(snap["tok"], device=cuda)[:, None]
    pos = torch.as_tensor(snap["pos"], device=cuda)
    with torch.no_grad():
        for t in range(8):
            logits, cache = model.decode_step(eng.params, tok, cache, pos)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            assert np.array_equal(nxt.cpu().numpy(), snap["ticks"][t]), t
            tok, pos = nxt[:, None], pos + 1


# tests/test_kernels.py's FLASH_CASES (B, H, KV, S, D, causal, window, bq,
# bk) with q_offset 0, then q_offset / no-valid-key / ragged cases:
# (B, H, KV, Sq, Sk, D, causal, window, q_offset)
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, True, 0, 0),
    (2, 8, 2, 256, 256, 64, True, 0, 0),
    (1, 8, 1, 256, 256, 128, True, 0, 0),
    (2, 4, 4, 128, 128, 64, False, 0, 0),
    (1, 4, 2, 256, 256, 64, True, 64, 0),
    (1, 2, 2, 512, 512, 64, True, 128, 0),
    (1, 4, 2, 64, 64, 32, False, 16, 100),       # no row has a key
    (1, 2, 1, 64, 128, 32, True, 24, 140),       # some rows have none
    (2, 8, 2, 512, 2048, 64, True, 0, 1536),     # a prefill chunk at the cache's end
    (1, 4, 1, 100, 100, 64, True, 0, 0),         # ragged tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_kernel_matches_plain_on_the_card(cuda, case, dtype):
    """fp32 2e-5, bf16 2e-2: the reference's tolerances for its own
    kernel against its oracle."""
    B, H, KV, Sq, Sk, D, causal, window, off = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, Sq, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((B, KV, Sk, D), generator=gen, device=cuda).to(dt) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)
    got = k_attn.flash_attention(q, k, v, block_q=Sq, block_k=Sk, **kw)
    expect = ref.attention(q, k, v, **kw)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_reads_and_writes_strided_bsh(cuda, dtype):
    """(B,S,H,D) activations through flash_attention_bsh, and views with
    odd strides (16-byte loads off), against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    dt = getattr(torch, dtype)
    q = torch.randn((2, 192, 8, 64), generator=gen, device=cuda).to(dt)
    kv = torch.randn((2, 192, 2, 2, 64), generator=gen, device=cuda).to(dt)
    k, v = kv[:, :, :, 0], kv[:, :, :, 1]                 # strided, as a fused kv would be
    got = k_attn.flash_attention_bsh(q, k, v, causal=True, window=50, block_q=64, block_k=64)
    expect = ref.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           causal=True, window=50).transpose(1, 2)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol)
    odd = torch.randn((1, 4, 70, 65), generator=gen, device=cuda).to(dt)[..., 1:]
    kk = torch.randn((1, 2, 70, 65), generator=gen, device=cuda).to(dt)[..., 1:]
    got = k_attn.flash_attention(odd, kk, kk, block_q=70, block_k=70)
    torch.testing.assert_close(got.float(), ref.attention(odd, kk, kk).float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_ops_flash_attention_on_the_card_launches_the_kernel_only(cuda, monkeypatch):
    def plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((1, 4, 128, 64), generator=gen, device=cuda)
    k, v = (torch.randn((1, 2, 128, 64), generator=gen, device=cuda) for _ in range(2))
    expect = ref.attention(q, k, v)
    monkeypatch.setattr(ref, "attention", plain)
    before = k_attn.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    got_bsh = ops.flash_attention_bsh(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert k_attn.flash_attention.launches == before + 2
    torch.testing.assert_close(got, expect, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_bsh.transpose(1, 2), expect, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    """fp16, D 48, D 264 and an fp8 q (its bytes within the fp32
    tolerance) are taken and match the plain version; an fp64 q and a D
    of 0 are refused, and so is what the reference's shape rule
    refuses."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    kv = torch.randn((1, 2, 64, 64), generator=gen, device=cuda)
    x = torch.randn((1, 4, 64, 64), generator=gen, device=cuda)
    h = x.to(torch.float16), kv.to(torch.float16)
    torch.testing.assert_close(k_attn.flash_attention(h[0], h[1], h[1]).float(),
                               ref.attention(h[0], h[1], h[1]).float(), rtol=2e-2, atol=2e-2)
    for fp8 in (torch.float8_e4m3fn, torch.float8_e5m2):
        got = k_attn.flash_attention(x.to(fp8), kv.to(fp8), kv)
        assert got.dtype == fp8
        _assert_fp8_close(got, ref.attention(x.to(fp8).float(), kv.to(fp8), kv))
    with pytest.raises(TypeError, match="q must be of .*float64"):
        k_attn.flash_attention(x.double(), kv.double(), kv.double())
    q48, kv48 = x[..., :48].contiguous(), kv[..., :48].contiguous()
    torch.testing.assert_close(k_attn.flash_attention(q48, kv48, kv48),
                               ref.attention(q48, kv48, kv48), rtol=2e-5, atol=2e-5)
    q264, kv264 = torch.randn((1, 4, 64, 264), generator=gen, device=cuda), \
        torch.randn((1, 2, 64, 264), generator=gen, device=cuda)
    torch.testing.assert_close(k_attn.flash_attention(q264, kv264, kv264),
                               ref.attention(q264, kv264, kv264), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="D >= 1"):
        k_attn.flash_attention(x[..., :0], kv[..., :0], kv[..., :0])
    with pytest.raises(ValueError, match="must divide blocks"):
        k_attn.flash_attention(torch.zeros((1, 4, 96, 64), device=cuda), kv, kv, block_q=64)
    with pytest.raises(ValueError, match="H % KV"):
        k_attn.flash_attention(torch.zeros((1, 3, 64, 64), device=cuda), kv, kv)


# K4 over the widened contract: B, H, KV, Sq, Sk, D, q, k, v dtypes,
# causal, window, q_offset; the kernel each runs
ATTN_CONTRACT_CASES = [
    (4, 32, 8, 2048, 2048, 64, ("float16",) * 3, True, 0, 0, "mma"),
    (2, 8, 2, 512, 512, 96, ("bfloat16",) * 3, True, 0, 0, "mma"),
    (1, 4, 4, 300, 300, 80, ("float16",) * 3, False, 70, 0, "mma"),
    (2, 8, 2, 512, 512, 256, ("bfloat16",) * 3, True, 0, 0, "fma"),
    (1, 4, 1, 200, 200, 160, ("float16",) * 3, True, 50, 0, "fma"),
    (2, 8, 2, 512, 512, 64, ("bfloat16", "float16", "float16"), True, 0, 0, "fma"),
    (1, 4, 2, 256, 256, 64, ("float16", "float8_e4m3fn", "float8_e5m2"), True, 0, 0, "fma"),
    (2, 8, 2, 100, 612, 80, ("float32",) * 3, True, 0, 512, "fma"),
    (1, 2, 1, 64, 64, 7, ("float32", "bfloat16", "float32"), False, 0, 0, "fma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CONTRACT_CASES)
def test_flash_attention_takes_fp16_mixed_types_and_any_d(cuda, case):
    """fp16 on the tensor cores; mixed types, fp8 k / v and D above 128
    on the FMA kernel, each input converted as it is staged. An all-fp32
    call 2e-5; else 2e-2, bf16's tolerance, for fp16 too."""
    B, H, KV, Sq, Sk, D, dts, causal, window, off, kernel = case
    assert k_attn.kernel_for(*(getattr(torch, t) for t in dts), D=D) == kernel
    gen = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q = torch.randn((B, H, Sq, D), generator=gen, device=cuda).to(getattr(torch, dts[0]))
    k = torch.randn((B, KV, Sk, D), generator=gen, device=cuda).to(getattr(torch, dts[1]))
    v = torch.randn((B, KV, Sk, D), generator=gen, device=cuda).to(getattr(torch, dts[2]))
    kw = dict(causal=causal, window=window, q_offset=off)
    got = k_attn.flash_attention(q, k, v, block_q=Sq, block_k=Sk, **kw)
    expect = ref.attention(q, k, v, **kw)
    tol = 2e-5 if dts == ("float32",) * 3 else 2e-2
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol)


# K4's last two gaps closed: D above 256 (slices of the FMA kernel's
# output) and an fp8 q. B, H, KV, Sq, Sk, D, q, k, v dtypes, causal,
# window, q_offset
ATTN_WIDE_CASES = [
    (1, 8, 2, 1024, 1024, 320, ("bfloat16",) * 3, True, 0, 0),
    (1, 8, 2, 1024, 1024, 320, ("bfloat16",) * 3, True, 128, 0),
    (1, 4, 1, 512, 512, 512, ("bfloat16",) * 3, True, 0, 0),
    (1, 4, 4, 300, 300, 1000, ("float32",) * 3, False, 70, 0),
    (1, 4, 2, 100, 612, 257, ("float32", "float16", "bfloat16"), True, 0, 512),
    (2, 8, 2, 512, 512, 64, ("float8_e4m3fn", "float8_e4m3fn", "float8_e4m3fn"), True, 0, 0),
    (2, 8, 2, 512, 512, 64, ("float8_e5m2", "float8_e5m2", "bfloat16"), True, 100, 0),
    (1, 4, 2, 256, 256, 384, ("float8_e4m3fn", "bfloat16", "bfloat16"), True, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_WIDE_CASES)
def test_flash_attention_takes_any_d_and_an_fp8_q(cuda, case):
    """D 257 to 1,000 and an fp8 q on the FMA kernel, one launch a call,
    against the plain version: an all-fp32 call 2e-5, half types 2e-2,
    fp8 by :func:`_assert_fp8_close`."""
    B, H, KV, Sq, Sk, D, dts, causal, window, off = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + D)
    q = torch.randn((B, H, Sq, D), generator=gen, device=cuda).to(getattr(torch, dts[0]))
    k = torch.randn((B, KV, Sk, D), generator=gen, device=cuda).to(getattr(torch, dts[1]))
    v = torch.randn((B, KV, Sk, D), generator=gen, device=cuda).to(getattr(torch, dts[2]))
    kw = dict(causal=causal, window=window, q_offset=off)
    assert k_attn.kernel_for(q.dtype, k.dtype, v.dtype, D=D) == "fma"
    before = k_attn.flash_attention.launches
    got = k_attn.flash_attention(q, k, v, block_q=Sq, block_k=Sk, **kw)
    assert k_attn.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    expect = ref.attention(q.float(), k, v, **kw)
    if dts[0].startswith("float8"):
        _assert_fp8_close(got, expect)
    else:
        tol = 2e-5 if dts == ("float32",) * 3 else 2e-2
        torch.testing.assert_close(got.float(), expect, rtol=tol, atol=tol)

# the tensor-core kernel's tile edges (B, H, KV, Sq, Sk, D, causal,
# window, q_offset): D 32 and 128, Sq and Sk off the 64-row tile,
# windows that cross a tile edge, q_offset chunks, G = 1, 4 and 8
ATTN_BF16_CASES = [
    (2, 8, 2, 256, 256, 32, True, 0, 0),         # D 32, G 4
    (1, 4, 4, 512, 512, 128, True, 0, 0),        # D 128, G 1
    (2, 8, 1, 200, 200, 128, False, 0, 0),       # D 128, G 8, ragged
    (1, 4, 2, 100, 200, 64, True, 0, 100),       # Sq 100 against Sk 200
    (1, 4, 2, 100, 200, 64, False, 0, 0),
    (1, 8, 1, 256, 256, 64, True, 100, 0),       # window 100 crosses tile edges
    (1, 4, 4, 300, 300, 32, False, 70, 0),
    (2, 8, 2, 192, 1024, 64, True, 0, 832),      # a prefill chunk at the cache's end
    (1, 8, 1, 128, 512, 128, True, 200, 384),    # a chunk with a window
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_BF16_CASES)
def test_flash_attention_bf16_tile_edges(cuda, case):
    """bf16 2e-2, the reference's tolerance for its kernel against its
    oracle; one launch a call."""
    B, H, KV, Sq, Sk, D, causal, window, off = case
    gen = torch.Generator(device=cuda).manual_seed(Sq * 7 + Sk + D)
    q = torch.randn((B, H, Sq, D), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((B, KV, Sk, D), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=off)
    before = k_attn.flash_attention.launches
    got = k_attn.flash_attention(q, k, v, block_q=Sq, block_k=Sk, **kw)
    assert k_attn.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), ref.attention(q, k, v, **kw).float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_unaligned_strided_bsh_stages_with_plain_loads(cuda):
    """A (B,S,H,D) view whose base is 2 bytes past a 16-byte boundary and
    whose strides are odd: the wrapper passes vec = 0 and the
    tensor-core kernel stages its tiles with ordinary loads."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    bf16 = torch.bfloat16
    q = torch.randn((2, 130, 8, 65), generator=gen, device=cuda).to(bf16)[..., 1:]
    kv = torch.randn((2, 130, 2, 2, 65), generator=gen, device=cuda).to(bf16)[..., 1:]
    k, v = kv[:, :, :, 0], kv[:, :, :, 1]
    assert q.data_ptr() % 16 and not k_attn._aligned16(q.transpose(1, 2))
    got = k_attn.flash_attention_bsh(q, k, v, causal=True, window=90, block_q=130, block_k=130)
    expect = ref.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           causal=True, window=90).transpose(1, 2)
    torch.testing.assert_close(got.float(), expect.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_param_stats_over_bucket_stacks_of_split_rows(cuda):
    """K1 over each bucket stack of the bucketed layout (quarter Table I
    at 16 px, rows of 768-148,000 elements, the long ones split over
    CTAs): one launch a bucket, K1's tolerance against the plain
    version."""
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.data.dr import make_dr_swarm_data, scale_table

    clients = make_dr_swarm_data(image_size=16, seed=0, table=scale_table(4))
    data = engine.make_bucketed_swarm_data(get_config("squeezenet-dr"), clients, device=cuda)
    split = 0
    for tr in data.train:
        x = tr["images"].reshape(tr["images"].shape[0], -1)
        split += k_stats.slices(x.shape[1]) > 1
        before = k_stats.param_stats_leaves.launches
        m, v = k_stats.param_stats_batched(x)
        assert k_stats.param_stats_leaves.launches == before + 1
        rm, rv = ref.param_stats_batched(x)
        _assert_stats_close(torch.stack([m, v], 1), torch.stack([rm, rv], 1))
    assert split, "no bucket row split over CTAs"


@pytest.mark.cuda
def test_churn_round_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One churn grid round (dropout 0.4, stale decay 0.5) on the card
    and on the CPU from one state and one set of draws: presence,
    staleness, assignments and centers equal, params within 1e-4 (5% of
    one adam step at lr 2e-3; adam eps 1e-6), every absent client's
    params and optimizer state on the card bitwise as they were; 21 K2
    launches, all with k_active."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    clients = make_dr_swarm_data(image_size=16, seed=0, table=scale_table(4))
    model = build_model(get_config("squeezenet-dr"))
    cfg = engine.EngineConfig(model=model,
                              opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=1e-6)),
                              local_steps=2, batch_size=8, lr=2e-3, n_clusters=3, kmeans_iters=20)
    n = len(clients)
    cpu = torch.device("cpu")
    data = {d: engine.make_swarm_data(model.cfg, clients, device=d) for d in (cuda, cpu)}
    gen = torch.Generator().manual_seed(3)
    draws = engine.draw_round(gen, data[cpu].train_n, cfg)._replace(
        churn_u=engine.draw_churn(gen, n, cpu))
    s_card = engine.make_swarm_state(model, cfg.opt, clients, 0, device=cuda)
    s_card = s_card._replace(staleness=torch.arange(n, device=cuda, dtype=torch.int32) % 3)
    s_cpu = s_card._replace(params=tree_map(lambda t: t.cpu(), s_card.params),
                            opt_state=tree_map(lambda t: t.cpu(), s_card.opt_state),
                            generator=torch.Generator(), n_samples=s_card.n_samples.cpu(),
                            staleness=s_card.staleness.cpu(), churn_generator=None)
    rows = {d: engine.grid_point(cfg, n, dropout=0.4, stale_decay=0.5, device=d)
            for d in (cuda, cpu)}
    before = k_assign.kmeans_assign.k_active_launches
    new_card, m_card = engine.swarm_round(s_card, data[cuda], cfg, rows[cuda], draws=draws)
    assert k_assign.kmeans_assign.k_active_launches - before == cfg.kmeans_iters + 1
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data[cpu], cfg, rows[cpu], draws=draws)
    present = m_cpu.present
    assert 0 < int(present.sum()) < n
    assert torch.equal(m_card.present.cpu(), present)
    assert torch.equal(new_card.staleness.cpu(), new_cpu.staleness)
    assert torch.equal(m_card.assignments.cpu(), m_cpu.assignments)
    assert torch.equal(m_card.centers.cpu(), m_cpu.centers)
    for a, b in zip(tree_leaves(new_card.params), tree_leaves(new_cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    absent = ~m_card.present
    for new, old in ((new_card.params, s_card.params), (new_card.opt_state, s_card.opt_state)):
        for a, b in zip(tree_leaves(new), tree_leaves(old)):
            assert torch.equal(a[absent], b[absent])


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1, 2), (2, 2), (3, 2), (4, 2), (31, 2), (64, 2), (8, 3),
                                 (512, 3)])
def test_kmeans_assign_at_the_pod_shapes_matches_plain_on_the_card(cuda, N, K):
    """The two-tier coordinator's shapes at F = 56: pods of 1-4 and 64
    members against k_local = 2 centroids (fewer rows than a CTA's
    warps, and than a warp's lanes), summary rows against k = 3; rows
    that are copies of a centroid tie to the first copy."""
    gen = torch.Generator(device=cuda).manual_seed(100 + N)
    X = torch.randn((N, 56), generator=gen, device=cuda)
    C = torch.randn((K, 56), generator=gen, device=cuda)
    assert torch.equal(k_assign.kmeans_assign(X, C), ref.kmeans_assign(X, C))
    C = torch.cat([X[:1], X[:1], C[2:]]).contiguous()
    got = k_assign.kmeans_assign(X, C)
    assert torch.equal(got, ref.kmeans_assign(X, C)) and int(got[0]) == 0


def _summary_inputs(dev, N=256, F=56, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((N, F), generator=gen, device=dev),
            torch.rand((N,), generator=gen, device=dev),
            torch.rand((N,), generator=gen, device=dev) > 0.3)


@pytest.mark.cuda
def test_two_tier_coordinator_on_the_card_matches_the_cpu(cuda):
    """pod_summaries (4 pods of 64, k_local 2, masked by a presence
    vector) and the weighted global tier on the card against the CPU on
    the same inputs and seed rows: pc_of and g equal, summaries and the
    weighted centroids within 1e-5; K2
    launches P*(iters+1) for the pod tier and iters+1 for the global
    one."""
    from repro_torch.core import engine, kmeans
    from repro_torch.core.bso import draw_bso

    iters, kl, k = 10, 2, 3
    hier = engine.hier_params(256, 4, kl)
    feats, val, present = _summary_inputs(cuda)
    gen = torch.Generator().manual_seed(1)
    init = torch.stack([torch.randperm(64, generator=gen)[:kl] for _ in range(4)])

    def pods_on(dev):
        args = [t.to(dev) for t in (feats, val, torch.ones(256), present)]
        return engine.pod_summaries(*args, kl, iters, hier.pod_index(dev), init_idx=init)

    before = k_assign.kmeans_assign.launches
    card = pods_on(cuda)
    assert k_assign.kmeans_assign.launches - before == 4 * (iters + 1)
    cpu = pods_on(torch.device("cpu"))
    assert torch.equal(card[4].cpu(), cpu[4])
    # atol 1e-5: sums of up to 64 members, added on the card with atomics
    # in another order
    for a, b in zip(card[:4], cpu[:4]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    assert float(card[1].sum()) == float(present.sum())
    # the weighted global tier over the card's summaries, on both devices
    C, counts, valsums = card[0], card[1], card[3]
    g_init = torch.tensor([0, 3, 6])
    bso = draw_bso(k, C.shape[0], gen, torch.device("cpu"))
    before = k_assign.kmeans_assign.launches
    g_card = engine.global_tier(C, counts, valsums, k=k, kmeans_iters=iters, p1=0.9, p2=0.8,
                                init_idx=g_init, bso=bso)
    assert k_assign.kmeans_assign.launches - before == iters + 1
    g_cpu = engine.global_tier(C.cpu(), counts.cpu(), valsums.cpu(), k=k, kmeans_iters=iters,
                               p1=0.9, p2=0.8, init_idx=g_init, bso=bso)
    for a, b in zip(g_card, g_cpu):
        assert torch.equal(a.cpu(), b)
    Cw_card, _ = kmeans.kmeans(C, k, iters, init_idx=g_init, weights=counts)
    Cw_cpu, _ = kmeans.kmeans(C.cpu(), k, iters, init_idx=g_init, weights=counts.cpu())
    torch.testing.assert_close(Cw_card.cpu(), Cw_cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_hier_churn_round_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One two-tier churn round (14 clients in 4 pods, k_local 2,
    dropout 0.4, stale decay 0.5) on the card and on the CPU from one
    state and one set of draws: presence, staleness, assignments and
    centers equal, params within 1e-4 (adam eps 1e-6, as the churn
    round's), absent clients' params bitwise as they were; 1 K1 and
    5 x 21 K2 launches on the card."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import tree_leaves, tree_map

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    clients = make_dr_swarm_data(image_size=16, seed=0, table=scale_table(4))
    model = build_model(get_config("squeezenet-dr"))
    cfg = engine.EngineConfig(model=model,
                              opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=1e-6)),
                              local_steps=2, batch_size=8, lr=2e-3, n_clusters=3, kmeans_iters=20)
    n = len(clients)
    hier = engine.hier_params(n, 4, k_local=2)
    cpu = torch.device("cpu")
    data = {d: engine.make_swarm_data(model.cfg, clients, device=d) for d in (cuda, cpu)}
    gen = torch.Generator().manual_seed(3)
    draws = engine.draw_round(gen, data[cpu].train_n, cfg, hier)._replace(
        churn_u=engine.draw_churn(gen, n, cpu))
    s_card = engine.make_swarm_state(model, cfg.opt, clients, 0, device=cuda)
    s_card = s_card._replace(staleness=torch.arange(n, device=cuda, dtype=torch.int32) % 3)
    s_cpu = s_card._replace(params=tree_map(lambda t: t.cpu(), s_card.params),
                            opt_state=tree_map(lambda t: t.cpu(), s_card.opt_state),
                            generator=torch.Generator(), n_samples=s_card.n_samples.cpu(),
                            staleness=s_card.staleness.cpu(), churn_generator=None)
    churn = engine.churn_params(dropout=0.4, stale_decay=0.5)
    before = (k_stats.param_stats_leaves.launches, k_assign.kmeans_assign.launches)
    new_card, m_card = engine.swarm_round(s_card, data[cuda], cfg, draws=draws, churn=churn,
                                          hier=hier)
    assert (k_stats.param_stats_leaves.launches - before[0],
            k_assign.kmeans_assign.launches - before[1]) == (1, 5 * (cfg.kmeans_iters + 1))
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data[cpu], cfg, draws=draws, churn=churn,
                                        hier=hier)
    assert 0 < int(m_cpu.present.sum()) < n
    assert torch.equal(m_card.present.cpu(), m_cpu.present)
    assert torch.equal(new_card.staleness.cpu(), new_cpu.staleness)
    assert torch.equal(m_card.assignments.cpu(), m_cpu.assignments)
    assert torch.equal(m_card.centers.cpu(), m_cpu.centers)
    for a, b in zip(tree_leaves(new_card.params), tree_leaves(new_cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    absent = ~m_card.present
    for a, b in zip(tree_leaves(new_card.params), tree_leaves(s_card.params)):
        assert torch.equal(a[absent], b[absent])


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A decode step that syncs with the host cannot be captured: the
    engine raises and does not fall back to eager decode. Last in the
    file: a failed capture may leave the process's CUDA state unusable."""
    from repro_torch import serve

    model, params = _moe_smoke()
    eng = serve.make_engine(model, params, buckets=(serve.BucketSpec(2, 16),), device=cuda)
    real = eng._decode_step

    def syncing(bs, tok, pos):
        out = real(bs, tok, pos)
        out.cpu()
        return out

    monkeypatch.setattr(eng, "_decode_step", syncing)
    eng.submit(serve.Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=3))
    with pytest.raises(RuntimeError, match="captur"):
        eng.run_until_drained()


def _fleet_inputs(dev, n=14, image=16, steps=2, batch=8, spread=0.0):
    """A fresh squeezenet-dr swarm of ``n`` clients (CPU-seeded, so equal
    on every device) with a round's batch, val stack, decision and
    weights, on ``dev``; sgd, since adam's first steps from a fresh state
    are lr * sign(g), and a gradient whose sign differs between cuDNN and
    the CPU moves its weight by ~lr (PERF.md §6). ``spread``
    scales client i's params by ``1 + spread * i``, so that the clients'
    stats lie apart by more than the rounding of ``|x|^2 + |c|^2 - 2
    x.c``: at a fresh init they do not, and nearest-centroid ids at such
    ties follow the summation order (the kernel's warp sums against the
    CPU's matmul)."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core import engine
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.launch.fleet_driver import _sample_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import tree_map, tree_stack

    clients = make_dr_swarm_data(image_size=image, seed=0, table=scale_table(8)[:, :n])
    model = build_model(get_config("squeezenet-dr"))
    opt = make_optimizer(OptimizerConfig(name="sgd", lr=2e-2))
    gen = torch.Generator().manual_seed(0)
    scale = 1.0 + spread * torch.arange(n, dtype=torch.float32)
    sp = tree_map(lambda x: (x * scale.reshape((-1,) + (1,) * (x.dim() - 1))).to(dev),
                  tree_stack([model.init(gen) for _ in range(n)]))
    args = (sp, engine.init_opt_state(opt, sp),
            _sample_round_batch(model.cfg, clients, steps * batch, 0, 0, device=dev),
            engine.stack_eval_split(model.cfg, clients, "val", device=dev), 2e-3,
            torch.as_tensor(np.arange(n) % 3, dtype=torch.int32, device=dev),
            torch.as_tensor([float(c["n_train"]) for c in clients], device=dev))
    return model, opt, args


@pytest.mark.cuda
def test_fleet_round_on_the_card_launches_k1_once_and_matches_the_cpu(cuda):
    """A flat fleet round (stacked, with_eval) at the fleet's shapes
    (14 clients): one K1 launch for the upload, which matches its plain
    version over the round's params; the round's stats and params within
    1e-4 of the same round on the CPU; the host coordinator's k-means on
    the card's stats makes 21 K2 launches and the CPU's decision."""
    from repro_torch.core import engine
    from repro_torch.launch.fleet_driver import host_coordinator
    from repro_torch.utils.tree import tree_leaves

    model, opt, args = _fleet_inputs(cuda)
    step = engine.make_fleet_round(model, opt, 14, 2, with_eval=True)
    before = k_stats.param_stats_leaves.launches
    p, _, out = step(*args)
    torch.cuda.synchronize()
    assert k_stats.param_stats_leaves.launches - before == 1
    leaves = [x.contiguous() for x in tree_leaves(p)]
    torch.testing.assert_close(k_stats.param_stats_leaves(leaves), ref.param_stats_leaves(leaves),
                               rtol=1e-4, atol=1e-6)
    p_cpu, _, out_cpu = step(*_fleet_inputs(torch.device("cpu"))[2])
    torch.testing.assert_close(out.stats.cpu(), out_cpu.stats, rtol=0, atol=1e-4)
    for a, b in zip(tree_leaves(p), tree_leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    before = k_assign.kmeans_assign.launches
    dec = host_coordinator(out.stats, out.val_acc.cpu(), k=3, p1=0.9, p2=0.8, seed=0)
    assert k_assign.kmeans_assign.launches - before == 21
    dec_cpu = host_coordinator(out.stats.cpu(), out.val_acc.cpu(), k=3, p1=0.9, p2=0.8, seed=0)
    np.testing.assert_array_equal(dec[0], dec_cpu[0])


@pytest.mark.cuda
def test_fleet_two_tier_round_on_the_card_assigns_as_the_plain_version(cuda):
    """The stacked two-tier round (2 pods of 7, k_local 4) on the card:
    42 K2 launches (21 a pod), and each pod's a_local is the plain
    version's nearest-centroid ids of the round's own stats against the
    round's own centroids, with counts its member counts; the clients
    spread apart (see :func:`_fleet_inputs`)."""
    from repro_torch.core import engine
    from repro_torch.core.diststats import swarm_distribution_matrix

    model, opt, args = _fleet_inputs(cuda, spread=0.25)
    step = engine.make_fleet_round(model, opt, 14, 2, hier_k_local=4, hier_pods=2)
    sp, so, batch, val, lr, _, w = args
    seeds = torch.as_tensor(np.random.default_rng(3).random((2, 4)), device=cuda)
    before = k_assign.kmeans_assign.launches
    # round 0's singletons: an incoming plan that merged clients would
    # leave near-copies, whose ties follow the summation order
    singletons = torch.arange(14, dtype=torch.int32, device=cuda)
    p, _, out = step(sp, so, batch, val, lr, torch.zeros(8, dtype=torch.int32, device=cuda),
                     torch.tensor(False, device=cuda), singletons,
                     torch.zeros(14, dtype=torch.int32, device=cuda), seeds, w)
    torch.cuda.synchronize()
    assert k_assign.kmeans_assign.launches - before == 42
    stats = swarm_distribution_matrix(p).cpu()
    a_local, C = out.a_local.cpu(), out.centroids.cpu()
    for pod in range(2):
        rows = slice(7 * pod, 7 * (pod + 1))
        expect = ref.kmeans_assign(stats[rows], C[4 * pod:4 * (pod + 1)]) + 4 * pod
        assert torch.equal(a_local[rows], expect)
    counts = torch.bincount(a_local.long(), minlength=8).float()
    assert torch.equal(out.counts.cpu(), counts)


@pytest.mark.cuda
def test_fleet_nccl_mesh_runs_one_rank_on_the_card(cuda):
    """run_fleet over an NCCL world of one: K1 once and K2 21 times a
    round, the Eq. 2 census 1 + #leaves all-reduces a round."""
    import os

    from repro_torch.launch.fleet_driver import make_unit_fleet, run_fleet
    from repro_torch.utils.tree import tree_leaves

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    model, opt, mesh, clients = make_unit_fleet(8, device=cuda)
    try:
        assert mesh.backend == "nccl"
        k1, k2 = k_stats.param_stats_leaves.launches, k_assign.kmeans_assign.launches
        res = run_fleet(model, opt, mesh, clients, rounds=2, local_steps=2, batch_size=8)
        torch.cuda.synchronize()
        assert k_stats.param_stats_leaves.launches - k1 == 2
        assert k_assign.kmeans_assign.launches - k2 == 42
        n_leaves = len(tree_leaves(res.params))
        assert res.comm["eq2_collective_bytes"]["op_counts"]["all_reduce"] == 1 + n_leaves
    finally:
        mesh.close()
