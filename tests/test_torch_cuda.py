"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is
false. This file imports neither JAX nor the JAX package, so it runs on
the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import flash_decode as k_decode  # noqa: E402
from repro_torch.kernels import kmeans_assign as k_assign  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import param_stats as k_stats  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,K", [(14, 56, 3), (1000, 260, 37), (129, 7, 1)])
def test_kmeans_assign_kernel_matches_plain_on_the_card(cuda, N, F, K):
    gen = torch.Generator(device=cuda).manual_seed(N)
    X = torch.randn((N, F), generator=gen, device=cuda)
    C = torch.randn((K, F), generator=gen, device=cuda)
    before = k_assign.kmeans_assign.launches
    assert torch.equal(k_assign.kmeans_assign(X, C), ref.kmeans_assign(X, C))
    assert k_assign.kmeans_assign.launches == before + 1


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
]


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
    """fp32 2e-5, bf16 and fp16 2e-2: the reference's tolerances for its
    own kernel against its oracle."""
    B, H, KV, S, D, pos, window, stored = case
    q, k, v = _decode_inputs(cuda, B, H, KV, S, D, getattr(torch, dtype), stored, seed=S + D)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda) if isinstance(pos, list) else pos
    got = k_decode.flash_decode(q, k, v, pos_t, window)
    expect = ref.decode_attention(q, k, v, pos_t, window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == q.dtype and got.shape == (B, H, 1, D)
    torch.testing.assert_close(got.float(), expect.float(), rtol=tol, atol=tol)


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
    q = torch.zeros((1, 4, 1, 48), device=cuda)
    kv = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        k_decode.flash_decode(q, kv, kv, 3)
    with pytest.raises(TypeError, match="one type"):
        k_decode.flash_decode(torch.zeros((1, 4, 1, 64), device=cuda),
                              torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16),
                              torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16), 3)


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
