"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is
false. This file imports neither JAX nor the JAX package, so it runs on
the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import kmeans_assign as k_assign  # noqa: E402
from repro_torch.kernels import param_stats as k_stats  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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
