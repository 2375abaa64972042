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
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import kmeans_assign as k_assign  # noqa: E402
from repro_torch.kernels import param_stats as k_stats  # noqa: E402

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


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x = torch.randn(4, 9)
    X, C = torch.randn(6, 5), torch.randn(2, 5)
    before = (k_stats.param_stats_batched.launches, k_assign.kmeans_assign.launches)
    m, v = ops.param_stats_batched(x)
    rm, rv = ref.param_stats_batched(x)
    assert torch.equal(m, rm) and torch.equal(v, rv)
    assert torch.equal(ops.kmeans_assign(X, C), ref.kmeans_assign(X, C))
    assert (k_stats.param_stats_batched.launches, k_assign.kmeans_assign.launches) == before


def test_other_devices_go_to_the_kernels_which_refuse_them():
    """No quiet fallback: a tensor that is not on the CPU reaches the
    kernel wrapper, which raises unless it is on a CUDA device."""
    with pytest.raises(ValueError, match="CUDA"):
        ops.param_stats_batched(torch.empty((2, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(torch.empty((2, 3), device="meta"), torch.empty((1, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        k_stats.param_stats_batched(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        k_assign.kmeans_assign(torch.zeros(2, 3), torch.zeros(1, 3))


@pytest.mark.parametrize("N,n,sms,expect", [(14, 9216, 132, 5), (14, 5, 132, 1),
                                            (1, 16_777_216, 132, 528), (14, 0, 132, 1),
                                            (60000, 10**6, 132, 1)])
def test_param_stats_slices_per_client(N, n, sms, expect):
    assert k_stats.n_slices(N, n, sms) == expect


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
