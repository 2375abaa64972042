"""The port's coordinator against the JAX reference: the §III.B
distribution matrix, k-means, the brain storm and Eq. 2."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import diststats as jds  # noqa: E402
from repro.core.kmeans import kmeans as jax_kmeans  # noqa: E402
from repro.core.kmeans import lloyd_step as jax_lloyd_step  # noqa: E402
from repro.core.bso import brain_storm_jax  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import diststats as tds  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.core.bso import BSODraws, brain_storm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import jax_bso_draws, jax_kmeans_init_idx, pin_torch_threads  # noqa: E402

pin_torch_threads()

N = 6


@pytest.fixture(scope="module")
def stacked():
    """Six clients' squeezenet-shaped trees (the reference's paths and
    shapes), each leaf with its own mean and spread so every column
    carries signal."""
    init = jax_build_model(jax_get_config("squeezenet-dr")).init
    shapes = jax.eval_shape(jax.vmap(init), jax.random.split(jax.random.PRNGKey(0), N))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: (rng.normal(size=s.shape) * rng.uniform(0.01, 0.3)
                                   + rng.normal() * 0.05).astype(np.float32), shapes)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_swarm_distribution_matrix_matches_reference(stacked, use_pallas):
    """Against the jnp path and the Pallas kernel (interpret). rtol 1e-5
    / atol 1e-6: per-tensor fp32 sums in another order (the reference
    kernel also shifts by its first block's mean)."""
    expect = np.asarray(jds.swarm_distribution_matrix(jax.tree.map(jnp.asarray, stacked),
                                                      use_pallas=use_pallas))
    got = tds.swarm_distribution_matrix(params_from_numpy(stacked), n_clients=N)
    assert got.shape == expect.shape == (N, 56)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)


def test_swarm_distribution_matrix_is_one_stats_call_on_the_sorted_leaves(stacked, monkeypatch):
    """One ops.param_stats_leaves call over the floating leaves in sorted
    path order (on the card: one launch); the columns are [mean,
    log1p(var)] per leaf, in that order, from the plain per-leaf stats."""
    calls = []

    def spy(leaves):
        calls.append(list(leaves))
        return ref.param_stats_leaves(leaves)

    monkeypatch.setattr(tds.ops, "param_stats_leaves", spy)
    tree = params_from_numpy(stacked)
    got = tds.swarm_distribution_matrix(tree)
    pairs = sorted(tree_paths_and_leaves(tree), key=lambda kv: kv[0])
    assert len(calls) == 1 and len(calls[0]) == len(pairs) == 28
    assert all(a is b for a, (_, b) in zip(calls[0], pairs))
    for t, (_, leaf) in enumerate(pairs):
        m, v = ref.param_stats_batched(leaf)
        assert torch.equal(got[:, 2 * t], m) and torch.equal(got[:, 2 * t + 1], torch.log1p(v))


def test_param_distribution_and_byte_counts_match_reference(stacked):
    one = jax.tree.map(lambda x: x[2], stacked)
    got = tds.param_distribution(params_from_numpy(one))
    expect = np.asarray(jds.param_distribution(jax.tree.map(jnp.asarray, one)))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)
    assert tds.upload_bytes(params_from_numpy(one)) == jds.upload_bytes(one) == 224
    assert tds.full_params_bytes(params_from_numpy(one)) == jds.full_params_bytes(one)


def test_swarm_distribution_matrix_checks_client_count(stacked):
    with pytest.raises(ValueError, match="client axis"):
        tds.swarm_distribution_matrix(params_from_numpy(stacked), n_clients=N + 1)


def _clustered_points(seed, n=14, f=56, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, f)) * 2.0
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, f)) * 0.7).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_kmeans_from_reference_seeds_matches_pallas_kmeans(seed):
    """The same k-means++ seeds (recovered from the reference's key),
    then 20 Lloyd steps: assignments equal; centroids rtol/atol 1e-5."""
    X = _clustered_points(seed)
    key = jax.random.PRNGKey(seed)
    jC, ja = jax_kmeans(key, jnp.asarray(X), 3, iters=20, use_pallas=True)
    idx = jax_kmeans_init_idx(key, X, 3)
    tC, ta = tkm.kmeans(torch.from_numpy(X), 3, 20, init_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-5, atol=1e-5)


def test_lloyd_reseeds_empty_clusters_to_distinct_far_points_in_stable_order():
    """Two empty clusters, and far-point distances that tie: the
    reseed order must follow the reference's stable argsort."""
    X = np.array([[0, 0], [0.1, 0], [5, 5], [-5, 5], [5, -5], [-5, -5], [0, 0.1]], np.float32)
    C = np.array([[0, 0], [100, 100], [-100, 100]], np.float32)
    expect = np.asarray(jax.jit(jax_lloyd_step, static_argnums=2)(X, C, 3))
    got = tkm.lloyd_step(torch.from_numpy(X), torch.from_numpy(C), 3)
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(got.numpy()[1:], X[[2, 3]])


def test_kmeans_pp_seeding_from_a_generator():
    X = torch.from_numpy(_clustered_points(9))
    gen = torch.Generator().manual_seed(0)
    C, a = tkm.kmeans(X, 3, 5, generator=gen)
    assert C.shape == (3, 56) and a.dtype == torch.int32
    assert sorted(set(a.tolist())) == [0, 1, 2]
    # all points equal: the ++ distances are all zero and seeding falls
    # back to uniform instead of failing
    C0 = tkm.kmeans_pp_init(torch.zeros((5, 4)), 3, generator=gen)
    assert torch.equal(C0, torch.zeros((3, 4)))


@pytest.mark.parametrize("u1,pick", [(0.0, 1), (0.05, 1), (0.0999, 1), (0.1001, 2),
                                     (0.5, 2), (0.9999, 2)])
def test_kmeans_pp_seeding_inverts_the_squared_distances(u1, pick):
    """Seed 0 is row floor(u0 * N); seed 1 inverts the cumulative squared
    distances [0, 1, 9]: row 1 for u1 < 0.1, row 2 above, never the
    seed itself."""
    X = torch.tensor([[0.0], [1.0], [3.0]])
    C = tkm.kmeans_pp_init(X, 2, u=torch.tensor([0.2, u1], dtype=torch.float64))
    assert C[:, 0].tolist() == [0.0, X[pick, 0].item()]


@pytest.mark.parametrize("seed", range(24))
def test_brain_storm_with_reference_draws_matches_reference(seed):
    """Random p1, p2 (so replacements and swaps both happen), the
    reference's draws from its key: every output equal."""
    rng = np.random.default_rng(seed)
    n, k = 14, 3
    a0 = rng.integers(0, k if seed % 4 else k - 1, size=n).astype(np.int32)  # some empty
    val = rng.uniform(size=n).astype(np.float32)
    p1, p2 = float(rng.uniform()), float(rng.uniform())
    key = jax.random.PRNGKey(seed)
    ja, jc, jr, js = jax.jit(brain_storm_jax, static_argnums=3)(key, a0, val, k, p1, p2)
    draws = BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(key, k, n)))
    ta, tc, tr, ts = brain_storm(torch.from_numpy(a0), torch.from_numpy(val), k, p1, p2,
                                 draws=draws)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (int(tr), int(ts)) == (int(jr), int(js))


def test_brain_storm_generator_draws_keep_the_invariants():
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        a0 = torch.randint(0, 3, (14,), generator=gen).int()
        val = torch.rand(14, generator=gen)
        a, c, _, _ = brain_storm(a0, val, 3, 0.3, 0.3, generator=gen)
        assert sorted(a.tolist()) == sorted(a0.tolist())
        for cl in range(3):
            if c[cl] >= 0:
                assert a[c[cl]] == cl


@pytest.mark.parametrize("k,assign", [(3, [0, 2, 2, 1, 0, 2]), (1, [0] * 6),
                                      (6, list(range(6)))])
def test_cluster_fedavg_matches_reference(stacked, k, assign):
    """Eq. 2 with |D_h| weights: rtol/atol 1e-6, fp32 weighted sums in
    another order."""
    n_samples = np.array([10, 3, 7, 1, 20, 5], np.float32)
    a = np.asarray(assign, np.int32)
    expect = jax.jit(jagg.cluster_fedavg, static_argnums=3)(
        jax.tree.map(jnp.asarray, stacked), a, n_samples, k)
    got = tagg.cluster_fedavg(params_from_numpy(stacked), torch.from_numpy(a),
                              torch.from_numpy(n_samples), k)
    for (p, x), (_, y) in zip(tree_paths_and_leaves(params_to_numpy(got)),
                              tree_paths_and_leaves(jax.tree.map(np.asarray, expect))):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=p)


def test_singleton_assignments_make_cluster_fedavg_the_identity(stacked):
    tp = params_from_numpy(stacked)
    out = tagg.cluster_fedavg(tp, tagg.singleton_assignments(N), torch.arange(1.0, N + 1), N)
    for (_, x), (_, y) in zip(tree_paths_and_leaves(out), tree_paths_and_leaves(tp)):
        assert torch.equal(x, y)


def test_fedavg_matches_reference(stacked):
    trees = [jax.tree.map(lambda x, i=i: x[i], stacked) for i in range(3)]
    w = [5.0, 1.0, 2.0]
    expect = jax.tree.map(np.asarray, jax.jit(jagg.fedavg)(trees, jnp.asarray(w)))
    got = params_to_numpy(tagg.fedavg([params_from_numpy(t) for t in trees], w))
    for (p, x), (_, y) in zip(tree_paths_and_leaves(got), tree_paths_and_leaves(expect)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=p)
