"""The port's two-tier (pod) coordinator against the JAX reference on
the CPU.

The centre piece is one whole two-tier round (3 unequal pods, k_local 2)
from a bridged reference state, with and without churn, the reference's
randomness rebuilt from its key and injected as ``RoundDraws`` (batch
rows, per-pod and global k-means++ seed rows, brain-storm draws over the
summary rows, churn uniforms), against ``jit_swarm_round(hier=)``.
Beside it: the weighted k-means (unit weights bitwise, the duplication
oracle, zero-weight rows never seeding, against the reference's
``kmeans(weights=)``), ``pod_summaries`` and ``global_tier`` against the
reference's functions, the hier draws, and the anchors (one pod is the
flat round, dropout 0 is the churn-free hier round, the bucketed layout
is the rectangular one, the validation errors, hier near flat). Sizes
are tests/test_hier.py's and tests/test_churn.py's.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.diststats import swarm_distribution_matrix as jax_feats  # noqa: E402
from repro.core.kmeans import kmeans as jax_kmeans  # noqa: E402
from repro.core.kmeans import lloyd_step as jax_lloyd_step  # noqa: E402
from repro.data.dr import TABLE_I, make_dr_swarm_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import OptimizerConfig, get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.core.bso import BSODraws  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves  # noqa: E402
from torch_parity import (jax_bso_draws, jax_hier_draws, jax_hier_keys,  # noqa: E402
                          jax_kmeans_init_idx, jax_pod_summaries, pin_torch_threads)

pin_torch_threads()

N = 8
SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)
ARCH = "squeezenet-dr"
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 8
K = 3
KMEANS_ITERS = 10
K_LOCAL = 2
N_PODS = 3                       # pods of 2, 3 and 3 clients (linspace 0, 2, 5, 8)
# adam's eps in the whole-round parity tests: 1e-6, for the reason given
# at test_torch_engine.ROUND_ADAM_EPS
ROUND_ADAM_EPS = 1e-6
DROPOUT = 0.4
STALE_DECAY = 0.5
# the reference state's staleness before the round, so that stale decay
# weighs absent clients unequally
STALENESS0 = np.array([0, 1, 2, 0, 3, 0, 1, 0], np.int32)


def _statics(**kw):
    return {**dict(local_steps=LOCAL_STEPS, batch_size=BATCH, lr=LR, aggregation="bso",
                   n_clusters=K, p1=0.9, p2=0.8, kmeans_iters=KMEANS_ITERS), **kw}


def _port_cfg(eps=1e-8, **kw):
    model = build_model(get_config(ARCH))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR, eps=eps))
    return teng.EngineConfig(model=model, opt=opt, **_statics(**kw))


def _jax_cfg(eps=1e-8, **kw):
    model = jax_build_model(jax_get_config(ARCH))
    opt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=eps))
    return jeng.EngineConfig(model=model, opt=opt, **_statics(**kw))


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.fixture(scope="module")
def clients():
    return make_dr_swarm_data(image_size=16, seed=0, table=SMALL_TABLE[:, :N])


@pytest.fixture(scope="module")
def model():
    return build_model(get_config(ARCH))


@pytest.fixture(scope="module")
def port_data(clients, model):
    return teng.make_swarm_data(model.cfg, clients, device="cpu")


def _points(seed, n=12, f=6):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 3.0, size=(3, f))
    return (centres[rng.integers(0, 3, n)] + rng.normal(0.0, 0.5, size=(n, f))).astype(np.float32)


# ---------------------------------------------------- weighted k-means


def test_unit_weights_are_the_unweighted_kmeans_bitwise():
    """weights=ones is the unweighted run bitwise, with and without a
    mask (the first-seed remap is the identity, ``d * 1.0`` is exact, and
    the 1e-9 floor differs from 1.0 only on empty clusters, which the
    reseed overwrites; mirror of tests/test_hier.py)."""
    X = torch.from_numpy(np.random.default_rng(7).normal(size=(40, 6)).astype(np.float32))
    ones = torch.ones(40)
    mask = torch.arange(40) % 4 != 1
    for seed in range(3):
        u = torch.rand((4,), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
        C0, a0 = tkm.kmeans(X, 4, 8, u=u)
        C1, a1 = tkm.kmeans(X, 4, 8, u=u, weights=ones)
        assert torch.equal(C0, C1) and torch.equal(a0, a1)
        C2, a2 = tkm.kmeans(X, 4, 8, u=u, mask=mask)
        C3, a3 = tkm.kmeans(X, 4, 8, u=u, mask=mask, weights=ones)
        assert torch.equal(C2, C3) and torch.equal(a2, a3)


def test_weighted_lloyd_step_matches_duplication_oracle():
    """Integer weights are duplicated rows: one weighted Lloyd step from
    a fixed centroid set gives the duplicated run's centroids within
    1e-5 relative, 1e-6 absolute (mirror of tests/test_hier.py)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(12, 5)).astype(np.float32)
    w = rng.integers(1, 4, size=12).astype(np.float32)
    C = torch.from_numpy(X[:3] + 0.01)
    got = tkm.lloyd_step(torch.from_numpy(X), C, 3, weights=torch.from_numpy(w))
    dup = tkm.lloyd_step(torch.from_numpy(np.repeat(X, w.astype(np.int64), axis=0)), C, 3)
    np.testing.assert_allclose(got.numpy(), dup.numpy(), rtol=1e-5, atol=1e-6)


def test_zero_weight_rows_never_seed():
    """Zero-weight rows (empty pod-clusters) seed nothing, even as far
    outliers that the unweighted ++ seeding would surely pick; the
    first seed is the floor(u * n_pos)-th positive-weight row (mirror of
    tests/test_hier.py)."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(20, 4)).astype(np.float32)
    X[10:] += 1000.0
    Xt = torch.from_numpy(X)
    w = torch.tensor([1.0] * 10 + [0.0] * 10)
    for s in range(5):
        u = torch.rand((4,), generator=torch.Generator().manual_seed(s), dtype=torch.float64)
        C0 = tkm.kmeans_pp_init(Xt, 4, u=u, weights=w).numpy()
        for row in C0:
            assert np.abs(X[:10] - row[None, :]).sum(axis=1).min() < 1e-6, (s, row)
        assert np.array_equal(C0[0], X[int(u[0] * 10)])


WEIGHT_CASES = {
    "counts": (np.array([3, 1, 2, 4, 1, 1, 2, 3, 1, 2, 5, 1], np.float32), None),
    "zeros": (np.array([2, 0, 1, 3, 0, 1, 2, 0, 4, 1, 1, 2], np.float32), None),
    "fractional": (np.array([.5, .25, 1.5, 2., .1, 0., .75, 1., 3., .2, .6, .9], np.float32),
                   None),
    "mask": (np.array([2, 0, 1, 3, 1, 1, 2, 1, 4, 1, 1, 2], np.float32),
             np.array([1, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1], bool)),
}


@pytest.mark.parametrize("case", list(WEIGHT_CASES))
def test_weighted_kmeans_matches_reference_on_its_seed_rows(case):
    """The port's weighted k-means seeded with the reference's weighted
    k-means++ rows: assignments equal, centroids within 1e-5 (fp32
    weighted means summed in another order); one weighted Lloyd step
    from the same centroids within 1e-6."""
    w, mask = WEIGHT_CASES[case]
    X = _points(20 + len(case))
    key = jax.random.PRNGKey(5)
    C_ref, a_ref = jax_kmeans(key, jnp.asarray(X), K, iters=KMEANS_ITERS, weights=jnp.asarray(w),
                              mask=None if mask is None else jnp.asarray(mask))
    init = jax_kmeans_init_idx(key, X, K, mask=mask, weights=w)
    tmask = None if mask is None else torch.from_numpy(mask)
    C, a = tkm.kmeans(torch.from_numpy(X), K, KMEANS_ITERS, init_idx=torch.from_numpy(init),
                      weights=torch.from_numpy(w), mask=tmask)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(C.numpy(), np.asarray(C_ref), rtol=0, atol=1e-5)
    C1 = X[init] + 0.01
    step = tkm.lloyd_step(torch.from_numpy(X), torch.from_numpy(C1), K, mask=tmask,
                          weights=torch.from_numpy(w)).numpy()
    expect = np.asarray(jax_lloyd_step(jnp.asarray(X), jnp.asarray(C1), K, weights=jnp.asarray(w),
                                       mask=None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(step, expect, rtol=0, atol=1e-6)


# ---------------------------------------------- the two tiers, alone

PODS = {"contiguous": jeng.hier_params(20, 4, K_LOCAL).pods,
        "explicit": ((0, 5, 9, 13, 17), (1, 2, 3), (4, 6, 7, 8, 10, 11), (12, 14, 15, 16, 18, 19))}
PRESENT = {"all": None,
           "churn": np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1, 1, 1], bool)}


def _summary_inputs(seed):
    rng = np.random.default_rng(seed)
    feats = np.concatenate([_points(seed, n=10, f=8), _points(seed + 1, n=10, f=8)])
    return feats, rng.random(20).astype(np.float32), rng.integers(5, 60, 20).astype(np.float32)


@pytest.mark.parametrize("present_case", list(PRESENT))
@pytest.mark.parametrize("pods_case", list(PODS))
def test_pod_summaries_match_reference(pods_case, present_case):
    """pod_summaries on the reference's per-pod seed rows: pc_of equal,
    centroids, counts, weight sums and val sums within 1e-5; counts sum
    to the present clients."""
    pods, present = PODS[pods_case], PRESENT[present_case]
    feats, val, w = _summary_inputs(3)
    k_pods = jax.random.split(jax.random.PRNGKey(9))[0]
    jp = None if present is None else jnp.asarray(present)
    expect = jax_pod_summaries(jnp.asarray(feats), jnp.asarray(val), jnp.asarray(w), jp, K_LOCAL,
                                KMEANS_ITERS, k_pods, pods)
    pod_keys, _ = jax_hier_keys(jax.random.PRNGKey(9), len(pods))
    init = np.stack([jax_kmeans_init_idx(pod_keys[p], feats[list(ids)], K_LOCAL,
                                         mask=None if present is None else present[list(ids)])
                     for p, ids in enumerate(pods)])
    hier = teng.hier_params(20, 0, K_LOCAL, pods=pods)
    got = teng.pod_summaries(torch.from_numpy(feats), torch.from_numpy(val), torch.from_numpy(w),
                             None if present is None else torch.from_numpy(present), K_LOCAL,
                             KMEANS_ITERS, hier.pod_index("cpu"), init_idx=torch.from_numpy(init))
    names = ("centroids", "counts", "wsums", "valsums")
    for name, g, e in zip(names, got[:4], expect[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(expect[4]))
    assert got[4].dtype == torch.int32
    assert float(got[1].sum()) == (20 if present is None else present.sum())


@functools.lru_cache(maxsize=None)
def _global_inputs(kind):
    """Summary rows for the global tier: the reference's pod summaries
    of a churn case, or hand-made rows with empty pod-clusters (count 0,
    one of them a copy of an occupied row and one a far outlier)."""
    if kind == "pods":
        feats, val, w = _summary_inputs(4)
        C, counts, _, valsums, _ = jax_pod_summaries(
            jnp.asarray(feats), jnp.asarray(val), jnp.asarray(w), jnp.asarray(PRESENT["churn"]),
            K_LOCAL, KMEANS_ITERS, jax.random.PRNGKey(2), PODS["explicit"])
        return np.asarray(C), np.asarray(counts), np.asarray(valsums)
    rng = np.random.default_rng(6)
    C = _points(6, n=10, f=8)
    counts = np.array([3, 0, 2, 5, 1, 0, 4, 2, 0, 1], np.float32)
    C[1] = C[0]
    C[5] += 500.0
    return C, counts, (rng.random(10) * counts).astype(np.float32)


@pytest.mark.parametrize("p12", [(0.9, 0.8), (0.3, 0.2)])
@pytest.mark.parametrize("kind", ["pods", "empty-rows"])
def test_global_tier_matches_reference(kind, p12):
    """global_tier on the reference's weighted seed rows and brain-storm
    draws over the summary rows: the pod-cluster map g, the center rows
    and the event counts equal (p1/p2 low enough to replace and swap in
    the second case); no empty row is a center."""
    C, counts, valsums = _global_inputs(kind)
    k_global, k_bso = jax.random.split(jax.random.PRNGKey(12))
    p1, p2 = p12
    g_ref, c_ref, rep_ref, swap_ref = jeng.global_tier(
        k_global, k_bso, jnp.asarray(C), jnp.asarray(counts), jnp.asarray(valsums), k=K,
        kmeans_iters=KMEANS_ITERS, p1=p1, p2=p2)
    init = jax_kmeans_init_idx(k_global, C, K, weights=counts)
    bso = BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(k_bso, K, C.shape[0])))
    g, c, n_rep, n_swap = teng.global_tier(
        torch.from_numpy(C), torch.from_numpy(counts), torch.from_numpy(valsums), k=K,
        kmeans_iters=KMEANS_ITERS, p1=p1, p2=p2, init_idx=torch.from_numpy(init), bso=bso)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    assert (int(n_rep), int(n_swap)) == (int(rep_ref), int(swap_ref))
    assert all(counts[i] > 0 for i in c.numpy() if i >= 0), "an empty pod-cluster is a center"


# ------------------------------------------------------- the draws


def test_hier_draws_follow_the_flat_rows_in_one_order(port_data):
    """A multi-pod round draws the flat round's batch and pool rows, then
    the (P, k_local) float64 pod uniforms, the (k,) global uniforms and
    the brain storm's draws over the P * k_local summary rows, in that
    order; a one-pod hier round draws exactly as the flat round."""
    cfg = _port_cfg()
    hier = teng.hier_params(N, N_PODS, K_LOCAL)
    flat = teng.draw_round(torch.Generator().manual_seed(4), port_data.train_n, cfg)
    one = teng.draw_round(torch.Generator().manual_seed(4), port_data.train_n, cfg,
                          teng.hier_params(N, 1))
    for f, a, b in zip(teng.RoundDraws._fields, flat, one):
        if f == "bso":
            assert all(torch.equal(x, y) for x, y in zip(a, b)), f
        else:
            assert (a is None and b is None) or torch.equal(a, b), f
    gen = torch.Generator().manual_seed(4)
    d = teng.draw_round(gen, port_data.train_n, cfg, hier)
    assert torch.equal(d.batch_idx, flat.batch_idx) and torch.equal(d.pool_idx, flat.pool_idx)
    assert d.pod_kmeans_u.shape == (N_PODS, K_LOCAL) and d.pod_kmeans_u.dtype == torch.float64
    assert d.kmeans_u.shape == (K,) and d.bso.g.shape == (K, N_PODS * K_LOCAL)
    # the batch and pool rows' uniforms, then the hier draws by hand
    replay = torch.Generator().manual_seed(4)
    for _ in range(2 * LOCAL_STEPS):
        torch.rand((N, BATCH), generator=replay, dtype=torch.float64)
    assert torch.equal(d.pod_kmeans_u, torch.rand((N_PODS, K_LOCAL), generator=replay,
                                                  dtype=torch.float64))
    assert torch.equal(d.kmeans_u, torch.rand((K,), generator=replay, dtype=torch.float64))
    assert torch.equal(d.bso.r1, torch.rand((K,), generator=replay))
    assert d.pod_kmeans_init_idx is None


def test_pod_index_is_built_once_per_device():
    """The pods' member-id tensors are made once per device and handed
    back as they are; HierParams still compares and hashes by value."""
    hier = teng.hier_params(N, N_PODS, K_LOCAL)
    idx = hier.pod_index("cpu")
    assert hier.pod_index(torch.device("cpu")) is idx
    assert [t.tolist() for t in idx] == [list(p) for p in hier.pods]
    assert all(t.dtype == torch.int64 for t in idx)
    assert hier == teng.hier_params(N, N_PODS, K_LOCAL)
    assert hash(hier) == hash(teng.hier_params(N, N_PODS, K_LOCAL))


# ------------------------------------- a whole round vs the reference


@pytest.fixture(scope="module")
def jax_state0(clients):
    """The reference's fresh state from key 0 (adam eps 1e-6), its
    staleness set to STALENESS0, as numpy arrays."""
    jcfg = _jax_cfg(eps=ROUND_ADAM_EPS)
    state = jax.jit(lambda k: jeng.make_swarm_state(jcfg.model, jcfg.opt, clients, k))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state._replace(staleness=jnp.asarray(STALENESS0)))


ROUND_CASES = ["plain", "churn"]


@pytest.fixture(scope="module")
def reference_hier_rounds(clients, jax_state0):
    """For each case, the reference's two-tier round
    (``jit_swarm_round(hier=)``) and that round's draws rebuilt from the
    key as swarm_round and the two-tier coordinator derive them: the
    churn uniforms, the batch rows, each pod's and the global tier's
    k-means++ seed rows, and the brain-storm draws over the summary
    rows."""
    jcfg = _jax_cfg(eps=ROUND_ADAM_EPS)
    jdata = jeng.make_swarm_data(jcfg.model.cfg, clients)
    hier = jeng.hier_params(N, N_PODS, K_LOCAL)
    _, k_local, k_kmeans, k_bso = jax.random.split(jnp.asarray(jax_state0.key), 4)
    u = np.array(jax.random.uniform(jax.random.fold_in(k_local, jeng._CHURN_KEY_TAG), (N,)))
    sample_keys = jax.random.split(k_local, LOCAL_STEPS)
    own = np.stack([np.array(jax.random.randint(kt, (N, BATCH), 0, jdata.train_n[:, None]))
                    for kt in sample_keys])
    step = jax_make_train_step(jcfg.model, jcfg.opt)

    @jax.jit
    def feats_of(s, present):
        params = jeng.local_phase(step, s.params, s.opt_state, LR, sample_keys,
                                  lambda kt: jeng.sample_round_batch(kt, jdata, BATCH),
                                  present=present)[0]
        return jax_feats(params)

    out = {}
    for case in ROUND_CASES:
        churn = (None if case == "plain"
                 else jeng.churn_params(dropout=DROPOUT, stale_decay=STALE_DECAY))
        present = None if churn is None else u >= np.float32(DROPOUT)
        # jit_swarm_round donates its state: each call takes a fresh copy
        jnew, jm = jeng.jit_swarm_round(jax.tree.map(jnp.asarray, jax_state0), jdata, jcfg,
                                        None, churn, hier)
        feats = feats_of(jax.tree.map(jnp.asarray, jax_state0),
                         None if present is None else jnp.asarray(present))
        pod_idx, g_idx, bso = jax_hier_draws(k_kmeans, k_bso, feats, present, hier.pods,
                                             K_LOCAL, K, KMEANS_ITERS)
        draws = teng.RoundDraws(
            batch_idx=torch.from_numpy(own), kmeans_init_idx=torch.from_numpy(g_idx),
            bso=BSODraws(*(torch.from_numpy(t) for t in bso)),
            churn_u=torch.from_numpy(u), pod_kmeans_init_idx=torch.from_numpy(pod_idx))
        out[case] = (churn, draws, jax.tree.map(np.asarray, jnew._asdict()),
                     jax.tree.map(np.asarray, jm))
    return out


@pytest.mark.parametrize("case", ROUND_CASES)
def test_hier_round_matches_reference(case, jax_state0, port_data, reference_hier_rounds):
    """One two-tier round from the reference's state on its draws:
    presence, staleness, assignments, centers and event counts equal;
    params within atol 1e-4 (5% of one adam step at lr 2e-3, as in
    test_torch_engine), val accuracy within 1e-6, the loss within rtol
    1e-4; under churn some clients absent and their params and optimizer
    state bitwise as they were."""
    churn, draws, jnew, jm = reference_hier_rounds[case]
    tstate = bridge.state_from_numpy(jax_state0._asdict(), "cpu")
    cfg = _port_cfg(eps=ROUND_ADAM_EPS)
    tchurn = None if churn is None else teng.churn_params(DROPOUT, STALE_DECAY)
    tnew, tm = teng.swarm_round(tstate, port_data, cfg, draws=draws, churn=tchurn,
                                hier=teng.hier_params(N, N_PODS, K_LOCAL))
    np.testing.assert_array_equal(tm.present.numpy(), jm.present)
    if churn is not None:
        assert 0 < jm.present.sum() < N, "the case must drop some clients and keep some"
    np.testing.assert_array_equal(tnew.staleness.numpy(), jnew["staleness"])
    np.testing.assert_array_equal(tm.assignments.numpy(), jm.assignments)
    np.testing.assert_array_equal(tm.centers.numpy(), jm.centers)
    assert (int(tm.n_replaced), int(tm.n_swapped)) == (int(jm.n_replaced), int(jm.n_swapped))
    np.testing.assert_allclose(tm.val_acc.numpy(), jm.val_acc, atol=1e-6)
    np.testing.assert_allclose(float(tm.train_loss), float(jm.train_loss), rtol=1e-4)
    for (path, a), (_, b) in zip(tree_paths_and_leaves(bridge.params_to_numpy(tnew.params)),
                                 tree_paths_and_leaves(jnew["params"])):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=path)
    for new, old in zip(tree_leaves(tnew.params), tree_leaves(tstate.params)):
        assert torch.equal(new[~tm.present], old[~tm.present])


# ------------------------------------------------------------ anchors


def test_hier_pods1_bitwise_equals_flat(clients, model, port_data):
    """One pod is the flat round over 2 rounds: params, optimizer state,
    every metric and the generator's position, bitwise (mirror of
    tests/test_hier.py, in the port alone)."""
    cfg = _port_cfg(kmeans_iters=5)
    s0 = teng.make_swarm_state(model, cfg.opt, clients, 2, device="cpu")
    sf, mf = teng.run_rounds(teng.copy_state(s0), port_data, cfg, 2)
    sp, mp = teng.run_rounds(teng.copy_state(s0), port_data, cfg, 2, hier=teng.hier_params(N, 1))
    assert _equal_trees(sf.params, sp.params) and _equal_trees(sf.opt_state, sp.opt_state)
    for f, x, y in zip(teng.RoundMetrics._fields, mf, mp):
        assert torch.equal(x, y), f
    assert torch.equal(sf.generator.get_state(), sp.generator.get_state())


def test_hier_churn_dropout0_bitwise_equals_hier(clients, model, port_data):
    """Dropout-0 churn on the two-tier round is the churn-free two-tier
    round bitwise over 2 rounds: params, optimizer state and every
    metric, all present (mirror of tests/test_hier.py)."""
    cfg = _port_cfg(kmeans_iters=5)
    hier = teng.hier_params(N, N_PODS, K_LOCAL)
    s0 = teng.make_swarm_state(model, cfg.opt, clients, 3, device="cpu")
    sa, ma = teng.run_rounds(teng.copy_state(s0), port_data, cfg, 2, hier=hier)
    sb, mb = teng.run_rounds(teng.copy_state(s0), port_data, cfg, 2, hier=hier,
                             churn=teng.churn_params(dropout=0.0))
    assert _equal_trees(sa.params, sb.params) and _equal_trees(sa.opt_state, sb.opt_state)
    for f, x, y in zip(teng.RoundMetrics._fields, ma, mb):
        assert torch.equal(x, y), f
    assert mb.present.all() and not sb.staleness.any()


def test_hier_round_on_bucketed_layout_equals_rectangular(clients, model, port_data):
    """The coordinator does not read the layout: 2 two-tier churn rounds
    on the bucketed layout are the rectangular ones bitwise on the CPU."""
    cfg = _port_cfg(kmeans_iters=5)
    hier = teng.hier_params(N, N_PODS, K_LOCAL)
    bucketed = teng.make_bucketed_swarm_data(model.cfg, clients, device="cpu")
    assert bucketed.n_buckets > 1
    s0 = teng.make_swarm_state(model, cfg.opt, clients, 4, device="cpu")
    churn = teng.churn_params(dropout=0.3, stale_decay=0.5)
    sa, ma = teng.run_rounds(teng.copy_state(s0), port_data, cfg, 2, hier=hier, churn=churn)
    sb, mb = teng.run_rounds(teng.copy_state(s0), bucketed, cfg, 2, hier=hier, churn=churn)
    assert _equal_trees(sa.params, sb.params)
    for f, x, y in zip(teng.RoundMetrics._fields, ma, mb):
        assert torch.equal(x, y), f


def test_hier_validation_errors(clients, model, port_data):
    """The seams refuse as the reference's do (tests/test_hier.py): hier
    with a method row, a non-bso aggregation, pods that do not partition
    N or do not cover the swarm, an oversize k_local, and a global k
    above the summary rows; hier_params' messages are the reference's;
    a two-tier round without pod draws is refused."""
    cfg = _port_cfg(kmeans_iters=2)
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    hier = teng.hier_params(N, N_PODS, K_LOCAL)
    with pytest.raises(ValueError, match="plain path only"):
        teng.run_rounds(state, port_data, cfg, 1, teng.method_params("fedavg", N), hier=hier)
    with pytest.raises(ValueError, match="plain path only"):
        teng.run_rounds(state, port_data, cfg, 1, teng.grid_point(cfg, N), hier=hier)
    with pytest.raises(ValueError, match="aggregation='bso'"):
        teng.run_rounds(state, port_data, _port_cfg(aggregation="fedavg"), 1, hier=hier)
    with pytest.raises(ValueError, match="swarm has"):
        teng.run_rounds(state, port_data, cfg, 1, hier=teng.hier_params(N - 2, 3))
    with pytest.raises(ValueError, match="summary rows"):
        teng.run_rounds(state, port_data, _port_cfg(n_clusters=4), 1,
                        hier=teng.hier_params(N, 2, k_local=1))
    for args, kw in (((N, 0), dict(pods=((0, 1), (1, 2)))), ((N, 7), dict(k_local=3)),
                     ((N, 0), {}), ((N, 9), {}), ((N, 4), dict(k_local=0))):
        with pytest.raises(ValueError) as expect:
            jeng.hier_params(*args, **kw)
        with pytest.raises(ValueError) as got:
            teng.hier_params(*args, **kw)
        assert str(got.value) == str(expect.value), (args, kw)
    draws = teng.draw_round(torch.Generator().manual_seed(0), port_data.train_n, cfg)
    with pytest.raises(ValueError, match="pod_kmeans"):
        teng.swarm_round(state, port_data, cfg, draws=draws, hier=hier)


def test_hier_params_are_the_references():
    """hier_params' pods and k_local equal the reference's, contiguous
    at linspace bounds (14 clients in 4 pods: 3, 4, 3, 4) and
    explicit."""
    for args, kw in (((14, 4), dict(k_local=2)), ((8, 3), {}), ((5, 1), {}),
                     ((6, 0), dict(pods=((5, 0), (1, 2, 3, 4)), k_local=2))):
        ref, got = jeng.hier_params(*args, **kw), teng.hier_params(*args, **kw)
        assert (got.pods, got.k_local, got.n_pods) == (ref.pods, ref.k_local, ref.n_pods)
    assert [len(p) for p in teng.hier_params(14, 4).pods] == [3, 4, 3, 4]


def test_hier_fit_learns_near_flat(model):
    """A 4-pod fit of 3 rounds stays near the flat fit from the same
    seed: final mean val accuracy within 0.25 (the band of
    tests/test_hier.py's test_hier_fit_is_one_program_and_learns, at its
    14 clients, 4 local steps and 10 k-means iterations; its program
    count has no eager counterpart)."""
    clients14 = make_dr_swarm_data(image_size=16, seed=0, table=SMALL_TABLE[:, :14])
    data = teng.make_swarm_data(model.cfg, clients14, device="cpu")
    cfg = _port_cfg(local_steps=4)
    s0 = teng.make_swarm_state(model, cfg.opt, clients14, 0, device="cpu")
    _, m_hier = teng.run_rounds(teng.copy_state(s0), data, cfg, 3,
                                hier=teng.hier_params(14, 4, k_local=K_LOCAL))
    _, m_flat = teng.run_rounds(teng.copy_state(s0), data, cfg, 3)
    hier_acc, flat_acc = float(m_hier.mean_val_acc[-1]), float(m_flat.mean_val_acc[-1])
    assert 0.0 <= hier_acc <= 1.0
    assert abs(hier_acc - flat_acc) < 0.25, (hier_acc, flat_acc)
    assert m_hier.assignments.shape == (3, 14) and int(m_hier.assignments.max()) < K
