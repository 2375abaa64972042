"""The port's churn axis against the JAX reference on the CPU.

The centre piece is one whole churn round (dropout 0.4) from a bridged
reference state with staleness already carried, the reference's
randomness rebuilt from its key and injected as ``RoundDraws`` (the
Bernoulli uniforms, batch rows, masked k-means++ seeds and brain-storm
draws), against ``jit_swarm_round`` with the reference's own churn row:
on the plain path at stale decay 0 and 0.5, and as a grid row. Beside
it: the rows and their validation, the masked k-means, the masked Eq. 2,
the masked local phase, the semantics of a round (one client present,
staleness under a schedule), the ``dropout=0`` anchor, the churn
stream's independence from the round's generator, and the churn grid
through ``run_grid_table``. Sizes are tests/test_churn.py's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.aggregation import cluster_fedavg_masked as jax_cluster_fedavg_masked  # noqa: E402
from repro.core.diststats import swarm_distribution_matrix as jax_feats  # noqa: E402
from repro.core.kmeans import kmeans as jax_kmeans  # noqa: E402
from repro.core.kmeans import lloyd_step as jax_lloyd_step  # noqa: E402
from repro.data.dr import TABLE_I, make_dr_swarm_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.core.aggregation import cluster_fedavg, cluster_fedavg_masked  # noqa: E402
from repro_torch.core.bso import BSODraws  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths_and_leaves  # noqa: E402
from torch_parity import jax_bso_draws, jax_kmeans_init_idx, pin_torch_threads  # noqa: E402

pin_torch_threads()

N = 8
SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)[:, :N]
ARCH = "squeezenet-dr"
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 8
KMEANS_ITERS = 10
# adam's eps in the whole-round parity test: 1e-6, for the reason given
# at test_torch_engine.ROUND_ADAM_EPS
ROUND_ADAM_EPS = 1e-6
DROPOUT = 0.4
# the reference state's staleness before the round, so that stale decay
# weighs absent clients unequally
STALENESS0 = np.array([0, 1, 2, 0, 3, 0, 1, 0], np.int32)
OPT = OptimizerConfig(name="adam", lr=LR)


def _statics():
    return dict(local_steps=LOCAL_STEPS, batch_size=BATCH, lr=LR, aggregation="bso",
                n_clusters=3, p1=0.9, p2=0.8, kmeans_iters=KMEANS_ITERS)


def _port_cfg(eps=1e-8, **kw):
    model = build_model(get_config(ARCH))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR, eps=eps))
    return teng.EngineConfig(model=model, opt=opt, **{**_statics(), **kw})


def _jax_cfg(eps=1e-8, **kw):
    model = jax_build_model(jax_get_config(ARCH))
    opt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=eps))
    return jeng.EngineConfig(model=model, opt=opt, **{**_statics(), **kw})


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.fixture(scope="module")
def clients():
    return make_dr_swarm_data(image_size=16, seed=0, table=SMALL_TABLE)


@pytest.fixture(scope="module")
def model():
    return build_model(get_config(ARCH))


@pytest.fixture(scope="module")
def port_data(clients, model):
    return teng.make_swarm_data(model.cfg, clients, device="cpu")


# ------------------------------------------------------------- the rows


def test_churn_params_are_the_references():
    """churn_params' fields, dtypes and values, and its validation
    messages, are the reference's."""
    sched = np.random.default_rng(0).random((3, N)) > 0.5
    for kw in (dict(), dict(dropout=0.3), dict(stale_decay=0.5, mask=np.ones(N, bool)),
               dict(dropout=1.0, stale_decay=1.0, mask=sched)):
        expect = jax.tree.map(np.asarray, jeng.churn_params(**kw)._asdict())
        got = bridge.churn_params_to_numpy(teng.churn_params(**kw))
        for f in ("dropout", "stale_decay", "mask"):
            if expect[f] is None:
                assert got[f] is None, (kw, f)
                continue
            np.testing.assert_array_equal(got[f], expect[f], err_msg=f"{kw} {f}")
            assert got[f].dtype == expect[f].dtype and got[f].shape == expect[f].shape, (kw, f)
    for bad in (dict(dropout=1.5), dict(dropout=-0.1), dict(stale_decay=-0.1),
                dict(stale_decay=2.0), dict(mask=np.ones((2, 3, N), bool))):
        with pytest.raises(ValueError) as expect:
            jeng.churn_params(**bad)
        with pytest.raises(ValueError) as got:
            teng.churn_params(**bad)
        assert str(got.value) == str(expect.value), bad


def test_churn_grid_rows_stack_like_the_references():
    """make_grid_config over churn specs through the bridge: the stacked
    churn fields and every row; mixed churn and churn-free rows refused
    with the reference's message."""
    jcfg, tcfg = _jax_cfg(), _port_cfg()
    specs = jeng.grid_axes(dropout=(0.0, 0.3), stale_decay=(0.0, 0.5))
    assert teng.grid_axes(dropout=(0.0, 0.3), stale_decay=(0.0, 0.5)) == specs
    jgrid = jax.tree.map(np.asarray, jeng.make_grid_config(jcfg, N, specs)._asdict())
    grid = teng.make_grid_config(tcfg, N, specs)
    bridged = bridge.grid_point_from_numpy(jgrid)
    assert bridged.churn.mask is None and grid.churn.mask is None
    for a, b in zip(bridged.churn[:2], grid.churn[:2]):
        assert torch.equal(a, b) and a.shape == (len(specs),)
    for g, spec in enumerate(specs):
        row, one = teng.grid_row(grid, g), teng.grid_point(tcfg, N, **spec)
        assert all(torch.equal(a, b) for a, b in zip(row.churn[:2], one.churn[:2]))
        back = bridge.grid_point_from_numpy(bridge.grid_point_to_numpy(row))
        assert all(torch.equal(a, b) for a, b in zip(back.churn[:2], row.churn[:2]))
    masks = [{"churn_mask": np.arange(N) % (g + 2) > 0} for g in range(2)]
    jm = jax.tree.map(np.asarray, jeng.make_grid_config(jcfg, N, masks)._asdict())
    tm = teng.make_grid_config(tcfg, N, masks)
    np.testing.assert_array_equal(tm.churn.mask.numpy(), jm["churn"].mask)
    assert torch.equal(bridge.grid_point_from_numpy(jm).churn.mask, tm.churn.mask)
    assert torch.equal(teng.grid_row(tm, 1).churn.mask, torch.from_numpy(masks[1]["churn_mask"]))
    for mixed in ([{"dropout": 0.3}, {"k": 2}], [{}, {"stale_decay": 0.5}]):
        with pytest.raises(ValueError) as expect:
            jeng.make_grid_config(jcfg, N, mixed)
        with pytest.raises(ValueError) as got:
            teng.make_grid_config(tcfg, N, mixed)
        assert str(got.value) == str(expect.value)
    with pytest.raises(ValueError, match="churn_mask or none"):
        teng.make_grid_config(tcfg, N, [{"dropout": 0.3}, masks[0]])


# ------------------------------------------------------ masked k-means


def _points(seed, n=12, f=6):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 3.0, size=(3, f))
    return (centres[rng.integers(0, 3, n)] + rng.normal(0.0, 0.5, size=(n, f))).astype(np.float32)


MASKS = [np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1], bool),
         np.array([0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0], bool),
         np.ones(12, bool)]


@pytest.mark.parametrize("m", range(len(MASKS)))
@pytest.mark.parametrize("k_active", [None, 2])
def test_masked_kmeans_matches_reference_on_its_seed_rows(m, k_active):
    """The port's masked k-means seeded with the reference's masked
    k-means++ rows: assignments equal, centroids within 1e-5 (fp32 means
    summed in another order)."""
    X, mask = _points(m), MASKS[m]
    key = jax.random.PRNGKey(10 + m)
    ka = None if k_active is None else jnp.asarray(k_active, jnp.int32)
    C_ref, a_ref = jax_kmeans(key, jnp.asarray(X), 3, iters=KMEANS_ITERS, k_active=ka,
                              mask=jnp.asarray(mask))
    init = jax_kmeans_init_idx(key, X, 3, mask=mask)
    C, a = tkm.kmeans(torch.from_numpy(X), 3, KMEANS_ITERS, init_idx=torch.from_numpy(init),
                      k_active=None if k_active is None else torch.tensor(k_active),
                      mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    live = 3 if k_active is None else k_active
    np.testing.assert_allclose(C.numpy()[:live], np.asarray(C_ref)[:live], rtol=0, atol=1e-5)


def test_masked_lloyd_step_reseeds_an_all_absent_cluster_to_a_present_point():
    """A cluster holding absent points only is empty and takes the
    farthest *present* point, as the reference's lloyd_step does (mirror
    of tests/test_churn.py's all-absent-cluster case)."""
    rng = np.random.default_rng(3)
    X = np.concatenate([rng.normal(0.0, .1, size=(6, 2)),
                        rng.normal(50.0, .1, size=(4, 2))]).astype(np.float32)
    mask = np.asarray([True] * 6 + [False] * 4)
    C = np.asarray([[0.0, 0.0], [50.0, 50.0]], np.float32)
    got = tkm.lloyd_step(torch.from_numpy(X), torch.from_numpy(C), 2,
                         mask=torch.from_numpy(mask)).numpy()
    expect = np.asarray(jax_lloyd_step(jnp.asarray(X), jnp.asarray(C), 2, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-6)
    assert np.isfinite(got).all()
    assert np.linalg.norm(X[:6] - got[1], axis=1).min() == 0.0
    assert np.linalg.norm(X[6:] - got[1], axis=1).min() > 1.0


def test_all_ones_mask_is_the_unmasked_kmeans_bitwise():
    """With every point present the masked seeding picks the same rows
    (the first seed a uniform pick over the present subsequence) and the
    whole run is the unmasked one, bitwise; on a partial mask the first
    seed is the floor(u * n_present)-th present point."""
    X = torch.from_numpy(_points(7, n=20))
    for seed in range(5):
        u = torch.rand((3,), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
        ones = torch.ones(20, dtype=torch.bool)
        assert torch.equal(tkm.kmeans_pp_init(X, 3, u=u), tkm.kmeans_pp_init(X, 3, u=u, mask=ones))
        C0, a0 = tkm.kmeans(X, 3, 5, u=u)
        C1, a1 = tkm.kmeans(X, 3, 5, u=u, mask=ones)
        assert torch.equal(C0, C1) and torch.equal(a0, a1)
        mask = torch.arange(20) % 3 != 1
        present = torch.nonzero(mask).flatten()
        first = tkm.kmeans_pp_init(X, 3, u=u, mask=mask)[0]
        assert torch.equal(first, X[present[int(u[0] * len(present))]])
        seeds = tkm.kmeans_pp_init(X, 3, u=u, mask=mask)
        assert all(bool(mask[(X == c).all(dim=1)].all()) for c in seeds), "an absent seed"


# -------------------------------------------------------- masked Eq. 2


def test_cluster_fedavg_masked_matches_reference():
    """Hard mask with an all-absent cluster, and stale weights: equal to
    the reference within 1e-6 (fp32 segment sums in another order);
    members of the all-absent cluster keep their params bitwise; all
    ones with weights n * 1.0 is cluster_fedavg bitwise."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=(6, 3, 2)).astype(np.float32)}
    tparams = bridge.params_from_numpy(params)
    assignments = np.asarray([0, 0, 1, 1, 2, 2], np.int32)
    n = np.asarray([10., 20., 30., 40., 50., 60.], np.float32)
    present = np.asarray([1, 1, 0, 0, 1, 0], bool)
    stale = np.asarray([0, 0, 1, 2, 0, 3], np.int32)
    for decay in (0.0, 0.5):
        w = n * np.power(np.float32(decay), stale.astype(np.float32))
        expect = jax_cluster_fedavg_masked(jax.tree.map(jnp.asarray, params),
                                           jnp.asarray(assignments), jnp.asarray(w),
                                           jnp.asarray(present), k=3)
        got = cluster_fedavg_masked(tparams, torch.from_numpy(assignments),
                                    torch.from_numpy(w), torch.from_numpy(present), k=3)
        for key in params:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(expect[key]), rtol=0,
                                       atol=1e-6, err_msg=f"{decay} {key}")
            assert np.isfinite(got[key].numpy()).all()
            # absent clients keep their own params, in any cluster
            np.testing.assert_array_equal(got[key].numpy()[~present], params[key][~present])
    ones = torch.ones(6, dtype=torch.bool)
    a_t, n_t = torch.from_numpy(assignments), torch.from_numpy(n)
    assert _equal_trees(cluster_fedavg(tparams, a_t, n_t, k=3),
                        cluster_fedavg_masked(tparams, a_t, n_t * 1.0, ones, k=3))


# ------------------------------------------------------ masked local phase


def test_local_phase_present_freezes_absent_clients_and_masks_the_loss(clients, model,
                                                                       port_data):
    """Absent clients' params and optimizer state come out bitwise as
    they went in; a step's loss is the mean over present clients (within
    1e-6 relative of the plain mean of those clients' losses); with all
    ones the loss and everything else are the unmasked phase's bitwise
    (the loss rounds as torch.mean does)."""
    cfg = _port_cfg()
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    step = make_train_step(model, cfg.opt)
    draws = teng.draw_round(torch.Generator().manual_seed(1), port_data.train_n, cfg)

    def batches():
        return (teng.sample_round_batch(port_data, draws.batch_idx[i]) for i in range(2))

    p0, o0, l0 = teng.local_phase(step, state.params, state.opt_state, LR, batches())
    ones = torch.ones(N, dtype=torch.bool)
    p1, o1, l1 = teng.local_phase(step, state.params, state.opt_state, LR, batches(),
                                  present=ones)
    assert _equal_trees(p0, p1) and _equal_trees(o0, o1) and torch.equal(l0, l1)

    present = torch.tensor([1, 0, 1, 1, 0, 0, 1, 1], dtype=torch.bool)
    p2, o2, l2 = teng.local_phase(step, state.params, state.opt_state, LR, batches(),
                                  present=present)
    for new, old, moved in zip(tree_leaves(p2), tree_leaves(state.params), tree_leaves(p0)):
        assert torch.equal(new[~present], old[~present])
        assert torch.equal(new[present], moved[present])
    for new, old in zip(tree_leaves(o2), tree_leaves(state.opt_state)):
        assert torch.equal(new[~present], old[~present])
    # the loss of step 0 over the present clients only
    vstep = torch.func.vmap(step, in_dims=(0, 0, 0, None))
    _, _, m = vstep(state.params, state.opt_state, next(batches()), LR)
    np.testing.assert_allclose(float(l2[0]), float(m["loss"][present].mean()), rtol=1e-6)
    # composes with the grid's step count: one of two steps applied
    p3, _, _ = teng.local_phase(step, state.params, state.opt_state, LR, batches(),
                                n_active=torch.tensor(1), present=present)
    p4, _, _ = teng.local_phase(step, state.params, state.opt_state, LR,
                                [next(batches())], present=present)
    assert _equal_trees(p3, p4)


# ------------------------------------------ a whole round vs the reference


@pytest.fixture(scope="module")
def jax_state0(clients):
    """The reference's fresh state from key 0 (adam eps 1e-6), its
    staleness set to STALENESS0, as numpy arrays."""
    jcfg = _jax_cfg(eps=ROUND_ADAM_EPS)
    state = jax.jit(lambda k: jeng.make_swarm_state(jcfg.model, jcfg.opt, clients, k))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state._replace(staleness=jnp.asarray(STALENESS0)))


@pytest.fixture(scope="module")
def reference_churn_rounds(clients, jax_state0):
    """For each case, the reference's churn round (``jit_swarm_round``)
    and that round's draws rebuilt from the key as swarm_round derives
    them: the churn uniforms from ``fold_in(k_local, 0x0C)``, the batch
    rows, the masked k-means++ seed rows and the brain-storm draws."""
    jcfg = _jax_cfg(eps=ROUND_ADAM_EPS)
    jdata = jeng.make_swarm_data(jcfg.model.cfg, clients)
    _, k_local, k_kmeans, k_bso = jax.random.split(jnp.asarray(jax_state0.key), 4)
    u = np.array(jax.random.uniform(jax.random.fold_in(k_local, jeng._CHURN_KEY_TAG), (N,)))
    present = u >= np.float32(DROPOUT)
    sample_keys = jax.random.split(k_local, LOCAL_STEPS)
    own, g = [], []
    for kt in sample_keys:
        own.append(np.array(jax.random.randint(kt, (N, BATCH), 0, jdata.train_n[:, None])))
        g.append(np.array(jax.random.randint(jax.random.fold_in(kt, 1), (N, BATCH), 0,
                                             jnp.cumsum(jdata.train_n)[-1])))
    step = jax_make_train_step(jcfg.model, jcfg.opt)

    @jax.jit
    def feats_of(s, pool):
        params = jeng.local_phase(
            step, s.params, s.opt_state, LR, sample_keys,
            lambda kt: jeng.sample_round_batch(kt, jdata, BATCH, pool),
            present=jnp.asarray(present))[0]
        return jax_feats(params)

    out = {}
    for case in CASES:
        path, decay = case
        churn = jeng.churn_params(dropout=DROPOUT, stale_decay=decay)
        pool = None
        if path == "grid":
            point = jeng.grid_point(jcfg, N, dropout=DROPOUT, stale_decay=decay)
            pool = point.method.pool_data
            jnew, jm = jeng.jit_swarm_round(jax.tree.map(jnp.asarray, jax_state0), jdata, jcfg,
                                            point)
            row = jax.tree.map(np.asarray, point._asdict())
        else:
            jnew, jm = jeng.jit_swarm_round(jax.tree.map(jnp.asarray, jax_state0), jdata, jcfg,
                                            None, churn)
            row = None
        feats = feats_of(jax.tree.map(jnp.asarray, jax_state0), pool)
        draws = teng.RoundDraws(
            batch_idx=torch.from_numpy(np.stack(own)),
            kmeans_init_idx=torch.from_numpy(jax_kmeans_init_idx(k_kmeans, feats, 3,
                                                                 mask=present)),
            bso=BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(k_bso, 3, N))),
            pool_idx=torch.from_numpy(np.stack(g)), churn_u=torch.from_numpy(u))
        out[case] = (row, draws, jax.tree.map(np.asarray, jnew._asdict()),
                     jax.tree.map(np.asarray, jm))
    return out


CASES = [("plain", 0.0), ("plain", 0.5), ("grid", 0.5)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-decay{c[1]}")
def test_churn_round_matches_reference(case, jax_state0, port_data, reference_churn_rounds):
    """One churn round from the reference's state on its draws: presence,
    staleness, assignments, centers and event counts equal; params
    within atol 1e-4 (5% of one adam step at lr 2e-3, as in
    test_torch_engine), val accuracy within 1e-6, the loss within rtol
    1e-4; absent clients' params and optimizer state bitwise as they
    were."""
    row, draws, jnew, jm = reference_churn_rounds[case]
    present = jm.present
    assert 0 < present.sum() < N, "the case must drop some clients and keep some"
    tstate = bridge.state_from_numpy(jax_state0._asdict(), "cpu")
    cfg = _port_cfg(eps=ROUND_ADAM_EPS)
    if row is None:
        tnew, tm = teng.swarm_round(tstate, port_data, cfg, draws=draws,
                                    churn=teng.churn_params(DROPOUT, case[1]))
    else:
        tnew, tm = teng.swarm_round(tstate, port_data, cfg, bridge.grid_point_from_numpy(row),
                                    draws=draws)
    np.testing.assert_array_equal(tm.present.numpy(), present)
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
    for new, old in zip(tree_leaves(tnew.opt_state), tree_leaves(tstate.opt_state)):
        assert torch.equal(new[~tm.present], old[~tm.present])


# ---------------------------------------------------- round semantics


def test_single_present_client_round(clients, model, port_data):
    """Only client 3 takes part: it trains, every other client is frozen
    bitwise, nothing is NaN, staleness is 1 for the others (mirror of
    tests/test_churn.py)."""
    cfg = _port_cfg()
    mask = np.zeros((1, N), bool)
    mask[0, 3] = True
    state = teng.make_swarm_state(model, cfg.opt, clients, 7, device="cpu")
    before = tree_map(torch.clone, state.params)
    s, ms = teng.run_rounds(state, port_data, cfg, 1, churn=teng.churn_params(mask=mask))
    moved = False
    for x, y in zip(tree_leaves(before), tree_leaves(s.params)):
        assert torch.isfinite(y).all()
        assert torch.equal(x[~torch.from_numpy(mask[0])], y[~torch.from_numpy(mask[0])])
        moved |= not torch.equal(x[3], y[3])
    assert moved, "the present client never trained"
    np.testing.assert_array_equal(ms.present[0].numpy(), mask[0])
    np.testing.assert_array_equal(s.staleness.numpy(), np.where(mask[0], 0, 1))


def test_staleness_resets_on_participation(clients, model, port_data):
    """Under a (rounds, N) schedule round r takes row r, and staleness
    follows where(present, 0, s + 1) (mirror of tests/test_churn.py)."""
    cfg = _port_cfg(kmeans_iters=3)
    rng = np.random.default_rng(5)
    sched = rng.random((4, N)) > 0.4
    sched[:, 0] = True
    state = teng.make_swarm_state(model, cfg.opt, clients, 1, device="cpu")
    s, ms = teng.run_rounds(state, port_data, cfg, 4,
                            churn=teng.churn_params(stale_decay=0.5, mask=sched))
    np.testing.assert_array_equal(ms.present.numpy(), sched)
    expect = np.zeros(N, np.int64)
    for r in range(4):
        expect = np.where(sched[r], 0, expect + 1)
    np.testing.assert_array_equal(s.staleness.numpy(), expect)
    assert torch.isfinite(ms.mean_val_acc).all()


def test_churn_validation_errors(clients, model, port_data):
    """A schedule of the wrong length, a churn grid with a step schedule
    and a (rounds, N) mask handed to one round are refused with the
    reference's messages; a stateless or drawless churn round is
    refused."""
    cfg = _port_cfg(kmeans_iters=2)
    jcfg = _jax_cfg(kmeans_iters=2)
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    sched = np.ones((3, N), bool)
    with pytest.raises(ValueError, match="3 rows for rounds=2"):
        teng.run_rounds(state, port_data, cfg, 2, churn=teng.churn_params(mask=sched))
    with pytest.raises(ValueError, match="run_rounds scans"):
        teng.swarm_round(state, port_data, cfg, churn=teng.churn_params(mask=sched))
    grid = teng.make_grid_config(cfg, N, [{"dropout": 0.0}, {"dropout": 0.3}])
    states = teng.make_grid_state(model, cfg.opt, clients, [0, 1], device="cpu")
    jgrid = jeng.make_grid_config(jcfg, N, [{"dropout": 0.0}, {"dropout": 0.3}])
    with pytest.raises(ValueError) as expect:
        jeng.run_grid(None, None, jcfg, jgrid, 2, schedule=(2, 2))
    with pytest.raises(ValueError) as got:
        teng.run_grid(states, port_data, cfg, grid, 2, schedule=(2, 2))
    assert str(got.value) == str(expect.value)
    assert "pass schedule=None" in str(got.value)
    with pytest.raises(ValueError, match="staleness"):
        teng.swarm_round(state._replace(staleness=None), port_data, cfg,
                         churn=teng.churn_params(0.3))
    draws = teng.draw_round(torch.Generator().manual_seed(0), port_data.train_n, cfg)
    with pytest.raises(ValueError, match="churn_u"):
        teng.swarm_round(state, port_data, cfg, draws=draws, churn=teng.churn_params(0.3))


# ------------------------------------------------------------- anchors


def test_dropout0_grid_row_bitwise_churn_free_row(clients, model, port_data):
    """A dropout=0 churn grid row is bitwise the churn-free row over 3
    rounds: params, optimizer state, every metric, all present, zero
    staleness (mirror of tests/test_churn.py, in the port alone); an
    all-ones mask on the plain path is the plain path bitwise."""
    cfg = _port_cfg(kmeans_iters=5)
    s0 = teng.make_swarm_state(model, cfg.opt, clients, 3, device="cpu")
    runs = [teng.run_rounds(teng.copy_state(s0), port_data, cfg, 3, teng.grid_point(cfg, N, **kw))
            for kw in ({}, {"dropout": 0.0})]
    runs += [teng.run_rounds(teng.copy_state(s0), port_data, cfg, 3, churn=churn)
             for churn in (None, teng.churn_params(mask=np.ones(N, bool)))]
    for (sa, ma), (sb, mb) in (runs[:2], runs[2:]):
        assert _equal_trees(sa.params, sb.params) and _equal_trees(sa.opt_state, sb.opt_state)
        for f, x, y in zip(teng.RoundMetrics._fields, ma, mb):
            assert torch.equal(x, y), f
        assert mb.present.all() and not sb.staleness.any()


# draw_round(Generator().manual_seed(1234), train_n=[3, 5, 7, 11],
# local_steps=2, batch 3, k 2), as the port drew it before the churn axis
PINNED_BATCH_IDX = [[[0, 0, 1], [2, 1, 1], [1, 1, 1], [10, 8, 0]],
                    [[2, 1, 0], [1, 1, 0], [5, 4, 2], [3, 4, 3]]]
PINNED_POOL_IDX = [[[1, 0, 12], [8, 22, 12], [25, 7, 20], [11, 8, 25]],
                   [[2, 3, 13], [7, 12, 10], [25, 4, 20], [5, 18, 21]]]
PINNED_KMEANS_U = [0.16097200609720752, 0.07606773363629105]
PINNED_R1, PINNED_R2 = [0.644945502281189, 0.7224201560020447], [0.5034589171409607,
                                                                  0.3081597685813904]
PINNED_NEXT = [0.6260157196779915, 0.9425477487223252]


def test_churn_stream_leaves_the_round_generator_alone(clients, model, port_data):
    """draw_round's stream is pinned on a fixed seed as it was before the
    churn axis; a churn round (dropout 0.4) leaves state.generator where
    the churn-free round from the same state leaves it, and draws its
    uniforms from the churn generator alone."""
    from types import SimpleNamespace
    gen = torch.Generator().manual_seed(1234)
    d = teng.draw_round(gen, torch.tensor([3, 5, 7, 11]),
                        SimpleNamespace(local_steps=2, batch_size=3, n_clusters=2))
    assert d.batch_idx.tolist() == PINNED_BATCH_IDX and d.pool_idx.tolist() == PINNED_POOL_IDX
    assert d.kmeans_u.tolist() == PINNED_KMEANS_U and d.churn_u is None
    assert d.bso.r1.tolist() == PINNED_R1 and d.bso.r2.tolist() == PINNED_R2
    assert torch.rand((2,), generator=gen, dtype=torch.float64).tolist() == PINNED_NEXT

    cfg = _port_cfg(kmeans_iters=2, local_steps=1)
    s0 = teng.make_swarm_state(model, cfg.opt, clients, 9, device="cpu")
    plain, _ = teng.swarm_round(teng.copy_state(s0), port_data, cfg)
    churned_state = teng.copy_state(s0)
    churned, m = teng.swarm_round(churned_state, port_data, cfg,
                                  churn=teng.churn_params(dropout=0.4))
    assert not m.present.all(), "dropout 0.4 dropped no client of 8"
    assert torch.equal(plain.generator.get_state(), churned.generator.get_state())
    fresh = teng.make_churn_generator(9, "cpu")
    assert torch.equal(m.present, teng.draw_churn(fresh, N, "cpu") >= 0.4)
    assert torch.equal(fresh.get_state(), churned.churn_generator.get_state())
    assert not torch.equal(teng.make_churn_generator(9, "cpu").get_state(),
                           torch.Generator().manual_seed(9).get_state())


def test_bridge_carries_staleness(jax_state0):
    """state_from_numpy / state_to_numpy carry staleness; a state from
    before the churn axis gets zeros; the churn generator is seeded as
    make_swarm_state seeds it."""
    state = bridge.state_from_numpy(jax_state0._asdict(), "cpu", seed=5)
    np.testing.assert_array_equal(state.staleness.numpy(), STALENESS0)
    assert state.staleness.dtype == torch.int32
    np.testing.assert_array_equal(bridge.state_to_numpy(state)["staleness"], STALENESS0)
    old = {k: v for k, v in jax_state0._asdict().items() if k != "staleness"}
    assert not bridge.state_from_numpy(old, "cpu").staleness.any()
    assert torch.equal(state.churn_generator.get_state(),
                       teng.make_churn_generator(5, "cpu").get_state())


# ------------------------------------------------------ the churn grid


def test_churn_grid_through_run_grid_table(clients, model):
    """dropout x stale decay through run_grid_table, 2 rounds: presence
    of shape (G, rounds, N), dropout-0 rows always present, staleness the
    run of trailing absences, finite metrics, no schedule; row g is
    run_grid_point of its spec and seed, bitwise."""
    swarm = SwarmConfig(n_clients=N, n_clusters=3, rounds=2, local_steps=1, kmeans_iters=3)
    specs = teng.grid_axes(dropout=(0.0, 0.5), stale_decay=(0.0, 0.5))
    calls = []
    run_grid = baselines.run_grid

    def spy(*args, **kw):
        calls.append(args[5] if len(args) > 5 else kw.get("schedule"))
        return run_grid(*args, **kw)

    baselines.run_grid = spy
    try:
        results, run = baselines.run_grid_table(model, clients, swarm, OPT, 4, specs=specs,
                                                batch_size=BATCH, device="cpu")
    finally:
        baselines.run_grid = run_grid
    assert calls == [None]
    ms = run.metrics
    assert ms.present.shape == (len(specs), 2, N) and ms.present.dtype == torch.bool
    for g, spec in enumerate(specs):
        if spec["dropout"] == 0.0:
            assert ms.present[g].all()
        stale = run.state[g].staleness
        expect = torch.zeros(N, dtype=torch.int32)
        for r in range(2):
            expect = torch.where(ms.present[g, r], 0, expect + 1)
        assert torch.equal(stale, expect.int())
        assert torch.isfinite(ms.train_loss[g]).all() and 0.0 <= results[g]["acc"] <= 1.0
    assert not ms.present[[g for g, s in enumerate(specs) if s["dropout"] > 0]].all()
    g = 3
    acc, serial = baselines.run_grid_point(specs[g], model, clients, swarm, OPT,
                                           baselines.sweep_keys(4, specs)[g],
                                           batch_size=BATCH, device="cpu")
    assert acc == results[g]["acc"] and _equal_trees(serial.state.params, run.state[g].params)
    assert torch.equal(serial.metrics.present, ms.present[g])
