"""The port's hyper-parameter grid axis against the JAX reference on the CPU.

The centre piece is one whole ``swarm_round`` under a ``GridPoint`` (k=2
under the pad 3, p1=1.0, lr and local-step overrides) from a bridged
reference state, with the reference's randomness rebuilt from its key
and injected as ``RoundDraws``, against ``jit_swarm_round`` with the
reference's own ``GridPoint``. Beside it: the rows, the axes and their
validation; the masked ``k_active`` k-means against a native smaller k
and against the reference's; the brain storm's pad slots; the masked
local steps and the lr override; a padded row against the native-k
method row; ``run_grid`` against ``run_grid_point`` (with and without a
schedule); ``run_grid_table``'s pads and schedule; and the per-client
distribution-matrix oracle. Sizes are tests/test_grid.py's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import diststats as jds  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.diststats import swarm_distribution_matrix as jax_feats  # noqa: E402
from repro.core.kmeans import kmeans as jax_kmeans  # noqa: E402
from repro.data.dr import TABLE_I, make_dr_swarm_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import diststats as tds  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.core.aggregation import cluster_fedavg  # noqa: E402
from repro_torch.core.bso import BSODraws, brain_storm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths_and_leaves  # noqa: E402
from torch_parity import jax_bso_draws, jax_kmeans_init_idx, pin_torch_threads  # noqa: E402

pin_torch_threads()

SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)
N = TABLE_I.shape[1]
ARCH = "squeezenet-dr"
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 8
KMEANS_ITERS = 10
# adam's eps in the whole-round parity test: 1e-6, for the reason given
# at test_torch_engine.ROUND_ADAM_EPS
ROUND_ADAM_EPS = 1e-6
# the reference round's grid row: k=2 under the pad 3, no center
# replacement, its own lr, one of the two static steps
GRID_SPEC = dict(k=2, p1=1.0, lr=1e-3, local_steps=1)


def _statics(n_clusters=3, local_steps=LOCAL_STEPS):
    return dict(local_steps=local_steps, batch_size=BATCH, lr=LR, aggregation="bso",
                n_clusters=n_clusters, p1=0.9, p2=0.8, kmeans_iters=KMEANS_ITERS)


def _port_cfg(eps=1e-8, **kw):
    model = build_model(get_config(ARCH))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR, eps=eps))
    return teng.EngineConfig(model=model, opt=opt, **{**_statics(), **kw})


def _jax_cfg(eps=1e-8, **kw):
    model = jax_build_model(jax_get_config(ARCH))
    opt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=eps))
    return jeng.EngineConfig(model=model, opt=opt, **{**_statics(), **kw})


def _swarm(rounds=2, local_steps=LOCAL_STEPS, n_clusters=3):
    return SwarmConfig(n_clients=N, n_clusters=n_clusters, rounds=rounds,
                       local_steps=local_steps, kmeans_iters=KMEANS_ITERS)


OPT = OptimizerConfig(name="adam", lr=LR)


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _grid_leaves(point):
    churn = [] if point.churn is None else [t for t in point.churn if t is not None]
    return list(point.method) + list(point[1:-1]) + churn


def _assert_runs_equal(a, b, what):
    """Two (state, RoundMetrics) results bitwise equal."""
    (sa, ma), (sb, mb) = a, b
    assert _equal_trees(sa.params, sb.params), f"{what}: params"
    assert _equal_trees(sa.opt_state, sb.opt_state), f"{what}: optimizer state"
    for f, x, y in zip(teng.RoundMetrics._fields, ma, mb):
        assert torch.equal(x, y), f"{what}: {f}"


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


def test_grid_rows_and_config_are_the_references():
    """grid_point, make_grid_config, grid_row and grid_axes against the
    reference's, through the bridge: every field, its dtype and value."""
    jcfg, tcfg = _jax_cfg(), _port_cfg()
    specs = [{}, dict(k=1), dict(k=2, p1=1.0, p2=0.0), dict(local_steps=1, lr=0.0),
             dict(method="fedavg", k=3), dict(method="centralized", lr=5e-4)]
    for spec in specs:
        expect = jax.tree.map(np.asarray, jeng.grid_point(jcfg, N, **spec)._asdict())
        got = bridge.grid_point_to_numpy(teng.grid_point(tcfg, N, **spec))
        assert expect.pop("churn") is None
        for f in ("n_clusters", "p1", "p2", "local_steps", "lr"):
            np.testing.assert_array_equal(got[f], expect[f], err_msg=f"{spec} {f}")
            assert got[f].dtype == expect[f].dtype and got[f].shape == (), (spec, f)
        for f, v in expect["method"]._asdict().items():
            np.testing.assert_array_equal(got["method"][f], v, err_msg=f"{spec} method.{f}")
    jgrid = jax.tree.map(np.asarray, jeng.make_grid_config(jcfg, N, specs)._asdict())
    grid = bridge.grid_point_from_numpy(jgrid)
    for a, b in zip(_grid_leaves(grid), _grid_leaves(teng.make_grid_config(tcfg, N, specs))):
        assert torch.equal(a, b)
    assert grid.lr.shape == (len(specs),) and grid.method.base_assign.shape == (len(specs), N)
    for g, spec in enumerate(specs):
        row = teng.grid_row(grid, g)
        one = teng.grid_point(tcfg, N, **spec)
        assert all(torch.equal(a, b) for a, b in zip(_grid_leaves(row), _grid_leaves(one)))
        back = bridge.grid_point_from_numpy(bridge.grid_point_to_numpy(row))
        assert all(torch.equal(a, b) for a, b in zip(_grid_leaves(back), _grid_leaves(row)))
    axes = dict(k=(1, 2), p1=(0.9, 1.0), p2=(0.8,))
    assert teng.grid_axes(**axes) == jeng.grid_axes(**axes)
    assert teng.grid_axes(local_steps=(1, 2), k=(3,)) == jeng.grid_axes(local_steps=(1, 2), k=(3,))


@pytest.mark.parametrize("bad", [dict(k=0), dict(k=4), dict(local_steps=0),
                                 dict(local_steps=3), dict(k=-1, local_steps=1)])
def test_grid_point_validates_with_the_references_messages(bad):
    with pytest.raises(ValueError) as expect:
        jeng.grid_point(_jax_cfg(), N, **bad)
    with pytest.raises(ValueError) as got:
        teng.grid_point(_port_cfg(), N, **bad)
    assert str(got.value) == str(expect.value)


@pytest.mark.parametrize("knob", [dict(dropout=0.0), dict(stale_decay=0.5),
                                  dict(churn_mask=np.ones(N, bool)),
                                  dict(dropout=0.1, stale_decay=0.9)])
def test_churn_knobs_match_the_reference(clients, model, knob):
    """A churn knob gives the row the reference's ChurnParams (every
    field, dtype and value, through grid_point and through the bridge),
    and run_grid_table refuses a grid that mixes churn and churn-free
    rows with the reference's message."""
    expect = jax.tree.map(np.asarray, jeng.grid_point(_jax_cfg(), N, **knob)._asdict())
    row = teng.grid_point(_port_cfg(), N, **knob)
    got = bridge.grid_point_to_numpy(row)["churn"]
    for f, v in expect["churn"]._asdict().items():
        if v is None:
            assert got[f] is None, f
            continue
        np.testing.assert_array_equal(got[f], v, err_msg=f)
        assert got[f].dtype == v.dtype and got[f].shape == v.shape, f
    bridged = bridge.grid_point_from_numpy(expect)
    assert all(torch.equal(a, b) for a, b in zip(_grid_leaves(bridged), _grid_leaves(row)))
    with pytest.raises(ValueError) as jerr:
        jeng.make_grid_config(_jax_cfg(), N, [{}, knob])
    with pytest.raises(ValueError) as err:
        baselines.run_grid_table(model, clients, _swarm(rounds=1), OPT, 0,
                                 specs=[{}, knob], batch_size=BATCH, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_grid_row_on_another_device_is_refused(clients, model, port_data):
    cfg = _port_cfg(kmeans_iters=2)
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    row = teng.grid_point(cfg, N, device="meta")
    with pytest.raises(ValueError, match="device="):
        teng.swarm_round(state, port_data, cfg, row)
    with pytest.raises(ValueError, match="GridPoint row only"):
        teng.swarm_round(state, port_data, cfg, teng.method_params("bso-sl", N), steps=1)


# ------------------------------------------------------ masked k-means


@pytest.mark.parametrize("j", [1, 2, 3, 4])
def test_padded_k_active_kmeans_matches_native_k(j):
    """kmeans(k=4, k_active=j) against kmeans(k=j) on the first j of the
    padded run's uniforms: the same assignments, live centroids equal up
    to the mean step's matmul tiling (rtol 1e-6, the reference's own
    tolerance for this property)."""
    X = torch.from_numpy(np.random.default_rng(0).normal(size=(20, 5)).astype(np.float32))
    u = torch.rand((4,), generator=torch.Generator().manual_seed(j), dtype=torch.float64)
    C_pad, a_pad = tkm.kmeans(X, 4, 8, u=u, k_active=torch.tensor(j, dtype=torch.int32))
    C_nat, a_nat = tkm.kmeans(X, j, 8, u=u[:j])
    assert torch.equal(a_pad, a_nat)
    assert int(a_pad.max()) < j
    np.testing.assert_allclose(C_pad[:j].numpy(), C_nat.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("j", [1, 2, 3])
def test_k_active_kmeans_matches_reference_masked_kmeans(j):
    """The port's masked k-means from the reference's k-means++ seed rows
    (all 4 slots, as the reference seeds them) against the reference's
    ``kmeans(k=4, k_active=j)``: equal assignments, centroids within
    1e-5 (fp32 means summed in another order)."""
    X = np.random.default_rng(10 + j).normal(size=(14, 56)).astype(np.float32)
    key = jax.random.PRNGKey(j)
    jC, ja = jax_kmeans(key, jnp.asarray(X), 4, iters=KMEANS_ITERS, k_active=jnp.int32(j))
    idx = jax_kmeans_init_idx(key, X, 4)
    tC, ta = tkm.kmeans(torch.from_numpy(X), 4, KMEANS_ITERS, init_idx=torch.from_numpy(idx),
                        k_active=torch.tensor(j, dtype=torch.int32))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-5, atol=1e-5)


def test_lloyd_step_reseeds_only_live_empty_clusters():
    """Two live clusters, both empty after the assign of a far centroid
    pair (dead slots hold the points' own rows): the live ones take the
    two farthest points and the dead pad rows fall to 0 (no members, no
    reseed)."""
    X = torch.tensor([[0.0, 0.0], [1.0, 0.0], [5.0, 0.0], [9.0, 0.0]])
    C = torch.tensor([[100.0, 0.0], [100.0, 0.0], [0.0, 0.0], [9.0, 0.0]])
    got = tkm.lloyd_step(X, C, 4, torch.tensor(2))
    a = ops.kmeans_assign(X, C, torch.tensor(2)).tolist()
    assert a == [0, 0, 0, 0]
    assert torch.equal(got[0], X.mean(dim=0))
    # cluster 1 is the only live empty one: it takes the farthest point
    assert torch.equal(got[1], X[0]) and not got[2:].any()
    # unmasked, the slots at the points take them and clusters 0, 1 reseed
    plain = tkm.lloyd_step(X, C, 4)
    assert torch.equal(plain[0], X[2]) and torch.equal(plain[1], X[1])


# ------------------------------------------------------ brain storm pads


def test_brain_storm_pad_slots_never_act():
    """At a static k=5 with clients only in clusters 0-2 and draws that
    would replace and swap every slot, the pad slots stay unoccupied:
    center -1, never a swap partner, never counted, never assigned. The
    live slots act as a native k=3 run on the first slices of the same
    draws; p1 and p2 may be () tensors."""
    gen = torch.Generator().manual_seed(0)
    a = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1], dtype=torch.int32)
    val = torch.rand((N,), generator=gen)
    r1, r2 = torch.ones(5), torch.ones(5)
    g = -torch.log(-torch.log(torch.rand((5, N), generator=gen)))
    g2 = -torch.log(-torch.log(torch.rand((5, 5), generator=gen)))
    p1, p2 = torch.tensor(0.0), torch.tensor(0.0)
    pad = brain_storm(a, val, 5, p1, p2, draws=BSODraws(r1, g, r2, g2))
    nat = brain_storm(a, val, 3, 0.0, 0.0, draws=BSODraws(r1[:3], g[:3], r2[:3], g2[:3, :3]))
    assert torch.equal(pad[0], nat[0]) and int(pad[0].max()) <= 2
    assert torch.equal(pad[1][:3], nat[1]) and pad[1][3:].tolist() == [-1, -1]
    assert (int(pad[2]), int(pad[3])) == (int(nat[2]), int(nat[3]))
    assert int(pad[3]) == 3, "every live slot swaps, no pad slot does"


# ----------------------------------------------------- the local phase


def test_local_phase_n_active_selects_the_first_steps(clients, model, port_data):
    """Steps >= n_active leave params and optimizer state bitwise as
    they were; n_active = all steps is the unmasked path, bitwise."""
    cfg = _port_cfg()
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    step = teng.make_train_step(model, cfg.opt)
    gen = torch.Generator().manual_seed(1)
    idx = [teng.draw_batch_idx(gen, port_data.train_n, BATCH) for _ in range(3)]

    def run(k, n_active=None):
        batches = (teng.sample_local_batch(port_data.train, i) for i in idx[:k])
        return teng.local_phase(step, state.params, state.opt_state, LR, batches, n_active)

    for n in (1, 3):
        masked = run(3, torch.tensor(n, dtype=torch.int32))
        plain = run(n)
        assert _equal_trees(masked[0], plain[0]) and _equal_trees(masked[1], plain[1]), n
        assert torch.equal(masked[2][:n], plain[2])


def test_local_steps_and_lr_override_semantics(clients, model, port_data):
    """A row with lr=0 leaves every client at the Eq. 2 aggregate of its
    cluster's initial params (adam's zero-lr update is the identity), so
    the row's lr reaches the train step; fewer active steps change the
    params and keep the loss finite (tests/test_grid.py's test of the
    same name)."""
    cfg = _port_cfg()
    state = teng.make_swarm_state(model, cfg.opt, clients, 5, device="cpu")
    p0 = tree_map(torch.clone, state.params)
    s, m = teng.swarm_round(state, port_data, cfg, teng.grid_point(cfg, N, lr=0.0))
    assert _equal_trees(s.params, cluster_fedavg(p0, m.assignments, s.n_samples, k=N))

    s1, m1 = teng.swarm_round(teng.make_swarm_state(model, cfg.opt, clients, 5, device="cpu"),
                              port_data, cfg, teng.grid_point(cfg, N, local_steps=1))
    s2, _ = teng.swarm_round(teng.make_swarm_state(model, cfg.opt, clients, 5, device="cpu"),
                             port_data, cfg, teng.grid_point(cfg, N))
    assert not _equal_trees(s1.params, s2.params), "the local_steps mask had no effect"
    assert torch.isfinite(m1.train_loss)


# ------------------------------------------ a whole round vs the reference


@pytest.fixture(scope="module")
def reference_grid_round(clients):
    """The reference's fresh state from key 0, its GridPoint round
    (``jit_swarm_round``) and that round's draws, rebuilt from the key
    as swarm_round derives them."""
    jcfg = _jax_cfg(eps=ROUND_ADAM_EPS)
    jdata = jeng.make_swarm_data(jcfg.model.cfg, clients)
    state = jax.jit(lambda k: jeng.make_swarm_state(jcfg.model, jcfg.opt, clients, k))(
        jax.random.PRNGKey(0))
    state0 = jax.tree.map(np.asarray, state)
    jpoint = jeng.grid_point(jcfg, N, **GRID_SPEC)
    _, k_local, k_kmeans, k_bso = jax.random.split(jnp.asarray(state0.key), 4)
    sample_keys = jax.random.split(k_local, LOCAL_STEPS)
    own, g = [], []
    for kt in sample_keys:
        own.append(np.array(jax.random.randint(kt, (N, BATCH), 0, jdata.train_n[:, None])))
        g.append(np.array(jax.random.randint(jax.random.fold_in(kt, 1), (N, BATCH), 0,
                                             jnp.cumsum(jdata.train_n)[-1])))
    step = jax_make_train_step(jcfg.model, jcfg.opt)

    @jax.jit
    def feats_of(s):
        params = jeng.local_phase(
            step, s.params, s.opt_state, jpoint.lr, sample_keys,
            lambda kt: jeng.sample_round_batch(kt, jdata, BATCH, jpoint.method.pool_data),
            n_active=jpoint.local_steps)[0]
        return jax_feats(params)

    feats = feats_of(jax.tree.map(jnp.asarray, state0))
    draws = teng.RoundDraws(
        batch_idx=torch.from_numpy(np.stack(own)),
        kmeans_init_idx=torch.from_numpy(jax_kmeans_init_idx(k_kmeans, feats, 3)),
        bso=BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(k_bso, 3, N))),
        pool_idx=torch.from_numpy(np.stack(g)))
    jnew, jm = jeng.jit_swarm_round(jax.tree.map(jnp.asarray, state0), jdata, jcfg, jpoint)
    return (state0, jax.tree.map(np.asarray, jpoint._asdict()), draws,
            jax.tree.map(np.asarray, jnew.params), jax.tree.map(np.asarray, jm))


def test_grid_round_matches_reference(port_data, reference_grid_round):
    """The reference's GridPoint row through the bridge, one round from
    its state on its draws: assignments, centers and event counts equal,
    params within atol 1e-4 (5% of one adam step at lr 2e-3, as in
    test_torch_engine), val accuracy within 1e-6, the loss of the one
    applied step within rtol 1e-4."""
    state0, jpoint, draws, jparams, jm = reference_grid_round
    point = bridge.grid_point_from_numpy(jpoint)
    assert int(point.n_clusters) == 2 and int(point.local_steps) == 1
    tstate = bridge.state_from_numpy(state0._asdict(), "cpu")
    tnew, tm = teng.swarm_round(tstate, port_data, _port_cfg(eps=ROUND_ADAM_EPS), point,
                                draws=draws)
    np.testing.assert_array_equal(tm.assignments.numpy(), jm.assignments)
    np.testing.assert_array_equal(tm.centers.numpy(), jm.centers)
    assert int(tm.assignments.max()) < 2 and int(tm.centers[2]) == -1
    assert (int(tm.n_replaced), int(tm.n_swapped)) == (int(jm.n_replaced), int(jm.n_swapped))
    np.testing.assert_allclose(tm.val_acc.numpy(), jm.val_acc, atol=1e-6)
    np.testing.assert_allclose(float(tm.train_loss), float(jm.train_loss), rtol=1e-4)
    for (path, a), (_, b) in zip(tree_paths_and_leaves(bridge.params_to_numpy(tnew.params)),
                                 tree_paths_and_leaves(jparams)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=path)


# ------------------------------------------------- port-side contracts


def _native_draws(draws: teng.RoundDraws, j: int) -> teng.RoundDraws:
    """A padded round's draws cut to a native k=j round's."""
    r1, g, r2, g2 = draws.bso
    return draws._replace(kmeans_u=draws.kmeans_u[:j],
                          bso=BSODraws(r1[:j], g[:j], r2[:j], g2[:j, :j]))


@pytest.mark.parametrize("j", [1, 2])
def test_padded_row_equals_native_method_row_under_injected_draws(clients, model, port_data, j):
    """Two rounds of a k=j grid row under the pad 3 against the native
    n_clusters=j bso-sl method row, the native run's draws the first
    slices of the padded run's: params, optimizer state, assignments
    and event counts bitwise equal, the live centers equal and the pad
    centers -1."""
    cfg_pad, cfg_nat = _port_cfg(kmeans_iters=5), _port_cfg(kmeans_iters=5, n_clusters=j)
    gen = torch.Generator().manual_seed(j)
    s_pad = teng.make_swarm_state(model, cfg_pad.opt, clients, 3, device="cpu")
    s_nat = teng.copy_state(s_pad)
    row, meth = teng.grid_point(cfg_pad, N, k=j), teng.method_params("bso-sl", N)
    for _ in range(2):
        draws = teng.draw_round(gen, port_data.train_n, cfg_pad)
        s_pad, m_pad = teng.swarm_round(s_pad, port_data, cfg_pad, row, draws=draws)
        s_nat, m_nat = teng.swarm_round(s_nat, port_data, cfg_nat, meth,
                                        draws=_native_draws(draws, j))
        assert _equal_trees(s_pad.params, s_nat.params)
        assert _equal_trees(s_pad.opt_state, s_nat.opt_state)
        assert torch.equal(m_pad.assignments, m_nat.assignments)
        assert torch.equal(m_pad.centers[:j], m_nat.centers)
        assert (m_pad.centers[j:] == -1).all()
        assert torch.equal(m_pad.n_replaced, m_nat.n_replaced)
        assert torch.equal(m_pad.n_swapped, m_nat.n_swapped)
        assert torch.equal(m_pad.train_loss, m_nat.train_loss)


def test_default_grid_point_is_the_bso_sl_method_row(clients, model):
    """The empty spec is the paper point: run_grid_point({}) is bitwise
    run_method('bso-sl') from the same seed."""
    swarm = _swarm(rounds=1)
    acc_m, rm = baselines.run_method("bso-sl", model, clients, swarm, OPT, 9, batch_size=BATCH,
                                     device="cpu")
    acc_g, rg = baselines.run_grid_point({}, model, clients, swarm, OPT, 9, batch_size=BATCH,
                                         device="cpu")
    assert acc_m == acc_g
    _assert_runs_equal((rm.state, rm.metrics), (rg.state, rg.metrics), "default point")


@pytest.mark.parametrize("scheduled", [False, True])
def test_run_grid_rows_equal_run_grid_point(clients, model, port_data, scheduled):
    """Row g of run_grid is bitwise run_grid_point of its spec and seed
    under the same pads, with every row's steps masked or, with a
    schedule, each row computing only its own steps."""
    cfg = _port_cfg(kmeans_iters=5)
    specs = ([{"local_steps": 2}, {"local_steps": 1, "k": 2}] if scheduled
             else [{"k": 1}, {"k": 3, "p1": 0.0}])
    seeds = baselines.sweep_keys(11, specs)
    grid = teng.make_grid_config(cfg, N, specs)
    schedule = tuple(s["local_steps"] for s in specs) if scheduled else None
    finals, ms = teng.run_grid(teng.make_grid_state(model, cfg.opt, clients, seeds,
                                                    device="cpu"),
                               port_data, cfg, grid, 2, schedule)
    assert ms.assignments.shape == (len(specs), 2, N)
    for g, (spec, seed) in enumerate(zip(specs, seeds)):
        _, serial = baselines.run_grid_point(spec, model, clients, _swarm(), OPT, seed,
                                             cfg=cfg, data=port_data)
        _assert_runs_equal((finals[g], teng.RoundMetrics(*(t[g] for t in ms))),
                           (serial.state, serial.metrics), str(spec))


def test_run_grid_validates_states_and_schedule(clients, model, port_data):
    cfg = _port_cfg(kmeans_iters=2)
    grid = teng.make_grid_config(cfg, N, [{"local_steps": 1}, {}])
    states = teng.make_grid_state(model, cfg.opt, clients, [0, 1], device="cpu")
    for schedule, match in (((1, 3), "outside"), ((0, 2), "outside"), ((1,), "entries")):
        with pytest.raises(ValueError, match=match):
            teng.run_grid(states, port_data, cfg, grid, 1, schedule)
    with pytest.raises(ValueError, match="grid rows"):
        teng.run_grid(states[:1], port_data, cfg, grid, 1)
    # an entry below a row's local_steps cuts the row to that many steps:
    # from one seed, the 2-step row cut to 1 is the 1-step row, bitwise
    same = teng.make_grid_state(model, cfg.opt, clients, [4, 4], device="cpu")
    finals, ms = teng.run_grid(same, port_data, cfg, grid, 1, (1, 1))
    _assert_runs_equal((finals[0], teng.RoundMetrics(*(t[0] for t in ms))),
                       (finals[1], teng.RoundMetrics(*(t[1] for t in ms))), "cut row")


def test_run_grid_table_pads_rows_and_derives_the_schedule(clients, model, monkeypatch):
    """Rows are pinned to the caller's k and step count before the pads
    rise to the grid's maxima; heterogeneous local_steps give run_grid
    a schedule, uniform ones none; row g is run_grid_point of its spec
    with sweep_keys(seed, specs)[g] under the same pads; ``results``
    are ``{**spec, "acc"}`` in grid order."""
    calls = []
    run_grid = teng.run_grid

    def spy(states, data, cfg, grid, rounds, schedule=None):
        calls.append((cfg, grid, schedule, data))
        return run_grid(states, data, cfg, grid, rounds, schedule)

    monkeypatch.setattr(baselines, "run_grid", spy)
    swarm = _swarm(rounds=1, local_steps=1)
    specs = [{"k": 4, "local_steps": 2}, {}, {"p1": 1.0}]
    results, run = baselines.run_grid_table(model, clients, swarm, OPT, 7, specs=specs,
                                            batch_size=BATCH, device="cpu")
    cfg, grid, schedule, data = calls[-1]
    assert (cfg.n_clusters, cfg.local_steps) == (4, 2)
    assert grid.n_clusters.tolist() == [4, 3, 3] and grid.local_steps.tolist() == [2, 1, 1]
    assert schedule == (2, 1, 1)
    assert [{k: v for k, v in r.items() if k != "acc"} for r in results] == specs
    pinned = [{"k": 4, "local_steps": 2}, {"k": 3, "local_steps": 1},
              {"k": 3, "local_steps": 1, "p1": 1.0}]
    for g, (spec, seed) in enumerate(zip(pinned, baselines.sweep_keys(7, specs))):
        acc, serial = baselines.run_grid_point(spec, model, clients, swarm, OPT, seed,
                                               batch_size=BATCH, cfg=cfg, data=data)
        assert acc == results[g]["acc"] and 0.0 <= acc <= 1.0
        assert _equal_trees(run.state[g].params, serial.state.params), spec

    baselines.run_grid_table(model, clients, swarm, OPT, 7, axes={"k": (1, 2)},
                             batch_size=BATCH, device="cpu")
    assert calls[-1][2] is None
    with pytest.raises(ValueError, match="exactly one"):
        baselines.run_grid_table(model, clients, swarm, OPT, 7, batch_size=BATCH, device="cpu")


# ------------------------------------------- the coordinator's oracle


@pytest.fixture(scope="module")
def stacked():
    """Five clients' squeezenet-shaped trees, each leaf with its own mean
    and spread (test_torch_coordinator's fixture at N=5)."""
    init = jax_build_model(jax_get_config(ARCH)).init
    shapes = jax.eval_shape(jax.vmap(init), jax.random.split(jax.random.PRNGKey(0), 5))
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda s: (rng.normal(size=s.shape) * rng.uniform(0.01, 0.3)
                                   + rng.normal() * 0.05).astype(np.float32), shapes)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_distribution_matrix_loop_matches_reference_and_batched(stacked, use_pallas,
                                                                monkeypatch):
    """The per-client oracle against the reference's loop (its jnp stats
    and its Pallas kernel in interpret mode) and against the port's
    batched matrix: rtol 1e-5 / atol 1e-6, fp32 sums in another order.
    It makes one ``ops.param_stats_batched`` call a (client, leaf)."""
    expect = np.asarray(jds.swarm_distribution_matrix_loop(
        jax.tree.map(jnp.asarray, stacked), 5, use_pallas=use_pallas))
    calls = []
    one_leaf = ops.param_stats_batched

    def spy(x):
        calls.append(tuple(x.shape))
        return one_leaf(x)

    monkeypatch.setattr(ops, "param_stats_batched", spy)
    params = bridge.params_from_numpy(stacked)
    got = tds.swarm_distribution_matrix_loop(params, 5)
    n_leaves = len(tree_leaves(params))
    assert got.shape == expect.shape == (5, 2 * n_leaves)
    assert len(calls) == 5 * n_leaves and all(s[0] == 1 for s in calls)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), tds.swarm_distribution_matrix(params).numpy(),
                               rtol=1e-5, atol=1e-6)
