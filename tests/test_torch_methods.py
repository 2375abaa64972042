"""The port's Table-II method axis against the JAX reference on the CPU.

The centre piece is one whole ``swarm_round`` under each of the four
``method_params`` rows from a bridged reference state, with the
reference's randomness rebuilt from its key and injected as
``RoundDraws`` (own rows, pooled rows, k-means++ seeds, brain-storm
draws). Beside it: the rows themselves, the pooled index mapping on the
reference's draws, the sampler's coverage, the method rows against the
plain branches, ``run_sweep`` against ``run_rounds``, the centralized
host loop, ``eval_client``, the bridge and the Table-III loop over every
architecture.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.configs.base import SwarmConfig as JaxSwarmConfig  # noqa: E402
from repro.core.baselines import make_method_setup as jax_make_method_setup  # noqa: E402
from repro.core.baselines import train_centralized as jax_train_centralized  # noqa: E402
from repro.core.diststats import swarm_distribution_matrix as jax_feats  # noqa: E402
from repro.core.swarm import eval_client as jax_eval_client  # noqa: E402
from repro.data.dr import TABLE_I, make_dr_swarm_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.bso import BSODraws  # noqa: E402
from repro_torch.core.swarm import eval_client  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.cnn import CNN_ZOO  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.steps import make_eval_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves  # noqa: E402
from torch_parity import jax_bso_draws, jax_kmeans_init_idx, pin_torch_threads  # noqa: E402

pin_torch_threads()

SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)
N = TABLE_I.shape[1]
ARCH = "squeezenet-dr"
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 8
# adam's eps in the whole-round parity tests: 1e-6, for the reason
# given at test_torch_engine.ROUND_ADAM_EPS (at 1e-8 near-zero
# gradients turn fp32 rounding differences between XLA's and oneDNN's
# convolution sums into weight differences of up to ~lr)
ROUND_ADAM_EPS = 1e-6


@pytest.fixture(scope="module")
def clients():
    return make_dr_swarm_data(image_size=16, seed=0, table=SMALL_TABLE)


@pytest.fixture(scope="module")
def jax_setup(clients):
    model = jax_build_model(jax_get_config(ARCH))
    opt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=ROUND_ADAM_EPS))
    cfg = jeng.EngineConfig(model=model, opt=opt, local_steps=LOCAL_STEPS, batch_size=BATCH,
                            lr=LR, aggregation="bso", n_clusters=3, p1=0.9, p2=0.8,
                            kmeans_iters=20)
    return cfg, jeng.make_swarm_data(model.cfg, clients)


def _port_cfg(aggregation="bso", **kw):
    model = build_model(get_config(ARCH))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR, eps=ROUND_ADAM_EPS))
    base = dict(model=model, opt=opt, local_steps=LOCAL_STEPS, batch_size=BATCH, lr=LR,
                aggregation=aggregation, n_clusters=3, p1=0.9, p2=0.8, kmeans_iters=20)
    base.update(kw)
    return teng.EngineConfig(**base)


@pytest.fixture(scope="module")
def port_data(clients):
    return teng.make_swarm_data(build_model(get_config(ARCH)).cfg, clients, device="cpu")


# ------------------------------------------------------------ method rows


def test_method_rows_and_sweep_config_are_the_references():
    for m in teng.SWEEP_METHODS:
        got = bridge.method_params_to_numpy(teng.method_params(m, N))
        expect = jeng.method_params(m, N)._asdict()
        for f in teng.MethodParams._fields:
            np.testing.assert_array_equal(got[f], np.asarray(expect[f]), err_msg=f"{m} {f}")
            assert got[f].dtype == np.asarray(expect[f]).dtype, (m, f)
    got = bridge.method_params_to_numpy(teng.make_sweep_config(N))
    expect = jeng.make_sweep_config(N)._asdict()
    for f in teng.MethodParams._fields:
        np.testing.assert_array_equal(got[f], np.asarray(expect[f]), err_msg=f)
    assert teng.SWEEP_METHODS == jeng.SWEEP_METHODS
    with pytest.raises(ValueError, match="unknown method"):
        teng.method_params("gossip", N)


def test_bridge_round_trips_method_rows_and_sweep_states(clients, jax_setup):
    cfg, _ = jax_setup
    sweep = bridge.method_params_from_numpy(jax.tree.map(np.asarray,
                                                         jeng.make_sweep_config(N)._asdict()))
    for a, b in zip(sweep, teng.make_sweep_config(N)):
        assert torch.equal(a, b)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jstates = jax.jit(lambda ks: jeng.make_sweep_state(cfg.model, cfg.opt, clients, ks))(keys)
    jnp_state = jax.tree.map(np.asarray, jstates._asdict())
    states = bridge.sweep_state_from_numpy(jnp_state, seeds=[3, 4])
    assert len(states) == 2 and [s.generator.initial_seed() for s in states] == [3, 4]
    back = bridge.sweep_state_to_numpy(states)
    for name in ("params", "opt_state"):
        for (p, a), (_, b) in zip(tree_paths_and_leaves(back[name]),
                                  tree_paths_and_leaves(jnp_state[name])):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}/{p}")
    np.testing.assert_array_equal(back["n_samples"], jnp_state["n_samples"])
    np.testing.assert_array_equal(back["round"], jnp_state["round"])


# -------------------------------------------------------- pooled sampling


def _reference_step_draws(kt, train_n, batch):
    """The two draws the reference's ``_swarm_batch_indices`` takes from
    one step key: own rows and pooled global rows."""
    train_n = jnp.asarray(train_n)
    own = jax.random.randint(kt, (train_n.shape[0], batch), 0, train_n[:, None])
    g = jax.random.randint(jax.random.fold_in(kt, 1), (train_n.shape[0], batch), 0,
                           jnp.cumsum(train_n)[-1])
    return np.array(own), np.array(g)


@pytest.mark.parametrize("pool", [True, False])
def test_pooled_index_mapping_matches_reference_on_its_draws(pool):
    sizes = np.array([5, 3, 1, 7, 2], np.int32)
    for s in range(10):
        key = jax.random.PRNGKey(s)
        jc, jr = jeng._swarm_batch_indices(key, jnp.asarray(sizes), 6, jnp.asarray(pool))
        own, g = _reference_step_draws(key, sizes, 6)
        tc, tr = teng.swarm_batch_indices(torch.from_numpy(sizes.astype(np.int64)),
                                          torch.from_numpy(own), torch.from_numpy(g),
                                          torch.tensor(pool))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _labelled_stack(sizes):
    """A train stack whose labels are global row ids (pads are -1)."""
    n_max = max(sizes)
    labels = np.full((len(sizes), n_max), -1, np.int64)
    gid = 0
    for i, n in enumerate(sizes):
        labels[i, :n] = np.arange(gid, gid + n)
        gid += n
    train = {"images": torch.zeros((len(sizes), n_max, 2, 2, 3)),
             "labels": torch.from_numpy(labels)}
    return train, torch.tensor(sizes, dtype=torch.int64)


def test_pooled_sampler_covers_global_rows_and_no_pads():
    """Every global row is reachable from every client slot, pad rows
    never are (port of tests/test_sweep.py's coverage test)."""
    sizes = [5, 3, 2]
    train, train_n = _labelled_stack(sizes)
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in sizes]
    for _ in range(200):
        own = teng.draw_batch_idx(gen, train_n, 4)
        g = teng.draw_pool_idx(gen, train_n, 4)
        got = teng.sample_swarm_batch(train, train_n, own, g, torch.tensor(True))["labels"]
        assert got.min() >= 0, "pooled sampler drew a pad row"
        for i in range(len(sizes)):
            seen[i].update(got[i].tolist())
    assert all(s == set(range(sum(sizes))) for s in seen)


def test_unpooled_sampler_matches_sample_local_batch():
    sizes = [6, 2, 4]
    train, train_n = _labelled_stack(sizes)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        own = teng.draw_batch_idx(gen, train_n, 5)
        g = teng.draw_pool_idx(gen, train_n, 5)
        a = teng.sample_swarm_batch(train, train_n, own, g, torch.tensor(False))
        b = teng.sample_local_batch(train, own)
        assert torch.equal(a["labels"], b["labels"]) and torch.equal(a["images"], b["images"])


# --------------------------------------------- whole rounds vs the reference


@pytest.fixture(scope="module")
def jax_state0(clients, jax_setup):
    cfg, _ = jax_setup
    state = jax.jit(lambda k: jeng.make_swarm_state(cfg.model, cfg.opt, clients, k))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def reference_method_rounds(clients, jax_setup, jax_state0):
    """Each method row's reference round from key 0 and its draws,
    rebuilt from the round's key as swarm_round derives them."""
    jcfg, jdata = jax_setup
    _, k_local, k_kmeans, k_bso = jax.random.split(jnp.asarray(jax_state0.key), 4)
    sample_keys = jax.random.split(k_local, LOCAL_STEPS)
    own, g = zip(*(_reference_step_draws(kt, jdata.train_n, BATCH) for kt in sample_keys))
    step = jax_make_train_step(jcfg.model, jcfg.opt)

    @jax.jit
    def feats_of(s, pool):
        params = jeng.local_phase(step, s.params, s.opt_state, LR, sample_keys,
                                  lambda kt: jeng.sample_round_batch(kt, jdata, BATCH, pool))[0]
        return jax_feats(params)

    out = {}
    for m in jeng.SWEEP_METHODS:
        jm = jeng.method_params(m, N)
        jstate = jax.tree.map(jnp.asarray, jax_state0)
        feats = feats_of(jstate, jm.pool_data)
        draws = teng.RoundDraws(
            batch_idx=torch.from_numpy(np.stack(own)),
            kmeans_init_idx=torch.from_numpy(jax_kmeans_init_idx(k_kmeans, feats, 3)),
            bso=BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(k_bso, 3, N))),
            pool_idx=torch.from_numpy(np.stack(g)))
        jnew, jmet = jeng.jit_swarm_round(jax.tree.map(jnp.asarray, jax_state0), jdata, jcfg,
                                          jm)
        out[m] = (draws, jax.tree.map(np.asarray, jnew.params), jax.tree.map(np.asarray, jmet))
    return out


@pytest.mark.parametrize("method", teng.SWEEP_METHODS)
def test_whole_method_round_matches_reference(method, jax_state0, port_data,
                                              reference_method_rounds):
    """Assignments, centers and event counts equal; params within atol
    1e-4 (5% of one adam step at lr 2e-3, as in test_torch_engine) and
    val accuracy within 1e-6."""
    draws, jparams, jm = reference_method_rounds[method]
    tstate = bridge.state_from_numpy(jax_state0._asdict(), "cpu")
    tnew, tm = teng.swarm_round(tstate, port_data, _port_cfg(),
                                teng.method_params(method, N), draws=draws)
    np.testing.assert_array_equal(tm.assignments.numpy(), jm.assignments)
    np.testing.assert_array_equal(tm.centers.numpy(), jm.centers)
    assert (int(tm.n_replaced), int(tm.n_swapped)) == (int(jm.n_replaced), int(jm.n_swapped))
    np.testing.assert_allclose(tm.val_acc.numpy(), jm.val_acc, atol=1e-6)
    np.testing.assert_allclose(float(tm.train_loss), float(jm.train_loss), rtol=1e-4)
    for (path, a), (_, b) in zip(tree_paths_and_leaves(bridge.params_to_numpy(tnew.params)),
                                 tree_paths_and_leaves(jparams)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"{method} {path}")


# ---------------------------------------------------- port-side contracts


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("method,aggregation", [("local", "none"), ("fedavg", "fedavg"),
                                                ("bso-sl", "bso")])
def test_method_rows_equal_plain_branches_over_two_rounds(clients, port_data, method,
                                                          aggregation):
    """From one seed, a method row and the plain branch it stands for
    draw the same random stream (every round takes all its draws first,
    in one order) and give bitwise the same params and accuracies."""
    model = build_model(get_config(ARCH))
    cfg = _port_cfg(local_steps=1, kmeans_iters=5)
    s1 = teng.make_swarm_state(model, cfg.opt, clients, 7, device="cpu")
    s1, m1 = teng.run_rounds(s1, port_data, cfg, 2, teng.method_params(method, N))
    s2 = teng.make_swarm_state(model, cfg.opt, clients, 7, device="cpu")
    s2, m2 = teng.run_rounds(s2, port_data, _port_cfg(aggregation, local_steps=1,
                                                      kmeans_iters=5), 2)
    assert _params_equal(s1.params, s2.params), method
    assert torch.equal(m1.mean_val_acc, m2.mean_val_acc)
    if method == "bso-sl":
        assert torch.equal(m1.assignments, m2.assignments)
        assert torch.equal(m1.centers, m2.centers)


def test_run_sweep_rows_equal_run_rounds(clients, port_data):
    model = build_model(get_config(ARCH))
    cfg = _port_cfg(local_steps=1, kmeans_iters=5)
    seeds = baselines.sweep_keys(42)
    assert len(set(seeds)) == 4 and seeds == baselines.sweep_keys(42)
    sweep = teng.make_sweep_config(N)
    finals, ms = teng.run_sweep(teng.make_sweep_state(model, cfg.opt, clients, seeds,
                                                      device="cpu"),
                                port_data, cfg, sweep, 2)
    assert ms.mean_val_acc.shape == (4, 2) and ms.assignments.shape == (4, 2, N)
    for m, seed in enumerate(seeds):
        state = teng.make_swarm_state(model, cfg.opt, clients, seed, device="cpu")
        state, mm = teng.run_rounds(state, port_data, cfg, 2, teng.sweep_row(sweep, m))
        assert _params_equal(finals[m].params, state.params), m
        for a, b in zip(ms, mm):
            assert torch.equal(a[m], b), m
    with pytest.raises(ValueError, match="sweep rows"):
        teng.run_sweep(finals[:2], port_data, cfg, sweep, 1)


def test_sweep_table_rows_equal_run_method(clients):
    model = build_model(get_config(ARCH))
    swarm = SwarmConfig(n_clients=N, n_clusters=3, rounds=1, local_steps=1, kmeans_iters=5)
    opt = OptimizerConfig(name="adam", lr=LR)
    cfg, data = baselines.make_method_setup(model, clients, swarm, opt, batch_size=BATCH,
                                            device="cpu")
    accs, run = baselines.run_sweep_table(model, clients, swarm, opt, 5, batch_size=BATCH,
                                          cfg=cfg, data=data)
    assert set(accs) == set(teng.SWEEP_METHODS)
    for m, (method, seed) in enumerate(zip(teng.SWEEP_METHODS, baselines.sweep_keys(5))):
        acc, serial = baselines.run_method(method, model, clients, swarm, opt, seed,
                                           batch_size=BATCH, cfg=cfg, data=data)
        assert acc == accs[method] and 0.0 <= acc <= 1.0
        assert _params_equal(run.state[m].params, serial.state.params), method


@pytest.mark.parametrize("method", [None, "fedavg"])
def test_reset_opt_each_round_restarts_the_optimizer(clients, port_data, method):
    """With ``reset_opt_each_round`` the round ends on a fresh optimizer
    state for the aggregated params (plain branch and method row); off,
    adam's moments and step carry over."""
    model = build_model(get_config(ARCH))
    row = None if method is None else teng.method_params(method, N)
    for reset in (True, False):
        cfg = _port_cfg(local_steps=1, kmeans_iters=3, reset_opt_each_round=reset)
        state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
        new, _ = teng.swarm_round(state, port_data, cfg, row)
        fresh = teng.init_opt_state(cfg.opt, new.params)
        same = [torch.equal(a, b) for a, b in zip(tree_leaves(new.opt_state),
                                                  tree_leaves(fresh))]
        assert all(same) if reset else not any(same), (method, reset)


def test_bucketed_layout_setup_matches_the_reference(clients, jax_setup):
    """make_method_setup(layout="bucketed") builds the reference's
    bucketed layout: the same buckets, stacks and sampling bounds."""
    model = build_model(get_config(ARCH))
    jcfg, _ = jax_setup
    _, expect = jax_make_method_setup(jcfg.model, clients, JaxSwarmConfig(local_steps=1),
                                      JaxOptimizerConfig(), layout="bucketed")
    _, got = baselines.make_method_setup(model, clients, SwarmConfig(local_steps=1),
                                         OptimizerConfig(), layout="bucketed", device="cpu")
    assert isinstance(got, teng.BucketedSwarmData) and got.client_ids == expect.client_ids
    np.testing.assert_array_equal(got.train_n.numpy(), np.asarray(expect.train_n))
    for tt, jt, tv, jv in zip(got.train, expect.train, got.val, expect.val):
        for k in ("images", "labels"):
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))


def test_eval_client_matches_reference(clients, jax_state0):
    jmodel = jax_build_model(jax_get_config(ARCH))
    params0 = jax.tree.map(lambda x: x[0], jax_state0.params)
    X, y = clients[0]["test"]
    expect = jax_eval_client(jax.jit(jax_make_eval_step(jmodel)), jmodel.cfg,
                             jax.tree.map(jnp.asarray, params0), X, y, batch=16)
    model = build_model(get_config(ARCH))
    got = eval_client(make_eval_step(model), model.cfg, bridge.params_from_numpy(params0), X, y,
                      batch=16)
    assert abs(got - expect) <= 1e-6


def test_train_centralized_matches_reference(clients):
    """Five sgd steps on the pooled data from the reference's initial
    params and its numpy index stream: params within 1e-5 (fp32
    convolutions summed in another order over five steps at lr 0.05),
    the Eq. 3 accuracy within 1e-6."""
    key = jax.random.PRNGKey(3)
    jmodel = jax_build_model(jax_get_config(ARCH))
    jparams, jacc = jax_train_centralized(jmodel, clients, JaxOptimizerConfig(name="sgd",
                                                                                lr=0.05),
                                          key, steps=5, batch_size=8)
    init = bridge.params_from_numpy(jax.tree.map(np.asarray, jmodel.init(key)))
    params, acc = baselines.train_centralized(build_model(get_config(ARCH)), clients,
                                              OptimizerConfig(name="sgd", lr=0.05), 0,
                                              steps=5, batch_size=8, init_params=init,
                                              device="cpu")
    for (path, a), (_, b) in zip(tree_paths_and_leaves(bridge.params_to_numpy(params)),
                                 tree_paths_and_leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=path)
    assert abs(acc - jacc) <= 1e-6


@pytest.mark.parametrize("arch", sorted(CNN_ZOO))
def test_run_method_bso_sl_for_every_architecture(arch):
    """The Table-III loop: BSO-SL through ``run_method`` for each of the
    four CNNs, sharing one dataset, at a tiny size."""
    clients = make_dr_swarm_data(image_size=16, seed=1, table=SMALL_TABLE)
    model = build_model(get_config(arch))
    swarm = SwarmConfig(n_clients=N, n_clusters=3, rounds=1, local_steps=1, kmeans_iters=3)
    acc, run = baselines.run_method("bso-sl", model, clients, swarm,
                                    OptimizerConfig(name="adam", lr=LR), 0, batch_size=4,
                                    device="cpu")
    assert 0.0 <= acc <= 1.0
    assert torch.isfinite(run.metrics.train_loss).all()
    assert run.metrics.assignments.shape == (1, N) and run.state.round == 1
