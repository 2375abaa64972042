"""The port's round engine and trainer against the JAX reference.

The centre piece is one whole ``swarm_round`` of squeezenet-dr from a
bridged reference state, with the reference's randomness rebuilt from
its key and injected as ``RoundDraws``: the same batches, the same
k-means++ seeds and the same brain-storm draws.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.diststats import swarm_distribution_matrix as jax_feats  # noqa: E402
from repro.data.dr import TABLE_I, make_dr_swarm_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy, state_from_numpy  # noqa: E402
from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.bso import BSODraws  # noqa: E402
from repro_torch.core.swarm import SwarmTrainer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves  # noqa: E402
from torch_parity import jax_bso_draws, jax_kmeans_init_idx, pin_torch_threads  # noqa: E402

pin_torch_threads()

SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)
ARCH = "squeezenet-dr"
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 8
# adam's eps in the whole-round parity test, raised from the default
# 1e-8. With eps=1e-8 a weight whose gradient is ~1e-9 (a nearly dead
# unit) moves by lr*g/(|g|+eps), so the ~10% relative rounding
# difference of such a gradient between XLA's and oneDNN's convolution
# sums becomes a 1e-5..1e-3 difference in the weight, and ReLUs near
# zero carry it on in the next step. At 1e-6 the update of such a
# weight is ~lr*1e-3 and the comparison measures the port, not adam's
# conditioning. Per-step adam at eps=1e-8 is held in test_torch_optim.
ROUND_ADAM_EPS = 1e-6


@pytest.fixture(scope="module")
def clients():
    return make_dr_swarm_data(image_size=16, seed=0, table=SMALL_TABLE)


@pytest.fixture(scope="module")
def jax_setup(clients):
    model = jax_build_model(jax_get_config(ARCH))
    opt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=ROUND_ADAM_EPS))
    cfg = jeng.EngineConfig(model=model, opt=opt, local_steps=LOCAL_STEPS,
                            batch_size=BATCH, lr=LR, aggregation="bso", n_clusters=3,
                            p1=0.9, p2=0.8, kmeans_iters=20)
    return cfg, jeng.make_swarm_data(model.cfg, clients)


def _port_cfg(aggregation="bso", **kw):
    model = build_model(get_config(ARCH))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR, eps=ROUND_ADAM_EPS))
    base = dict(model=model, opt=opt, local_steps=LOCAL_STEPS, batch_size=BATCH, lr=LR,
                aggregation=aggregation, n_clusters=3, p1=0.9, p2=0.8, kmeans_iters=20)
    base.update(kw)
    return teng.EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_state0(clients, jax_setup):
    """The reference's fresh swarm state from key 0, as numpy arrays
    (its ``make_swarm_state`` jitted: eager it takes ~20 s on the CPU)."""
    cfg, _ = jax_setup
    state = jax.jit(lambda k: jeng.make_swarm_state(cfg.model, cfg.opt, clients, k))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state)


def test_swarm_data_matches_reference(clients, jax_setup):
    _, jdata = jax_setup
    cfg = build_model(get_config(ARCH)).cfg
    tdata = teng.make_swarm_data(cfg, clients, device="cpu")
    for k in ("images", "labels"):
        np.testing.assert_array_equal(tdata.train[k].numpy(), np.asarray(jdata.train[k]))
        np.testing.assert_array_equal(tdata.val[k].numpy(), np.asarray(jdata.val[k]))
    np.testing.assert_array_equal(tdata.train_n.numpy(), np.asarray(jdata.train_n))


def test_sample_local_batch_gathers_reference_rows(clients, jax_setup):
    """The same row ids give bitwise the reference's per-client batch."""
    _, jdata = jax_setup
    key = jax.random.PRNGKey(3)
    N = jdata.train_n.shape[0]
    idx = np.array(jax.random.randint(key, (N, BATCH), 0, jdata.train_n[:, None]))
    jb = jeng.sample_local_batch(key, jdata.train, jdata.train_n, BATCH)
    tdata = teng.make_swarm_data(build_model(get_config(ARCH)).cfg, clients, device="cpu")
    tb = teng.sample_local_batch(tdata.train, torch.from_numpy(idx))
    for k in ("images", "labels"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_drawn_batch_idx_stays_below_train_n():
    gen = torch.Generator().manual_seed(0)
    train_n = torch.tensor([1, 2, 5, 700])
    idx = teng.draw_batch_idx(gen, train_n, 4096)
    assert idx.shape == (4, 4096)
    assert (idx >= 0).all() and (idx < train_n[:, None]).all()
    assert (idx[3].unique().numel() > 600)          # spread over the whole client


def test_eval_swarm_matches_reference(clients, jax_setup, jax_state0):
    """Per-client masked val accuracy on bridged params. Accuracy is a
    ratio of argmax hits, so it agrees exactly unless a logit tie flips
    (none at this seed)."""
    jcfg, jdata = jax_setup
    expect = np.asarray(jax.jit(jeng.make_client_eval(jcfg.model))(
        jax.tree.map(jnp.asarray, jax_state0.params), jdata.val))
    tparams = params_from_numpy(jax_state0.params)
    tdata = teng.make_swarm_data(build_model(get_config(ARCH)).cfg, clients, device="cpu")
    got = teng.eval_swarm(build_model(get_config(ARCH)), tparams, tdata)
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=1e-6)


def test_whole_swarm_round_matches_reference(clients, jax_setup, jax_state0):
    """One BSO-SL round from the same state and the same draws.

    Assignments, centers and event counts must be equal. Params within
    atol 1e-4: an adam step moves a weight by about lr = 2e-3, so 1e-4
    is 5% of one step, room for fp32 convolutions summed in another
    order over two local steps."""
    jcfg, jdata = jax_setup
    N = len(clients)
    # fresh device buffers: the reference round donates its state
    jstate = jax.tree.map(jnp.asarray, jax_state0)

    # the round's randomness, derived from the key as swarm_round does
    _, k_local, k_kmeans, k_bso = jax.random.split(jstate.key, 4)
    sample_keys = jax.random.split(k_local, LOCAL_STEPS)
    batch_idx = np.stack([np.asarray(jax.random.randint(kt, (N, BATCH), 0,
                                                        jdata.train_n[:, None]))
                          for kt in sample_keys])
    step = jax_make_train_step(jcfg.model, jcfg.opt)
    feats = jax.jit(lambda s: jax_feats(jeng.local_phase(
        step, s.params, s.opt_state, LR, sample_keys,
        lambda kt: jeng.sample_round_batch(kt, jdata, BATCH))[0]))(jstate)
    init_idx = jax_kmeans_init_idx(k_kmeans, feats, 3)
    draws = teng.RoundDraws(
        batch_idx=torch.from_numpy(batch_idx), kmeans_init_idx=torch.from_numpy(init_idx),
        bso=BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(k_bso, 3, N))))

    jnew, jm = jeng.jit_swarm_round(jstate, jdata, jcfg)

    tstate = state_from_numpy(jax_state0._asdict(), "cpu")
    tdata = teng.make_swarm_data(build_model(get_config(ARCH)).cfg, clients, device="cpu")
    tnew, tm = teng.swarm_round(tstate, tdata, _port_cfg(), draws=draws)

    np.testing.assert_array_equal(tm.assignments.numpy(), np.asarray(jm.assignments))
    np.testing.assert_array_equal(tm.centers.numpy(), np.asarray(jm.centers))
    assert int(tm.n_replaced) == int(jm.n_replaced)
    assert int(tm.n_swapped) == int(jm.n_swapped)
    np.testing.assert_allclose(tm.val_acc.numpy(), np.asarray(jm.val_acc), atol=1e-6)
    np.testing.assert_allclose(float(tm.train_loss), float(jm.train_loss), rtol=1e-4)
    jp = jax.tree.map(np.asarray, jnew.params)
    tp = params_to_numpy(tnew.params)
    for (path, a), (_, b) in zip(tree_paths_and_leaves(tp), tree_paths_and_leaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=path)
    np.testing.assert_array_equal(tnew.opt_state["step"].numpy(),
                                  np.asarray(jnew.opt_state["step"]))
    assert tnew.round == int(jnew.round) == 1


@pytest.mark.parametrize("aggregation", ["fedavg", "none"])
def test_round_aggregation_modes(clients, aggregation):
    """fedavg leaves every client on one global model; none leaves each
    client on its own; both skip the coordinator."""
    model = build_model(get_config(ARCH))
    cfg = _port_cfg(aggregation)
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    data = teng.make_swarm_data(model.cfg, clients, device="cpu")
    new, m = teng.swarm_round(state, data, cfg)
    w = new.params["conv1"]["w"]
    same = [torch.allclose(w[0], w[i], atol=1e-6) for i in range(1, len(clients))]
    assert all(same) if aggregation == "fedavg" else not any(same)
    assert int(m.n_replaced) == int(m.n_swapped) == 0


def test_run_rounds_stacks_metrics_and_consumes_generator(clients):
    model = build_model(get_config(ARCH))
    cfg = _port_cfg()
    data = teng.make_swarm_data(model.cfg, clients, device="cpu")
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    twin = teng.copy_state(state)
    new, ms = teng.run_rounds(state, data, cfg, 2)
    assert new.round == 2
    assert ms.assignments.shape == (2, len(clients)) and ms.centers.shape == (2, 3)
    assert ms.val_acc.shape == (2, len(clients))
    assert torch.isfinite(ms.train_loss).all()
    assert ((ms.assignments >= 0) & (ms.assignments < 3)).all()
    # the same seed replays the same two rounds
    new2, ms2 = teng.run_rounds(twin, data, cfg, 2)
    assert torch.equal(ms.assignments, ms2.assignments)
    for a, b in zip(tree_leaves(new.params), tree_leaves(new2.params)):
        assert torch.equal(a, b)


def test_trainer_round_fit_and_scores_on_cpu(clients):
    tr = SwarmTrainer(build_model(get_config(ARCH)), clients,
                      SwarmConfig(local_steps=1, rounds=2), OptimizerConfig(name="adam", lr=LR),
                      seed=0, batch_size=BATCH, device="cpu")
    hist = tr.fit()
    assert [h.round for h in hist] == [0, 1]
    assert all(np.isfinite(h.train_loss) for h in hist)
    scores = tr.client_scores("test")
    assert scores.shape == (len(clients),) and ((scores >= 0) & (scores <= 1)).all()
    assert 0.0 <= tr.mean_accuracy("test") <= 1.0


def test_trainer_without_device_raises_where_cuda_is_absent(clients, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SwarmTrainer(build_model(get_config(ARCH)), clients, SwarmConfig(local_steps=1),
                     OptimizerConfig(name="adam", lr=LR))


def test_fit_scanned_appends_fits_history_bitwise(clients):
    """``SwarmTrainer.fit_scanned`` runs ``fit``'s rounds through
    ``engine.run_rounds``: from one seed, the same history (round ids,
    accuracies, assignments, centers, events, losses) and params,
    bitwise; a second call continues the round count."""
    def trainer():
        return SwarmTrainer(build_model(get_config(ARCH)), clients,
                            SwarmConfig(local_steps=1, rounds=1),
                            OptimizerConfig(name="adam", lr=LR), seed=0, batch_size=BATCH,
                            device="cpu")
    a, b = trainer(), trainer()
    ha, hb = a.fit(), b.fit_scanned()
    assert len(ha) == len(hb) == 1
    for x, y in zip(ha, hb):
        assert (x.round, x.mean_val_acc, x.events, x.train_loss) == \
            (y.round, y.mean_val_acc, y.events, y.train_loss)
        assert np.array_equal(x.assignments, y.assignments)
        assert np.array_equal(x.centers, y.centers)
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(p, q)
    assert [h.round for h in b.fit_scanned(1)] == [0, 1]
