"""The port's ragged (bucketed) layout against the JAX reference and
against its own rectangular layout, on the CPU.

``bucket_clients`` and the layout (stacks, client ids, ``pad_fraction``)
are held against the reference's; the bucketed sampler, eval,
``run_rounds`` and pooled centralized row against the rectangular
layout, bitwise (the CPU's convolutions do not depend on the number of
clients a call carries); the edge cases of tests/test_bucket.py; and
K1's plain version over each bucket stack against the reference's
oracle. Sizes are tests/test_bucket.py's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.dr import TABLE_I, make_dr_swarm_data  # noqa: E402
from repro.data.dr import bucket_clients as jax_bucket_clients  # noqa: E402
from repro.kernels.ref import ref_param_stats_batched  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data.dr import bucket_clients  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.steps import make_eval_step  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)
N = TABLE_I.shape[1]
ARCH = "squeezenet-dr"
OPT = OptimizerConfig(name="adam", lr=2e-3)


def _cfg(model, **kw):
    kw.setdefault("local_steps", 2)
    kw.setdefault("kmeans_iters", 5)
    return teng.EngineConfig(model=model, opt=make_optimizer(OPT), batch_size=4, lr=2e-3,
                             aggregation="bso", n_clusters=3, **kw)


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _assert_runs_equal(a, b, what):
    (sa, ma), (sb, mb) = a, b
    assert _equal_trees(sa.params, sb.params), f"{what}: params"
    assert _equal_trees(sa.opt_state, sb.opt_state), f"{what}: optimizer state"
    for f, x, y in zip(teng.RoundMetrics._fields, ma, mb):
        assert torch.equal(x, y), f"{what}: {f}"


@pytest.fixture(scope="module")
def clients():
    return make_dr_swarm_data(image_size=8, seed=0, table=SMALL_TABLE)


@pytest.fixture(scope="module")
def model():
    return build_model(get_config(ARCH))


@pytest.fixture(scope="module")
def rect(model, clients):
    return teng.make_swarm_data(model.cfg, clients, device="cpu")


@pytest.fixture(scope="module")
def buck(model, clients):
    return teng.make_bucketed_swarm_data(model.cfg, clients, device="cpu")


def _random_params(model, n, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree_stack([model.init(gen) for _ in range(n)])


# ---------------------------------------------------- bucketing, layout


TABLE_I_TRAIN = [int(round(0.8 * n)) for n in TABLE_I.sum(axis=0)]


@pytest.mark.parametrize("sizes,max_buckets,strategy", [
    (TABLE_I_TRAIN, 4, "pow2"), (TABLE_I_TRAIN, 2, "pow2"), (TABLE_I_TRAIN, 1, "pow2"),
    (TABLE_I_TRAIN, 4, "quantile"), (TABLE_I_TRAIN, 20, "quantile"),
    ([8, 9, 16], 4, "pow2"), ([8, 9, 16, 17, 32, 33, 1], 3, "pow2"), ([5], 4, "pow2"),
    ([0, 1, 2, 3, 4], 4, "pow2"), ([7, 7, 7], 2, "quantile")])
def test_bucket_clients_is_the_references(sizes, max_buckets, strategy):
    """The same groups, bitwise, on Table I's train sizes and the
    boundary cases of tests/test_bucket.py; an exact power of two is its
    own ceiling."""
    got = bucket_clients(sizes, max_buckets=max_buckets, strategy=strategy)
    expect = jax_bucket_clients(sizes, max_buckets=max_buckets, strategy=strategy)
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    if sizes == [8, 9, 16]:
        assert [set(g.tolist()) for g in got] == [{0}, {1, 2}]


@pytest.mark.parametrize("bad", [dict(sizes=[]), dict(sizes=[[1, 2]]),
                                 dict(sizes=[3], max_buckets=0),
                                 dict(sizes=[3], strategy="even")])
def test_bucket_clients_refuses_with_the_references_messages(bad):
    with pytest.raises(ValueError) as expect:
        jax_bucket_clients(**bad)
    with pytest.raises(ValueError) as got:
        bucket_clients(**bad)
    assert str(got.value) == str(expect.value)


@pytest.mark.parametrize("eval_batch", [64, 4])
def test_bucketed_layout_is_the_references(model, clients, eval_batch):
    """Client ids, every bucket's train and eval stack and train_n equal
    the reference's; the ids partition range(N); each bucket is padded
    to its own largest client; pad_fraction equals the reference's, for
    both layouts."""
    jcfg = jax_build_model(jax_get_config(ARCH)).cfg
    jb = jeng.make_bucketed_swarm_data(jcfg, clients, eval_batch=eval_batch)
    tb = teng.make_bucketed_swarm_data(model.cfg, clients, eval_batch=eval_batch, device="cpu")
    assert tb.client_ids == jb.client_ids and tb.n_buckets == jb.n_buckets
    assert sorted(i for ids in tb.client_ids for i in ids) == list(range(N))
    np.testing.assert_array_equal(tb.train_n.numpy(), np.asarray(jb.train_n))
    for ids, tt, jt, tv, jv in zip(tb.client_ids, tb.train, jb.train, tb.val, jb.val):
        for k in ("images", "labels"):
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
            np.testing.assert_array_equal(tv[k].numpy(), np.asarray(jv[k]))
        assert tt["labels"].shape[:2] == (len(ids), int(tb.train_n[list(ids)].max()))
    jr = jeng.make_swarm_data(jcfg, clients, eval_batch=eval_batch)
    tr = teng.make_swarm_data(model.cfg, clients, eval_batch=eval_batch, device="cpu")
    assert teng.pad_fraction(tb) == jeng.pad_fraction(jb)
    assert teng.pad_fraction(tr) == jeng.pad_fraction(jr)
    # the acceptance floor of tests/test_bucket.py: the train pad drops >= 2x
    assert teng.pad_fraction(tr)["train"] >= 2.0 * teng.pad_fraction(tb)["train"]


# -------------------------------------------------- bitwise against rect


def test_sample_round_batch_layout_bitwise(rect, buck):
    """Per-step batches equal the rectangular ones bitwise: the plain
    path, a method row that samples its own rows and the pooled row; no
    pad row is drawn."""
    gen = torch.Generator().manual_seed(100)
    for _ in range(3):
        own = teng.draw_batch_idx(gen, rect.train_n, 16)
        pool_idx = teng.draw_pool_idx(gen, rect.train_n, 16)
        for pool in (None, torch.tensor(False), torch.tensor(True)):
            b_r = teng.sample_round_batch(rect, own, pool_idx, pool)
            b_b = teng.sample_round_batch(buck, own, pool_idx, pool)
            for k in ("images", "labels"):
                assert torch.equal(b_r[k], b_b[k]), (pool, k)
            assert (b_b["labels"] >= 0).all()


def test_eval_swarm_layout_bitwise(model, rect, buck):
    params = _random_params(model, N, 2)
    assert torch.equal(teng.eval_swarm(model, params, rect), teng.eval_swarm(model, params, buck))


def test_bucketed_run_rounds_bitwise_rect(model, clients, rect, buck):
    """Two bso rounds from one state: every metric, params and optimizer
    state bitwise the rectangular run."""
    cfg = _cfg(model)
    s0 = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    _assert_runs_equal(teng.run_rounds(teng.copy_state(s0), rect, cfg, 2),
                       teng.run_rounds(teng.copy_state(s0), buck, cfg, 2), "bso")


def test_bucketed_centralized_row_bitwise_rect(model, clients, rect):
    """The pooled centralized row through run_method on
    make_method_setup(layout="bucketed"): one round, bitwise the
    rectangular row; a churn row (dropout 0.3) on both layouts too."""
    swarm = SwarmConfig(n_clients=N, n_clusters=3, rounds=1, local_steps=2, kmeans_iters=5)
    cfg_b, data_b = baselines.make_method_setup(model, clients, swarm, OPT, batch_size=4,
                                                layout="bucketed", device="cpu")
    assert isinstance(data_b, teng.BucketedSwarmData)
    acc_b, run_b = baselines.run_method("centralized", model, clients, swarm, OPT, 1,
                                        batch_size=4, cfg=cfg_b, data=data_b)
    acc_r, run_r = baselines.run_method("centralized", model, clients, swarm, OPT, 1,
                                        batch_size=4, cfg=cfg_b, data=rect)
    assert acc_b == acc_r
    _assert_runs_equal((run_b.state, run_b.metrics), (run_r.state, run_r.metrics), "centralized")
    row = teng.grid_point(cfg_b, N, dropout=0.3, stale_decay=0.5)
    s0 = teng.make_swarm_state(model, cfg_b.opt, clients, 2, device="cpu")
    _assert_runs_equal(teng.run_rounds(teng.copy_state(s0), rect, cfg_b, 2, row),
                       teng.run_rounds(teng.copy_state(s0), data_b, cfg_b, 2, row), "churn")
    with pytest.raises(ValueError, match="unknown layout"):
        baselines.make_method_setup(model, clients, swarm, OPT, layout="ragged", device="cpu")


# ----------------------------------------------------------- edge cases


def test_client_smaller_than_one_eval_microbatch(model):
    """A client with fewer rows than the eval microbatch pads to one
    batch with a label -1 tail, and its accuracy is the direct per-row
    accuracy over its real rows alone (within 1e-6: a ratio of the same
    hits, summed in another order)."""
    clients = make_dr_swarm_data(image_size=8, seed=0, table=SMALL_TABLE[:, :3])
    stacked = teng.stack_eval_split(model.cfg, clients, "val", batch=64, device="cpu")
    assert (stacked["labels"] == -1).any(), "expected pad rows below one microbatch"
    one = model.init(torch.Generator().manual_seed(0))
    accs = teng.make_client_eval(model)(tree_stack([one] * len(clients)), stacked)
    ev = make_eval_step(model)
    for i, c in enumerate(clients):
        X, y = c["val"]
        hits = sum(float(ev(one, {"images": torch.from_numpy(X[j:j + 1]),
                                  "labels": torch.from_numpy(y[j:j + 1])})["acc"])
                   for j in range(len(y)))
        np.testing.assert_allclose(float(accs[i]), hits / len(y), rtol=1e-6, atol=1e-6)


def test_client_at_a_bucket_boundary_keeps_no_pad_rows(model, clients):
    """Clients of 8, 9 and 16 train rows: the 8-row client is its own
    bucket, stored with no pad row, and the layout stays bitwise the
    rectangular one in batches and eval."""
    rng = np.random.default_rng(0)
    cut = []
    for c, n in zip(clients[:3], (8, 9, 16)):
        keep = rng.permutation(len(c["train"][1]))[:n] if n <= len(c["train"][1]) else None
        assert keep is not None
        cut.append({**c, "train": (c["train"][0][keep], c["train"][1][keep]), "n_train": n})
    rect = teng.make_swarm_data(model.cfg, cut, device="cpu")
    buck = teng.make_bucketed_swarm_data(model.cfg, cut, device="cpu")
    assert buck.client_ids == ((0,), (1, 2))
    assert buck.train[0]["labels"].shape[:2] == (1, 8) and (buck.train[0]["labels"] >= 0).all()
    idx = teng.draw_batch_idx(torch.Generator().manual_seed(1), rect.train_n, 8)
    for k in ("images", "labels"):
        assert torch.equal(teng.sample_round_batch(rect, idx)[k],
                           teng.sample_round_batch(buck, idx)[k])
    params = _random_params(model, 3, 3)
    assert torch.equal(teng.eval_swarm(model, params, rect), teng.eval_swarm(model, params, buck))


def test_single_client_swarm(model):
    """N=1: one bucket, its stacks the rectangular ones, the same
    batches and the same eval."""
    clients = make_dr_swarm_data(image_size=8, seed=0, table=SMALL_TABLE[:, :1])
    rect = teng.make_swarm_data(model.cfg, clients, device="cpu")
    buck = teng.make_bucketed_swarm_data(model.cfg, clients, device="cpu")
    assert buck.n_buckets == 1 and buck.client_ids == ((0,),)
    for k in ("images", "labels"):
        assert torch.equal(rect.train[k], buck.train[0][k])
        assert torch.equal(rect.val[k], buck.val[0][k])
    idx = teng.draw_batch_idx(torch.Generator().manual_seed(4), rect.train_n, 8)
    for k in ("images", "labels"):
        assert torch.equal(teng.sample_round_batch(rect, idx)[k],
                           teng.sample_round_batch(buck, idx)[k])
    params = _random_params(model, 1, 0)
    assert torch.equal(teng.eval_swarm(model, params, rect), teng.eval_swarm(model, params, buck))


def test_pad_rows_never_scored(model, clients, rect, buck):
    """Poisoning every pad row's inputs moves no accuracy in either
    layout: the label -1 mask alone decides what scores."""
    params = _random_params(model, N, 5)
    for data in (rect, buck):
        vals = data.val if isinstance(data, teng.BucketedSwarmData) else (data.val,)
        poisoned = []
        for v in vals:
            imgs = v["images"].clone()
            imgs[v["labels"] == -1] = 1e6
            poisoned.append({**v, "images": imgs})
        assert any((v["labels"] == -1).any() for v in vals)
        if isinstance(data, teng.BucketedSwarmData):
            other = teng.BucketedSwarmData(data.train, poisoned, data.train_n, data.client_ids)
        else:
            other = data._replace(val=poisoned[0])
        assert torch.equal(teng.eval_swarm(model, params, data),
                           teng.eval_swarm(model, params, other))


# ------------------------------------------- K1 over the ragged stacks


def test_param_stats_plain_version_over_bucket_stacks(buck):
    """K1's plain version (the CPU path of ops.param_stats_batched) over
    each bucket's (N_b, n_max_b*H*W*3) train stack against the
    reference's oracle: mean within 1e-6, var within 1e-6 (fp32 sums of
    at most ~1e4 elements in another order); the stacks are ragged."""
    shapes = set()
    for tr in buck.train:
        x = tr["images"].reshape(tr["images"].shape[0], -1)
        shapes.add(tuple(x.shape))
        m, v = ops.param_stats_batched(x)
        rm, rv = ref_param_stats_batched(x.numpy())
        assert m.shape == (x.shape[0],)
        np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)
    assert len(shapes) > 1, "bucket stacks were not ragged"
    # one (N, T, 2) call over the buckets' stacks is the per-bucket calls
    per_bucket = [tree_map(lambda t: t.reshape(t.shape[0], -1), tr)["images"] for tr in buck.train]
    for x in per_bucket:
        both = ops.param_stats_leaves([x, x * 2.0])
        m, v = ops.param_stats_batched(x)
        assert torch.equal(both[:, 0, 0], m) and torch.equal(both[:, 0, 1], v)
