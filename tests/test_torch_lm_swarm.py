"""The swarm over an LM (RQ2: the trainer is model-agnostic) against the
JAX reference on the CPU: the token batch layout, the distribution
matrix of LM trees in both parameter layouts (the scanned ``layers``
stack and a 12-block ``blocks`` list, whose paths sort ``blocks/10``
before ``blocks/2`` in both packages), one whole BSO-SL round of
granite-3-2b's smoke config on the reference's state and draws,
``SwarmTrainer.fit`` over the LM, and the dense configs the port
registers beside granite."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.diststats import swarm_distribution_matrix as jax_feats  # noqa: E402
from repro.data.tokens import make_token_swarm_data  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ModelConfig, OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.diststats import swarm_distribution_matrix  # noqa: E402
from repro_torch.core.swarm import SwarmTrainer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import assert_lm_round_matches_reference, pin_torch_threads  # noqa: E402

pin_torch_threads()

ARCH = "granite-3-2b"
N_CLIENTS = 6
K = 2
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 4
# adam's eps in the whole-round parity test, as test_torch_engine's:
# at 1e-8 a weight whose gradient is ~1e-9 moves by ~lr whatever the
# sign of its rounding, so the comparison would measure adam's
# conditioning, not the port
ROUND_ADAM_EPS = 1e-6


def _pair_cfg(**kw):
    jcfg = dataclasses.replace(jax_get_config(ARCH).smoke(), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def clients():
    return make_token_swarm_data(N_CLIENTS, jax_get_config(ARCH).smoke().vocab_size,
                                 n_seqs=12, seq_len=32)


# ------------------------------------------------------------- data layout


def test_lm_swarm_data_matches_reference(clients):
    """``make_batch``'s token branch: train (N, 12, 32) tokens and
    labels, val padded to one 64-row microbatch with label -1 rows."""
    jcfg, cfg = _pair_cfg()
    jdata = jeng.make_swarm_data(jcfg, clients)
    tdata = teng.make_swarm_data(cfg, clients, device="cpu")
    assert set(tdata.train) == set(tdata.val) == {"tokens", "labels"}
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tdata.train[k].numpy(), np.asarray(jdata.train[k]))
        np.testing.assert_array_equal(tdata.val[k].numpy(), np.asarray(jdata.val[k]))
    assert tdata.val["labels"].shape == (N_CLIENTS, 1, 64, 32)
    assert int((tdata.val["labels"] >= 0).sum()) == N_CLIENTS * 2 * 32


def test_lm_batch_keys():
    _, cfg = _pair_cfg()
    b = teng.make_batch(cfg, np.zeros((2, 5), np.int32), np.ones((2, 5), np.int32), "cpu")
    assert set(b) == {"tokens", "labels"} and b["tokens"].dtype == torch.int32


# ------------------------------------------------------ distribution matrix


@pytest.mark.parametrize("layout", [dict(scan_layers=True), dict(n_layers=12)])
def test_lm_distribution_matrix_matches_reference(layout):
    """Both packages sort leaf paths as strings, so on 12 blocks the
    column order is blocks/0, blocks/1, blocks/10, blocks/11, blocks/2."""
    jcfg, cfg = _pair_cfg(**layout)
    jm = jax_build_model(jcfg)
    stacked = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(3), 3))
    expect = np.asarray(jax_feats(stacked))
    tparams = params_from_numpy(jax.tree.map(np.asarray, stacked))
    got = swarm_distribution_matrix(tparams, 3).numpy()
    n_leaves = len(tree_paths_and_leaves(tparams))
    assert got.shape == expect.shape == (3, 2 * n_leaves)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-7)
    if not cfg.scan_layers:
        paths = sorted(p for p, _ in tree_paths_and_leaves(tparams))
        assert paths.index("blocks/10/attn/wk") < paths.index("blocks/2/attn/wk")


# --------------------------------------------------------------- one round


def test_whole_lm_swarm_round_matches_reference(clients):
    """One BSO-SL round of the LM from the reference's fresh state, its
    batch rows, k-means++ seeds and brain-storm draws injected; the checks
    and tolerances are ``torch_parity.assert_lm_round_matches_reference``'s."""
    jcfg, cfg = _pair_cfg()
    assert_lm_round_matches_reference(jcfg, cfg, clients, k=K, lr=LR, local_steps=LOCAL_STEPS,
                                      batch=BATCH, eps=ROUND_ADAM_EPS)


def test_swarm_trainer_fits_an_lm(clients):
    """tests/test_system.py's test_swarm_is_model_agnostic_lm, on the
    port: 6 token clients, 2 clusters, 2 rounds of 4 local steps."""
    cfg = get_config(ARCH).smoke()
    swarm = SwarmConfig(n_clients=N_CLIENTS, n_clusters=K, rounds=2, local_steps=4)
    tr = SwarmTrainer(build_model(cfg), clients, swarm, OptimizerConfig(name="adam", lr=2e-3),
                      seed=0, batch_size=BATCH, aggregation="bso", device="cpu")
    tr.fit()
    assert len(tr.history) == 2
    assert all(np.isfinite(h.train_loss) for h in tr.history)
    assert all(set(h.assignments.tolist()) <= {0, 1} for h in tr.history)
    acc = tr.mean_accuracy("test")
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0


# ------------------------------------------------------------- dense configs


DENSE = ["command-r-35b", "deepseek-7b", "deepseek-67b"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_is_the_references(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())


@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_forward_and_loss_match_reference(arch):
    """The smoke config on the reference's weights: logits within 1e-4,
    the loss within 1e-5 (fp32, O(1) logits)."""
    jcfg = jax_get_config(arch).smoke()
    jm, tm = jax_build_model(jcfg), build_model(get_config(arch).smoke())
    jparams = jm.init(jax.random.PRNGKey(4))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    labels = np.where(rng.uniform(size=(2, 12)) < 0.2, -1, toks).astype(np.int32)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    jloss, _ = jm.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, _ = tm.loss(tparams, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)})
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
