"""The port's fleet regime (``repro_torch.launch.fleet_driver`` and the
pieces under it) against the JAX reference on the CPU.

Eq. 2 over ranks (1 rank in process, 2 and 3 spawned gloo ranks)
against the reference's ``cluster_fedavg`` / ``cluster_fedavg_masked``;
the host brain storm, the coordinators (with the reference's k-means
seed rows injected), the fault draws and the batch upload against the
reference's; each fleet round surface against the reference's
``make_fleet_round(axis_name=None)`` on the same bridged params, batch,
decision and weights, every reference surface built and run once in a
module fixture; the traffic ledger; and ``run_fleet``'s driver
properties from the reference's fleet tests, on one rank and on two.
Sizes are tests/test_fleet.py's: squeezenet-dr at 16 px on its
``SMALL_TABLE`` clinics. Spawned ranks run ``tests/torch_fleet_workers``
(no JAX in them).
"""
import functools
import json
import pickle
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_into as jax_restore_into  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.bso import brain_storm as jax_brain_storm  # noqa: E402
from repro.data.dr import TABLE_I  # noqa: E402
from repro.launch import comm as jcomm  # noqa: E402
from repro.launch import fleet_driver as jfd  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch import bridge, serve  # noqa: E402
from repro_torch.configs import OptimizerConfig, get_config  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.bso import brain_storm_host  # noqa: E402
from repro_torch.data.dr import make_dr_swarm_data  # noqa: E402
from repro_torch.data.tokens import make_token_swarm_data  # noqa: E402
from repro_torch.launch import comm as tcomm  # noqa: E402
from repro_torch.launch import fleet_driver as tfd  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh, spawn_cpu_ranks  # noqa: E402
from repro_torch.launch.swarm_fleet import fleet_setup  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.serve import BucketSpec  # noqa: E402
from repro_torch.utils.collectives import CENSUS  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths_and_leaves, tree_stack  # noqa: E402
from torch_fleet_workers import three_ranks, two_ranks  # noqa: E402
from torch_parity import jax_kmeans_init_idx, pin_torch_threads  # noqa: E402

pin_torch_threads()

N = 8
SMALL_TABLE = np.maximum(TABLE_I // 16, (TABLE_I > 0).astype(np.int64) * 2)[:, :N]
ARCH = "squeezenet-dr"
LR = 2e-3
LOCAL_STEPS = 2
BATCH = 8
K = 3
# adam's eps in the round parity tests: 1e-6 (eps 1e-8 amplifies fp32
# rounding of ~1e-9 gradients into weight differences of up to ~lr;
# ROADMAP C)
EPS = 1e-6
K_LOCAL = 2
HIER_PODS = 2
# the incoming decision of the round parity tests, a function of the
# two-tier surface's a_prev through g, so that the flat and the two-tier
# rounds run the same Eq. 2
G = np.array([0, 1, 2, 0], np.int32)
A_PREV = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
CLUSTERS = G[A_PREV]
PRESENT = np.array([1, 0, 1, 1, 1, 1, 0, 1], bool)
AGG_PRESENT = np.array([1, 1, 1, 0, 1, 1, 1, 0], bool)
DECAY = np.array([1.0, 0.5, 1.0, 0.25, 1.0, 1.0, 0.5, 0.0], np.float32)
RUN = dict(local_steps=LOCAL_STEPS, batch_size=BATCH, seed=0)


@pytest.fixture(scope="module")
def mesh():
    """A world of one gloo rank, set up for this module and destroyed
    after it."""
    m = make_fleet_mesh(N, device="cpu")
    yield m
    m.close()


@pytest.fixture(scope="module")
def clients():
    return make_dr_swarm_data(image_size=16, seed=0, table=SMALL_TABLE)


@pytest.fixture(scope="module")
def model():
    return build_model(get_config(ARCH))


def _opt(eps=1e-8):
    return make_optimizer(OptimizerConfig(name="adam", lr=LR, eps=eps))


def _leaves_close(got, expect, atol, what=""):
    pairs = list(zip(tree_paths_and_leaves(got), tree_paths_and_leaves(expect)))
    assert len(pairs) == len(tree_paths_and_leaves(expect))
    for (p, a), (q, b) in pairs:
        assert p == q
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what} {p}")


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ------------------------------------------------------------ host brain storm


def test_brain_storm_host_is_the_reference_bitwise():
    """Assignments, centers and event strings equal over 60 seeded cases:
    k 1 to 5, empty clusters, ties, p1 / p2 low enough to replace and
    swap."""
    for case in range(60):
        rng = np.random.default_rng(case)
        n = int(rng.integers(1, 12))
        k = int(rng.integers(1, 6))
        a = rng.integers(0, k, size=n)
        if case % 3 == 0:
            a[a == k - 1] = 0                      # an empty cluster
        val = rng.integers(0, 4, size=n) / 4.0       # ties
        p1, p2 = (0.9, 0.8) if case % 2 else (0.2, 0.3)
        ref = jax_brain_storm(np.random.default_rng([case, 7]), a, val, k, p1, p2)
        got = brain_storm_host(np.random.default_rng([case, 7]), a, val, k, p1, p2)
        np.testing.assert_array_equal(got.assignments, ref.assignments)
        np.testing.assert_array_equal(got.centers, ref.centers)
        assert got.events == ref.events, case


# ------------------------------------------------------------ the coordinators


def _stats(seed, n=12, f=8):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 3.0, size=(3, f))
    return (centres[rng.integers(0, 3, n)] + rng.normal(0.0, 0.5, size=(n, f))).astype(np.float32)


@pytest.mark.parametrize("r", [0, 3])
def test_host_coordinator_matches_reference(r):
    """The reference's k-means seed rows (from fold_in(PRNGKey(seed), r))
    injected: assignments, centers and events equal; without them the
    port's own uniforms replay bitwise."""
    X = _stats(r)
    val = np.random.default_rng(r).random(12).astype(np.float32)
    kw = dict(k=K, p1=0.3, p2=0.4, kmeans_iters=10, seed=5, round_idx=r)
    ref = jfd.host_coordinator(X, val, **kw)
    init = jax_kmeans_init_idx(jax.random.fold_in(jax.random.PRNGKey(5), r), X, K)
    got = tfd.host_coordinator(X, val, init_idx=init, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]
    a, b = tfd.host_coordinator(X, val, **kw), tfd.host_coordinator(torch.from_numpy(X), val, **kw)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[0].dtype == np.int32 and a[1].dtype == np.int32


def test_host_hier_coordinator_matches_reference():
    """The global tier over summary rows with empty pod-clusters (count
    0, one a copy of an occupied row): the weighted seed rows injected,
    g, centers and events equal."""
    C = _stats(9, n=10)
    counts = np.array([3, 0, 2, 5, 1, 0, 4, 2, 1, 1], np.float32)
    C[1] = C[0]
    valsums = (np.random.default_rng(9).random(10) * counts).astype(np.float32)
    kw = dict(k=K, p1=0.3, p2=0.4, kmeans_iters=10, seed=2, round_idx=1)
    ref = jfd.host_hier_coordinator(C, counts, valsums, **kw)
    init = jax_kmeans_init_idx(jax.random.fold_in(jax.random.PRNGKey(2), 1), C, K, weights=counts)
    got = tfd.host_hier_coordinator(C, counts, valsums, init_idx=init, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


def test_hier_val_means_empty_rows():
    counts = np.array([2, 0, 4], np.float32)
    valsums = np.array([1.0, 0.0, 3.0], np.float32)
    got = tfd._hier_val_means(counts, valsums)
    np.testing.assert_array_equal(got, jfd._hier_val_means(counts, valsums))
    np.testing.assert_array_equal(got, np.array([0.5, -1.0, 0.75], np.float32))


def test_streams_do_not_collide():
    """The coordinator's and the pods' k-means streams share no state
    with the brain storm's, the faults' or any client's batch stream."""
    seeds = {"bso": [0, 1], "faults": [0, 1, *tfd._FAULT_STREAM_TAG]}
    seeds.update({f"batch{i}": [0, 1, i] for i in range(300)})
    firsts = {name: np.random.default_rng(s).random(4).tobytes() for name, s in seeds.items()}
    mine = [tfd.coordinator_uniforms(0, 1, 4).tobytes()]
    mine += [tfd.pod_uniforms(0, 1, [p], 4)[0].tobytes() for p in range(4)]
    assert len(set(mine)) == len(mine)
    assert not set(mine) & set(firsts.values())


# ------------------------------------------------------------ faults and batches


def test_draw_faults_and_round_batch_are_the_reference_bitwise(clients):
    fa = tfd.FleetFaults(drop_rate=0.4, straggler_rate=0.3, stale_decay=0.5, quorum=5)
    ja = jfd.FleetFaults(drop_rate=0.4, straggler_rate=0.3, stale_decay=0.5, quorum=5)
    for r in range(6):
        for got, ref in zip(tfd.draw_faults(fa, N, 3, r), jfd.draw_faults(ja, N, 3, r)):
            np.testing.assert_array_equal(got, ref)
    cfg = jax_get_config(ARCH)
    ref = jfd._sample_round_batch(cfg, clients, 16, 0, 2)
    got = tfd._sample_round_batch(get_config(ARCH), clients, 16, 0, 2)
    for key in ("images", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    part = tfd._sample_round_batch(get_config(ARCH), clients, 16, 0, 2, ids=range(4, 8))
    np.testing.assert_array_equal(part["images"].numpy(), got["images"].numpy()[4:])


def test_unit_fleet_builder_shapes(mesh):
    model_, opt, m, cl = tfd.make_unit_fleet(n_clients=4, image_size=8, data_scale=32,
                                             device="cpu")
    jm, _, jmesh, jcl = jfd.make_unit_fleet(n_clients=4, image_size=8, data_scale=32)
    assert len(cl) == len(jcl) == 4
    assert 4 % m.shape["pod"] == 0 and m.shape["pod"] == jmesh.shape["pod"]
    assert model_.cfg.arch_id == jm.cfg.arch_id == "squeezenet-dr"
    for c, jc in zip(cl, jcl):
        np.testing.assert_array_equal(c["train"][0], jc["train"][0])
    assert m.group is mesh.group                    # the module's world, taken as it is


# ------------------------------------------------------------ the fleet round


@pytest.fixture(scope="module")
def ref_inputs(clients):
    """The reference's fresh swarm (vmapped init from PRNGKey(0)) and the
    round's batch, val stack, decision and weights, as numpy."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    jopt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=EPS))
    sp = jax.vmap(jmodel.init)(jax.random.split(jax.random.PRNGKey(0), N))
    so = jax.vmap(jopt.init)(sp)
    cfg = jax_get_config(ARCH)
    return {"jmodel": jmodel, "jopt": jopt,
            "params": jax.tree.map(np.asarray, sp), "opt": jax.tree.map(np.asarray, so),
            "batch": jax.tree.map(np.asarray, jfd._sample_round_batch(
                cfg, clients, LOCAL_STEPS * BATCH, 0, 0)),
            "val": jax.tree.map(np.asarray, jeng.stack_eval_split(cfg, clients, "val")),
            "weights": np.asarray([c["n_train"] for c in clients], np.float32)}


def _port_state(ri):
    return (bridge.params_from_numpy(ri["params"]), bridge.opt_state_from_numpy(ri["opt"]),
            bridge.tree_from_numpy(ri["batch"]), bridge.tree_from_numpy(ri["val"]))


class _RefRounds:
    """Every reference surface built and run once, each when a test first
    asks for it: with_loss on CLUSTERS (and the client eval of its
    params); with_eval + with_churn on PRESENT / AGG_PRESENT and decayed
    weights; the stacked two-tier round (HIER_PODS pods) composing the
    same decision, and the reference's pod seed rows."""

    KMKEY_SEED = 9

    def __init__(self, ri):
        self.ri = ri
        self.j = jax.tree.map(jnp.asarray, {k: ri[k] for k in ("params", "opt", "batch", "val")})
        self.lr, self.w = jnp.float32(LR), jnp.asarray(ri["weights"])

    def _step(self, **kw):
        return jax.jit(jeng.make_fleet_round(self.ri["jmodel"], self.ri["jopt"], N, LOCAL_STEPS,
                                             **kw))

    @functools.cached_property
    def loss(self):
        j = self.j
        p, o, stats, loss = self._step(with_loss=True)(j["params"], j["opt"], j["batch"],
                                                       self.lr, jnp.asarray(CLUSTERS), self.w)
        out = jax.tree.map(np.asarray, {"params": p, "opt": o, "stats": stats, "loss": loss})
        out["val"] = np.asarray(jax.jit(jeng.make_client_eval(self.ri["jmodel"]))(p, j["val"]))
        return out

    @functools.cached_property
    def churn(self):
        j = self.j
        p, _, fo = self._step(with_eval=True, with_churn=True)(
            j["params"], j["opt"], j["batch"], j["val"], self.lr, jnp.asarray(CLUSTERS),
            self.w * jnp.asarray(DECAY), jnp.asarray(PRESENT), jnp.asarray(AGG_PRESENT))
        return jax.tree.map(np.asarray, {"params": p, "out": fo._asdict()})

    @functools.cached_property
    def hier(self):
        j = self.j
        p, _, ho = self._step(hier_k_local=K_LOCAL, hier_pods=HIER_PODS)(
            j["params"], j["opt"], j["batch"], j["val"], self.lr, jnp.asarray(G),
            jnp.asarray(True), jnp.arange(N, dtype=jnp.int32), jnp.asarray(A_PREV),
            jax.random.PRNGKey(self.KMKEY_SEED), self.w)
        return jax.tree.map(np.asarray, {"params": p, "out": ho._asdict()})

    @functools.cached_property
    def pod_init_idx(self):
        """fold_in(kmkey, p)'s seed rows over each pod's stats: the
        with_loss round's, which runs the same Eq. 2, local phase and
        upload as the two-tier round."""
        m = N // HIER_PODS
        kmkey = jax.random.PRNGKey(self.KMKEY_SEED)
        return np.stack([jax_kmeans_init_idx(jax.random.fold_in(kmkey, q),
                                             self.loss["stats"][q * m:(q + 1) * m], K_LOCAL)
                         for q in range(HIER_PODS)])


@pytest.fixture(scope="module")
def ref_rounds(ref_inputs):
    return _RefRounds(ref_inputs)


@pytest.fixture(scope="module")
def hier_inputs(ref_inputs, ref_rounds):
    ri = ref_inputs
    return {"arch": ARCH, "lr": LR, "eps": EPS, "local_steps": LOCAL_STEPS, "k_local": K_LOCAL,
            "params": ri["params"], "opt": ri["opt"], "batch": ri["batch"], "val": ri["val"],
            "g": G, "clusters0": np.arange(N, dtype=np.int32), "a_prev": A_PREV,
            "pod_init_idx": ref_rounds.pod_init_idx, "weights": ri["weights"]}


def test_fleet_round_plain_loss_and_eval_match_reference(mesh, model, ref_inputs, ref_rounds):
    """The plain, with_loss and with_eval surfaces on one rank from the
    reference's state, batch and decision: params and stats within 1e-5,
    loss within 1e-6, val accuracies equal; the three surfaces agree
    bitwise with each other."""
    ref = ref_rounds.loss
    outs = {}
    for surface in ("plain", "loss", "eval"):
        step = fleet_setup(model, _opt(EPS), mesh, k=N, n_local_steps=LOCAL_STEPS,
                           with_eval=surface == "eval", with_loss=surface == "loss").step
        sp, so, batch, val = _port_state(ref_inputs)
        args = (sp, so, batch) + ((val,) if surface == "eval" else ()) + (
            LR, torch.as_tensor(CLUSTERS), torch.as_tensor(ref_inputs["weights"]))
        outs[surface] = step(*args)
    p, _, stats, loss = outs["loss"]
    _leaves_close(bridge.params_to_numpy(p), ref["params"], 1e-5, "params")
    np.testing.assert_allclose(stats.numpy(), ref["stats"], rtol=0, atol=1e-5)
    assert abs(float(loss) - float(ref["loss"])) <= 1e-6
    pe, _, fo = outs["eval"]
    np.testing.assert_array_equal(fo.val_acc.numpy(), ref_rounds.loss["val"])
    assert _equal_trees(pe, p) and _equal_trees(outs["plain"][0], p)
    assert torch.equal(fo.stats, stats) and torch.equal(outs["plain"][2], stats)
    assert float(fo.train_loss) == float(loss)


def test_fleet_round_churn_matches_reference(mesh, model, ref_inputs, ref_rounds):
    """with_eval + with_churn, masks not all ones, decayed weights: params
    and stats within 1e-5, val accuracies equal, loss within 1e-6;
    clients absent from the local phase keep their aggregated params."""
    ref = ref_rounds.churn
    step = fleet_setup(model, _opt(EPS), mesh, k=N, n_local_steps=LOCAL_STEPS, with_eval=True,
                       with_churn=True).step
    sp, so, batch, val = _port_state(ref_inputs)
    w = torch.as_tensor(ref_inputs["weights"] * DECAY)
    p, _, fo = step(sp, so, batch, val, LR, torch.as_tensor(CLUSTERS), w,
                    torch.as_tensor(PRESENT), torch.as_tensor(AGG_PRESENT))
    _leaves_close(bridge.params_to_numpy(p), ref["params"], 1e-5, "params")
    np.testing.assert_allclose(fo.stats.numpy(), ref["out"]["stats"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(fo.val_acc.numpy(), ref["out"]["val_acc"])
    assert abs(float(fo.train_loss) - float(ref["out"]["train_loss"])) <= 1e-6


def test_fleet_round_allones_churn_is_bitwise_churn_free(mesh, model, ref_inputs):
    """All-ones masks and weights times 1.0: the churn surface is the
    churn-free round bitwise (params, stats, val, loss)."""
    outs = []
    for churn in (False, True):
        step = fleet_setup(model, _opt(EPS), mesh, k=N, n_local_steps=LOCAL_STEPS,
                           with_eval=True, with_churn=churn).step
        sp, so, batch, val = _port_state(ref_inputs)
        w = torch.as_tensor(ref_inputs["weights"])
        ones = torch.ones(N, dtype=torch.bool)
        masks = (ones, ones) if churn else ()
        outs.append(step(sp, so, batch, val, LR, torch.as_tensor(CLUSTERS),
                         w * 1.0 if churn else w, *masks))
    (pa, _, a), (pb, _, b) = outs
    assert _equal_trees(pa, pb)
    assert torch.equal(a.stats, b.stats) and torch.equal(a.val_acc, b.val_acc)
    assert float(a.train_loss) == float(b.train_loss)


def _check_hier(p, out, ref, what):
    _leaves_close(bridge.params_to_numpy(p), ref["params"], 1e-5, f"{what} params")
    ro = ref["out"]
    np.testing.assert_array_equal(np.asarray(out["a_local"]), ro["a_local"])
    for f in ("centroids", "wsums"):
        np.testing.assert_allclose(np.asarray(out[f]), ro[f], rtol=1e-6, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np.asarray(out["counts"]), ro["counts"])
    np.testing.assert_allclose(np.asarray(out["valsums"]), ro["valsums"], rtol=0, atol=1e-6)
    assert abs(float(out["mean_val"]) - float(ro["mean_val"])) <= 1e-6
    assert abs(float(out["train_loss"]) - float(ro["train_loss"])) <= 1e-6


def _hier_step_args(ri, ref_rounds, pods):
    sp, so, batch, val = _port_state(ri)
    return (sp, so, batch, val, LR, torch.as_tensor(G), torch.tensor(True),
            torch.arange(N, dtype=torch.int32), torch.as_tensor(A_PREV),
            torch.as_tensor(ref_rounds.pod_init_idx[:pods]),
            torch.as_tensor(ri["weights"]))


def test_fleet_round_hier_stacked_matches_reference(model, ref_inputs, ref_rounds):
    """The stacked two-tier round (group=None, 2 equal pods) composing
    g[a_prev] on the device, pods seeded with the reference's rows:
    a_local and counts equal, summaries within 1e-5, params within 1e-5."""
    step = teng.make_fleet_round(model, _opt(EPS), N, LOCAL_STEPS, hier_k_local=K_LOCAL,
                                 hier_pods=HIER_PODS)
    p, _, ho = step(*_hier_step_args(ref_inputs, ref_rounds, HIER_PODS))
    _check_hier(p, ho._asdict(), ref_rounds.hier, "stacked")
    assert ho.a_local.dtype == torch.int32


def test_fleet_round_hier_two_ranks_matches_reference(two_rank_run, ref_rounds):
    """Two gloo ranks, one pod each (pod index = rank): the concatenated
    outputs as the reference's stacked two-pod round."""
    out = [o["hier"] for o in two_rank_run[1]]
    p = jax.tree.map(lambda *xs: np.concatenate(xs), *[o["params"] for o in out])
    ho = {f: (np.concatenate([o["out"][f] for o in out]) if out[0]["out"][f].ndim
              else out[0]["out"][f]) for f in out[0]["out"]}
    assert out[0]["out"]["mean_val"] == out[1]["out"]["mean_val"]
    _check_hier(bridge.params_from_numpy(p), ho, ref_rounds.hier, "two ranks")


def test_fleet_round_hier_one_pod_stacked_equals_rank_path(mesh, model, ref_inputs, ref_rounds):
    """One pod: the stacked surface (group=None, hier_pods=1) and the
    rank surface on a 1-rank mesh give the same round (the port's
    counterpart of the reference's gspmd-vs-shard_map trivial-mesh
    test): a_local and counts equal, the rest within 1e-6."""
    args = _hier_step_args(ref_inputs, ref_rounds, 1)
    seeds = torch.as_tensor(np.arange(K_LOCAL)[None])
    stacked = teng.make_fleet_round(model, _opt(EPS), N, LOCAL_STEPS, hier_k_local=K_LOCAL,
                                    hier_pods=1)(*args[:9], seeds, args[10])
    args = _hier_step_args(ref_inputs, ref_rounds, 1)
    ranked = fleet_setup(model, _opt(EPS), mesh, k=N, n_local_steps=LOCAL_STEPS,
                         hier_k_local=K_LOCAL).step(*args[:9], seeds, args[10])
    _leaves_close(bridge.params_to_numpy(stacked[0]), bridge.params_to_numpy(ranked[0]), 1e-6)
    for f in HierRoundOut_fields():
        np.testing.assert_allclose(np.asarray(getattr(stacked[2], f)),
                                   np.asarray(getattr(ranked[2], f)), rtol=0, atol=1e-6,
                                   err_msg=f)
    assert torch.equal(stacked[2].a_local, ranked[2].a_local)
    assert torch.equal(stacked[2].counts, ranked[2].counts)


def HierRoundOut_fields():
    return teng.HierRoundOut._fields


def test_fleet_setup_surfaces_and_refusals(mesh, model):
    with pytest.raises(ValueError, match="DeviceMesh"):
        fleet_setup(model, _opt(), mesh, k=N, spmd="auto")
    with pytest.raises(ValueError, match="exclusive"):
        fleet_setup(model, _opt(), mesh, k=N, with_eval=True, with_loss=True)
    with pytest.raises(ValueError, match="own eval surface"):
        fleet_setup(model, _opt(), mesh, k=N, with_eval=True, hier_k_local=2)
    prog = fleet_setup(model, _opt(), mesh, k=N, with_churn=True, hier_k_local=2)
    assert prog.mesh is mesh and callable(prog.step)
    with pytest.raises(ValueError, match="NCCL mesh needs a CUDA device"):
        make_fleet_mesh(N, backend="nccl", device="cpu")


def test_fleet_round_trains_on_per_step_microbatches():
    """Two local steps equal two sequential steps on the batch's two
    distinct halves (the reference's test_launch regression), on an LM's
    token batch; the identical batch twice is far off."""
    from repro_torch.train.steps import make_train_step

    cfg = get_config("granite-3-2b").smoke()
    lm = build_model(cfg)
    opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-2))
    step_fn = teng.make_fleet_round(lm, opt, k=1, n_local_steps=2)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 4, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    sp = tree_map(lambda x: x[None], params)
    out_p, _, stats = step_fn(sp, teng.init_opt_state(opt, sp), batch, 1e-2,
                              torch.zeros(1, dtype=torch.int32), torch.ones(1))
    assert stats.shape[0] == 1 and stats.dim() == 2
    step = make_train_step(lm, opt)
    p, o = params, opt.init(params)
    for half in (slice(0, 2), slice(2, 4)):
        p, o, _ = step(p, o, {k: v[0, half] for k, v in batch.items()}, 1e-2)
    got = tree_leaves(tree_map(lambda x: x[0], out_p))
    for g, w in zip(got, tree_leaves(p)):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=1e-2, atol=2e-3)
    p2, o2 = params, opt.init(params)
    for _ in range(2):
        p2, o2, _ = step(p2, o2, {k: v[0] for k, v in batch.items()}, 1e-2)
    assert max(float((g - w).abs().max()) for g, w in zip(got, tree_leaves(p2))) > 1e-2


# ------------------------------------------------------------ Eq. 2 over ranks


def _eq2_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "b": [rng.normal(size=(n, 5)).astype(np.float32)]}
    a = rng.integers(0, max(1, n // 2), size=n).astype(np.int32)
    w = rng.integers(5, 40, size=n).astype(np.float32)
    present = rng.random(n) > 0.3
    eff = (w * np.where(present, 1.0, 0.5)).astype(np.float32)
    eff[a == a[0]] = 0.0                     # one cluster with no weight at all
    return {"tree": tree, "assignments": a, "weights": w, "present": present,
            "eff_weights": eff}


def _eq2_expect(d):
    n = d["assignments"].shape[0]
    jt = jax.tree.map(jnp.asarray, d["tree"])
    plain = jagg.cluster_fedavg(jt, jnp.asarray(d["assignments"]), jnp.asarray(d["weights"]), k=n)
    masked = jagg.cluster_fedavg_masked(jt, jnp.asarray(d["assignments"]),
                                        jnp.asarray(d["eff_weights"]),
                                        jnp.asarray(d["present"]), k=n)
    return jax.tree.map(np.asarray, plain), jax.tree.map(np.asarray, masked)


def _concat_ranks(results, key):
    return jax.tree.map(lambda *xs: np.concatenate(xs), *[r[key] for r in results])


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory, hier_inputs):
    """One spawn of 2 gloo ranks (tests/torch_fleet_workers.two_ranks):
    Eq. 2, a two-tier round (one pod a rank) and a 2-round run_fleet."""
    d = tmp_path_factory.mktemp("two")
    inputs = {"eq2": _eq2_inputs(N, 1), "hier": hier_inputs,
              "fleet": {"arch": ARCH, "image_size": 16, "table": SMALL_TABLE,
                        "kw": dict(rounds=2, **RUN)}}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn_cpu_ranks(two_ranks, 2, str(d / "in.pkl"), str(d))
    out = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return inputs, out


@pytest.fixture(scope="module")
def three_rank_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("three")
    inputs = _eq2_inputs(3, 2)
    inputs["assignments"] = np.array([1, 0, 1], np.int32)
    inputs["eff_weights"] = (inputs["weights"] * np.array([1.0, 0.5, 0.0])).astype(np.float32)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn_cpu_ranks(three_ranks, 3, str(d / "in.pkl"), str(d))
    out = []
    for r in range(3):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return inputs, out


def test_eq2_psum_on_one_rank_matches_reference(mesh):
    """On one rank, cluster_fedavg_psum(_masked) equals the reference's
    cluster_fedavg(_masked) within 1e-6 and the port's own sim Eq. 2
    bitwise (a sum of one addend, an all-reduce over one rank)."""
    d = _eq2_inputs(N)
    plain, masked = _eq2_expect(d)
    x = bridge.tree_from_numpy(d["tree"])
    a, w = torch.as_tensor(d["assignments"]), torch.as_tensor(d["weights"])
    got = tagg.cluster_fedavg_psum(x, a, w, k=N, group=mesh.group)
    _leaves_close(bridge.tree_to_numpy(got), plain, 1e-6, "psum")
    assert _equal_trees(got, tagg.cluster_fedavg(x, a, w, k=N))
    eff, pr = torch.as_tensor(d["eff_weights"]), torch.as_tensor(d["present"])
    got_m = tagg.cluster_fedavg_psum_masked(x, a, eff, pr, k=N, group=mesh.group)
    _leaves_close(bridge.tree_to_numpy(got_m), masked, 1e-6, "masked")
    assert _equal_trees(got_m, tagg.cluster_fedavg_masked(x, a, eff, pr, k=N))


def test_eq2_psum_on_two_ranks_matches_reference(two_rank_run):
    """Two gloo ranks of 4 clients: the concatenated slices within 1e-6
    of the reference's Eq. 2, plain and masked (one cluster with zero
    total weight, absent clients keeping their own params)."""
    inputs, out = two_rank_run
    plain, masked = _eq2_expect(inputs["eq2"])
    eq2 = [o["eq2"] for o in out]
    _leaves_close(_concat_ranks(eq2, "psum"), plain, 1e-6, "psum")
    _leaves_close(_concat_ranks(eq2, "masked"), masked, 1e-6, "masked")


def test_eq2_three_ranks_one_client_each(three_rank_run):
    """Three gloo ranks of one client: cluster_psum_fedavg (a rank's
    unstacked tree) and the stacked psum within 1e-6 of the reference's
    cluster_fedavg; the masked one of its cluster_fedavg_masked."""
    inputs, out = three_rank_run
    plain, masked = _eq2_expect(inputs)
    one = jax.tree.map(lambda *xs: np.stack(xs), *[o["one_client"] for o in out])
    _leaves_close(one, plain, 1e-6, "one client a rank")
    eq2 = [o["eq2"] for o in out]
    _leaves_close(_concat_ranks(eq2, "psum"), plain, 1e-6, "psum")
    _leaves_close(_concat_ranks(eq2, "masked"), masked, 1e-6, "masked")


@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_singleton_and_allones_eq2_are_bitwise(mesh, two_rank_run, three_rank_run, ranks):
    """The singleton plan is the identity bitwise (every weight w / w is
    exactly 1.0, each sum has one addend), and all-ones masks with the
    weights times 1.0 are the plain Eq. 2 bitwise, on 1, 2 and 3 ranks."""
    if ranks == 1:
        d = _eq2_inputs(N)
        x = bridge.tree_from_numpy(d["tree"])
        w = torch.as_tensor(d["weights"])
        single = tagg.cluster_fedavg_psum(x, torch.arange(N, dtype=torch.int32), w, k=N,
                                          group=mesh.group)
        assert _equal_trees(single, x)
        a = torch.as_tensor(d["assignments"])
        assert _equal_trees(
            tagg.cluster_fedavg_psum_masked(x, a, w * 1.0, torch.ones(N, dtype=torch.bool), k=N,
                                            group=mesh.group),
            tagg.cluster_fedavg_psum(x, a, w, k=N, group=mesh.group))
        return
    out = two_rank_run[1] if ranks == 2 else three_rank_run[1]
    assert all(o["eq2"]["singleton_bitwise"] for o in out)
    assert all(o["eq2"]["allones_bitwise"] for o in out)


def test_eq2_census_pins_collectives(mesh, two_rank_run):
    """An Eq. 2 is 1 + #leaves all-reduces: the (k,) cluster totals, then
    each leaf's (k, ...) sums (the reference's one psum a leaf), so a
    rank moves 4 * (k * P + k) bytes for P parameters a client."""
    d = _eq2_inputs(N)
    sizes = [v[0].numel() for v in tree_leaves(bridge.tree_from_numpy(d["tree"]))]
    P = sum(sizes)
    want = [("all_reduce", 4 * N, "eq2")] + sorted(("all_reduce", 4 * N * n, "eq2")
                                                   for n in sizes)

    def ordered(census):
        return census[:1] + sorted(census[1:])

    mark = CENSUS.mark()
    tagg.cluster_fedavg_psum(bridge.tree_from_numpy(d["tree"]), torch.as_tensor(d["assignments"]),
                             torch.as_tensor(d["weights"]), k=N, group=mesh.group)
    entries = CENSUS.since(mark)
    assert ordered([(e.op, e.nbytes, e.tag) for e in entries]) == want
    summary = tcomm.census_bytes(entries, "eq2")
    assert summary["total"] == 4 * (N * P + N)
    assert summary["op_counts"] == {"all_reduce": 1 + len(sizes), "gather": 0, "broadcast": 0}
    for o in two_rank_run[1]:
        assert ordered([tuple(c[:3]) for c in o["eq2"]["census"]]) == want


# ------------------------------------------------------------ the ledger


def test_hier_ledger_matches_reference(model):
    jparams = jax.eval_shape(lambda: jax_build_model(jax_get_config(ARCH)).init(
        jax.random.PRNGKey(0)))
    params = model.init(torch.Generator().manual_seed(0))
    assert tcomm.hier_host_bytes(params, 1000, 16, 3) == jcomm.hier_host_bytes(jparams, 1000,
                                                                               16, 3)
    assert tcomm.hier_scaling_table(params, pod_size=64, k_local=2) == \
        jcomm.hier_scaling_table(jparams, pod_size=64, k_local=2)


# ------------------------------------------------------------ run_fleet


@pytest.fixture(scope="module")
def flat3(mesh, model, clients):
    """A 3-round flat run, and a second from the same seed."""
    runs = [tfd.run_fleet(model, _opt(), mesh, clients, rounds=3, **RUN) for _ in range(2)]
    return runs


def test_run_fleet_smoke_and_loop(flat3):
    """One round step, well-formed logs, the loop closed (round r+1
    applies round r's decision, round 0 singletons), and every decision
    replayed by host_coordinator from the pulled stats."""
    res = flat3[0]
    assert res.n_compiles == 1 and len(res.history) == 3
    np.testing.assert_array_equal(res.history[0].applied_clusters, np.arange(N))
    for r, log in enumerate(res.history):
        assert 0.0 <= log.mean_val_acc <= 1.0 and np.isfinite(log.train_loss)
        assert log.stats.shape == (N, 56) and set(log.assignments.tolist()) <= {0, 1, 2}
        a, c, ev = tfd.host_coordinator(log.stats, log.val_acc, k=K, p1=0.9, p2=0.8, seed=0,
                                        round_idx=r)
        np.testing.assert_array_equal(a, log.assignments)
        np.testing.assert_array_equal(c, log.centers)
        assert ev == log.events
        if r + 1 < 3:
            np.testing.assert_array_equal(res.history[r + 1].applied_clusters, log.assignments)
    assert res.meta["mesh_shape"] == {"pod": 1} and res.meta["backend"] == "gloo"


def test_run_fleet_same_seed_same_run(flat3):
    a, b = flat3
    for x, y in zip(a.history, b.history):
        np.testing.assert_array_equal(x.stats, y.stats)
        np.testing.assert_array_equal(x.assignments, y.assignments)
        assert x.train_loss == y.train_loss
    assert _equal_trees(a.params, b.params)


def test_run_fleet_comm_ledger(flat3, model):
    """The ledger's keys are the reference's; Eq. 2 is 1 + #leaves
    all-reduces of 4 * (N * P + N) bytes in all a round at k = N, and the
    round's other collectives are the loss mean, the stats and val
    gathers and the decision's broadcast."""
    comm = flat3[0].comm
    leaves = tree_leaves(model.init(torch.Generator().manual_seed(0)))
    P = sum(x.numel() for x in leaves)
    eq2 = comm["eq2_collective_bytes"]
    assert eq2["total"] == 4 * (N * P + N) and eq2["op_counts"]["all_reduce"] == 1 + len(leaves)
    assert comm["round_collective_bytes"]["op_counts"] == {"all_reduce": 2 + len(leaves),
                                                           "gather": 2,
                                                           "broadcast": 1}
    assert comm["stat_upload_bytes"] == N * 56 * 4 and comm["cost_analysis"] == {}
    jkeys = {"n_clients", "stat_upload_bytes", "val_upload_bytes", "cluster_feedback_bytes",
             "batch_upload_bytes", "eq2_collective_bytes", "eq2_p2p_bound_bytes", "fedavg_bytes",
             "blockchain_bytes", "full_params_bytes", "coord_reduction_x", "cost_analysis"}
    assert jkeys <= set(comm)


def test_run_fleet_bucketed_eval_is_rectangular_bitwise(mesh, model, clients, flat3):
    """The bucketed eval (one eval step a size bucket, the round built
    with_loss) gives the rectangular eval's scores, stats, decisions and
    losses bitwise, at 1 + n_buckets step functions."""
    res_b = tfd.run_fleet(model, _opt(), mesh, clients, rounds=3, eval_buckets=3, **RUN)
    assert 2 <= res_b.meta["eval_buckets"] <= 3
    assert res_b.n_compiles == 1 + res_b.meta["eval_buckets"]
    for a, b in zip(flat3[0].history, res_b.history):
        np.testing.assert_array_equal(a.val_acc, b.val_acc)
        np.testing.assert_array_equal(a.stats, b.stats)
        np.testing.assert_array_equal(a.assignments, b.assignments)
        assert a.train_loss == b.train_loss


def test_run_fleet_allones_churn_is_bitwise_churn_free(mesh, model, clients, flat3):
    res_c = tfd.run_fleet(model, _opt(), mesh, clients, rounds=3,
                          faults=tfd.FleetFaults(quorum=1), **RUN)
    for a, b in zip(flat3[0].history, res_c.history):
        np.testing.assert_array_equal(a.stats, b.stats)
        np.testing.assert_array_equal(a.val_acc, b.val_acc)
        np.testing.assert_array_equal(a.assignments, b.assignments)
        assert a.train_loss == b.train_loss
        assert b.coordinated and b.present.all() and b.reported.all()
    assert _equal_trees(flat3[0].params, res_c.params)


def _replay_churn(res, fa, draw=tfd.draw_faults):
    """Replays a churn run's decisions by the reference driver's rule:
    the straggler cache takes every round's reports, quorum miss or not;
    a coordinated round is host_coordinator on the stats with the
    stragglers' and dropped clients' last-seen reports filled in; a miss
    applies the previous decision again. Returns the rounds coordinated
    with a cached report in use."""
    last_stats = np.zeros_like(res.history[0].stats)
    last_val = np.zeros(N, np.float32)
    have = np.zeros(N, bool)
    prev = np.arange(N, dtype=np.int32)
    cached_rounds = []
    for r, log in enumerate(res.history):
        present, straggler = draw(fa, N, 0, r)
        np.testing.assert_array_equal(log.present, present)
        np.testing.assert_array_equal(log.reported, present & ~straggler)
        assert log.sim_delay_s == (fa.delay_s if straggler.any() else 0.0)
        stats_eff, val_eff = log.stats.copy(), log.val_acc.copy()
        miss = ~log.reported & have
        stats_eff[miss] = last_stats[miss]
        val_eff[miss] = last_val[miss]
        if log.coordinated:
            a, c, _ = tfd.host_coordinator(stats_eff, val_eff, k=K, p1=0.9, p2=0.8, seed=0,
                                           round_idx=r)
            np.testing.assert_array_equal(log.assignments, a)
            np.testing.assert_array_equal(log.centers, c)
            if miss.any():
                cached_rounds.append(r)
        else:
            assert log.reported.sum() < fa.quorum and "quorum miss" in log.events[0]
            np.testing.assert_array_equal(log.assignments, prev)
        last_stats[log.reported] = log.stats[log.reported]
        last_val[log.reported] = log.val_acc[log.reported]
        have |= log.reported
        prev = log.assignments
    return cached_rounds


def test_run_fleet_quorum_determinism(mesh, model, clients):
    """Faults replay bit for bit; a quorum miss applies the previous
    decision again; a coordinated round is host_coordinator on the
    stats with stragglers' last-seen reports filled in."""
    fa = tfd.FleetFaults(drop_rate=0.4, straggler_rate=0.3, delay_s=1.0, stale_decay=0.5,
                         quorum=5)
    kw = dict(rounds=4, faults=fa, **RUN)
    res, res2 = (tfd.run_fleet(model, _opt(), mesh, clients, **kw) for _ in range(2))
    assert any(not log.coordinated for log in res.history)
    for log, log2 in zip(res.history, res2.history):
        np.testing.assert_array_equal(log.assignments, log2.assignments)
        np.testing.assert_array_equal(log.val_acc, log2.val_acc)
    _replay_churn(res, fa)


# (present, straggler) a round: round 0 misses the quorum (3 of 8
# report); round 1 is coordinated while client 0, reported in round 0
# only, straggles and client 7 has never reported; round 2 is
# coordinated with client 1, last reported in round 1, straggling
_SCHEDULE = [
    (np.array([1, 1, 1, 1, 1, 1, 0, 0], bool), np.array([0, 0, 0, 1, 1, 1, 0, 0], bool)),
    (np.array([1, 1, 1, 1, 1, 1, 1, 0], bool), np.array([1, 0, 0, 0, 0, 0, 0, 0], bool)),
    (np.array([1, 1, 1, 1, 1, 1, 1, 1], bool), np.array([0, 1, 0, 0, 0, 0, 0, 0], bool)),
]


def test_run_fleet_straggler_cache_fills_after_quorum_miss(mesh, model, clients, monkeypatch):
    """A round that misses the quorum still fills the straggler cache:
    on a fixed fault schedule whose first round misses, the next
    coordinated round sees its straggler's report from the missed round,
    as the reference driver's does."""
    fa = tfd.FleetFaults(stale_decay=0.5, delay_s=1.0, quorum=5)
    schedule = lambda faults, n, seed, r: tuple(x.copy() for x in _SCHEDULE[r])  # noqa: E731
    monkeypatch.setattr(tfd, "draw_faults", schedule)
    res = tfd.run_fleet(model, _opt(), mesh, clients, rounds=3, faults=fa, **RUN)
    assert [log.coordinated for log in res.history] == [False, True, True]
    assert _replay_churn(res, fa, draw=schedule) == [1, 2]


def test_run_fleet_ckpt_periodic_equals_final_and_reference_reads_it(mesh, model, clients,
                                                                    tmp_path):
    """ckpt_every dividing rounds: the last periodic export is the final
    one bitwise (step 2 in both manifests); the reference's restore_into
    reads the fp32 file, and serve.load_checkpoint serves it on the CPU."""
    ck = str(tmp_path / "ck")
    tfd.run_fleet(model, _opt(), mesh, clients, rounds=2, ckpt_path=ck, ckpt_every=1, **RUN)
    final, last = np.load(ck + ".npz"), np.load(ck + "_r2.npz")
    assert set(final.files) == set(last.files)
    for key in final.files:
        np.testing.assert_array_equal(final[key], last[key])
    m_final = json.loads((tmp_path / "ck.json").read_text())
    assert m_final["step"] == json.loads((tmp_path / "ck_r2.json").read_text())["step"] == 2
    assert (tmp_path / "ck_r1.npz").exists()
    example = jax.eval_shape(lambda: jax.vmap(jax_build_model(jax_get_config(ARCH)).init)(
        jax.random.split(jax.random.PRNGKey(0), N)))
    restored, step = jax_restore_into(example, ck)
    assert step == 2
    for p, leaf in tree_paths_and_leaves(jax.tree.map(np.asarray, restored)):
        np.testing.assert_array_equal(leaf, final[p])
    m2, params = serve.load_checkpoint(ck, device="cpu")
    assert m2 is model
    imgs = [clients[0]["train"][0][i] for i in range(5)]
    out = serve.classify(m2, params, imgs, batch_buckets=(1, 4), device="cpu")
    direct = torch.argmax(m2.forward(params, {"images": torch.as_tensor(np.stack(imgs))})[0], -1)
    assert [o.label for o in out] == direct.tolist()


def test_run_fleet_rounds0_warns_and_exports(mesh, model, clients, tmp_path):
    ck = str(tmp_path / "zero")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = tfd.run_fleet(model, _opt(), mesh, clients, rounds=0, seed=0, ckpt_path=ck)
    assert any("rounds=0" in str(x.message) for x in w)
    man = json.loads((tmp_path / "zero.json").read_text())
    assert man["step"] == 0 and man["extra"]["n_clients"] == N
    assert res.history == []


def test_run_fleet_hier_o_pods_upload_with_faults(mesh, model, clients):
    """The two-tier driver: S = pods * k_local summary rows reach rank 0
    (never the (N, F) stats), the loop closes on g, each map replays
    through host_hier_coordinator, and under faults a quorum miss keeps
    the previous g."""
    kl = 4
    res = tfd.run_fleet(model, _opt(), mesh, clients, rounds=3, hier_k_local=kl, **RUN)
    assert res.meta["hier"] == {"k_local": kl, "n_pods": 1, "summary_rows": kl}
    assert res.comm["summary_upload_bytes"] < res.comm["flat_upload_bytes"]
    for r, log in enumerate(res.history):
        assert log.stats.shape[0] == kl and log.assignments.shape == (kl,)
        np.testing.assert_allclose(log.counts.sum(), N)
        g2, c2, _ = tfd.host_hier_coordinator(log.stats, log.counts, log.valsums, k=K, p1=0.9,
                                              p2=0.8, seed=0, round_idx=r)
        np.testing.assert_array_equal(g2, log.assignments)
        np.testing.assert_array_equal(c2, log.centers)
        if r:
            np.testing.assert_array_equal(log.applied_clusters, res.history[r - 1].assignments)
    faults = tfd.FleetFaults(drop_rate=0.3, straggler_rate=0.2, stale_decay=0.5, quorum=6)
    res = tfd.run_fleet(model, _opt(), mesh, clients, rounds=3, faults=faults, hier_k_local=kl,
                        **RUN)
    prev = np.zeros(kl, np.int32)
    for log in res.history:
        if not log.coordinated:
            np.testing.assert_array_equal(log.assignments, prev)
            assert "quorum miss" in log.events[0]
        assert log.counts.sum() == log.reported.sum()
        prev = log.assignments


def test_run_fleet_validation_messages_equal_reference(mesh, model, clients):
    jm = jax_build_model(jax_get_config(ARCH))
    jmesh = jfd.make_fleet_mesh(N)
    jopt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR))
    for kw in (dict(n_clusters=N + 1), dict(hier_k_local=2, eval_buckets=2),
               dict(hier_k_local=1, n_clusters=2)):
        with pytest.raises(ValueError) as ref:
            jfd.run_fleet(jm, jopt, jmesh, clients, rounds=1, **kw)
        with pytest.raises(ValueError) as got:
            tfd.run_fleet(model, _opt(), mesh, clients, rounds=1, **kw)
        assert str(got.value) == str(ref.value)


def test_run_fleet_two_ranks_equals_one_rank(two_rank_run, flat3):
    """2 gloo ranks of 4 clients and 1 rank of 8 from one seed: the same
    decisions every round, the final params within 1e-5."""
    one = flat3[0]
    out = [o["fleet"] for o in two_rank_run[1]]
    for r in range(2):
        np.testing.assert_array_equal(out[0]["assignments"][r], one.history[r].assignments)
        np.testing.assert_array_equal(out[1]["assignments"][r], one.history[r].assignments)
        np.testing.assert_array_equal(out[0]["applied"][r], one.history[r].applied_clusters)
    assert out[0]["eq2"] == out[1]["eq2"]


@pytest.fixture(scope="module")
def flat2(mesh, model, clients):
    return tfd.run_fleet(model, _opt(), mesh, clients, rounds=2, **RUN)


def test_run_fleet_two_ranks_params_match_one_rank(two_rank_run, flat2):
    out = [o["fleet"] for o in two_rank_run[1]]
    two = jax.tree.map(lambda *xs: np.concatenate(xs), out[0]["params"], out[1]["params"])
    _leaves_close(two, bridge.params_to_numpy(flat2.params), 1e-5, "2 ranks vs 1")
    for r in range(2):
        np.testing.assert_array_equal(out[0]["assignments"][r], flat2.history[r].assignments)


def test_run_fleet_matches_sim_engine_statistically(mesh, model, clients):
    """The fleet runs the sim protocol with other random streams: 4 rounds
    of 10 local steps both learn past the 5-class floor and their last
    two rounds agree within 0.2 (the reference's bounds)."""
    res = tfd.run_fleet(model, _opt(), mesh, clients, rounds=4, local_steps=10, batch_size=8,
                        seed=0)
    fleet = res.mean_val_accs
    cfg = teng.EngineConfig(model=model, opt=_opt(), local_steps=10, batch_size=8, lr=LR,
                            aggregation="bso", n_clusters=K, p1=0.9, p2=0.8, kmeans_iters=20)
    state = teng.make_swarm_state(model, cfg.opt, clients, 0, device="cpu")
    _, ms = teng.run_rounds(state, teng.make_swarm_data(model.cfg, clients, device="cpu"), cfg, 4)
    sim = ms.mean_val_acc.tolist()
    assert np.mean(fleet[-2:]) > 0.25, (fleet, sim)
    assert np.mean(sim[-2:]) > 0.25, (fleet, sim)
    assert abs(np.mean(fleet[-2:]) - np.mean(sim[-2:])) < 0.2, (fleet, sim)


def test_fleet_ckpt_to_serve_lm_e2e(mesh, tmp_path):
    """An LM swarm (granite-3-2b's smoke config on 4 token clients)
    through run_fleet, its checkpoint, serve.load_checkpoint and
    generate on the CPU."""
    lm = build_model(get_config("granite-3-2b").smoke())
    cl = make_token_swarm_data(4, lm.cfg.vocab_size, n_seqs=8, seq_len=16)
    p = str(tmp_path / "lm_fleet")
    res = tfd.run_fleet(lm, make_optimizer(OptimizerConfig(name="adam", lr=1e-3)), mesh, cl,
                        rounds=1, local_steps=2, batch_size=4, n_clusters=2, eval_batch=2,
                        ckpt_path=p)
    assert np.isfinite(res.history[0].train_loss)
    m2, params = serve.load_checkpoint(p, device="cpu")
    assert m2.cfg == lm.cfg
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, lm.cfg.vocab_size, size=n) for n in (3, 8)]
    out = serve.generate(m2, params, prompts, max_new_tokens=5, buckets=(BucketSpec(2, 16),),
                         device="cpu")
    assert all(len(r.tokens) == 5 for r in out)


def test_main_runs_on_the_cpu_and_needs_a_card_otherwise(mesh, monkeypatch, capsys):
    res = tfd.main(["--device", "cpu", "--clients", "4", "--rounds", "1", "--local-steps", "1",
                    "--image-size", "8"])
    assert len(res.history) == 1
    assert "[fleet] 4 clients on 1 gloo ranks" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfd.main(["--rounds", "1"])
    with pytest.raises(ValueError, match="NCCL mesh needs a CUDA device"):
        tfd.make_unit_fleet(4, device="cpu", backend="nccl")


def test_run_fleet_resumes_from_a_given_state(mesh, model, clients, flat2):
    """``state=`` resumes from a client stack: the seeded init handed in
    gives the seeded run bitwise, and a result's state resumes from its
    params and optimizer state (the caller's tensors left as they were)."""
    gen = torch.Generator().manual_seed(0)
    sp = tree_stack([model.init(gen) for _ in range(N)])
    opt = _opt()
    res = tfd.run_fleet(model, opt, mesh, clients, rounds=2,
                        state=(sp, teng.init_opt_state(opt, sp)), **RUN)
    assert _equal_trees(res.params, flat2.params)
    for a, b in zip(res.history, flat2.history):
        np.testing.assert_array_equal(a.assignments, b.assignments)
    before = tree_map(torch.clone, flat2.params)
    more = tfd.run_fleet(model, _opt(), mesh, clients, rounds=1,
                         state=(flat2.params, flat2.opt_state), **RUN)
    assert _equal_trees(flat2.params, before)
    assert not _equal_trees(more.params, flat2.params)
    assert torch.equal(more.opt_state["step"], flat2.opt_state["step"] + LOCAL_STEPS)
