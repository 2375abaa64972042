"""The placed fleet (``repro_torch.launch.swarm_fleet``, ``spmd="auto"``)
against the JAX reference on the CPU.

``fleet_inner_rules`` against the reference's mapping; two rounds of
granite-3-2b's smoke config on 4 spawned gloo ranks (one pod mesh of
(2,2,1) and one of (2,1,2), ``tests/torch_fleet_workers.placed_fleet``)
against the reference's whole-stack ``make_fleet_round(axis_name=None)``
on the same inputs and injected decisions (the reference's own test of
its GSPMD path is red), and against the port's ``shard_map`` path over
the pod group; the churn surface with all-ones masks; one two-tier round
against the reference's ``hier_pods=2``; the stat upload's shard merge
on uneven and empty shards; ``lower_fleet_round``'s census on a fake
(2,2,2) mesh and at world 1 (in a subprocess: a process group is
process-wide); and ``fleet_setup``'s refusals.
"""
import json
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.launch import swarm_fleet as jsf  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import OptimizerConfig, get_config  # noqa: E402
from repro_torch.core.diststats import merge_shard_stats  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh, make_pod_mesh, spawn_cpu_ranks  # noqa: E402
from repro_torch.launch.swarm_fleet import fleet_inner_rules, fleet_setup  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_fleet_workers import placed_fleet  # noqa: E402
from torch_parity import jax_kmeans_init_idx, pin_torch_threads, subprocess_env  # noqa: E402

pin_torch_threads()

ARCH = "granite-3-2b"
N = 4
K = 2
LR = 2e-3
EPS = 1e-6               # adam's eps of the round parity tests (ROADMAP C)
LOCAL_STEPS = 2
ROWS = 4                 # a client's rows a round: 2 a local step
SEQ = 16
SHAPES = ((2, 2, 1), (2, 1, 2))
CLUSTERS = (np.array([0, 1, 1, 0], np.int32), np.array([1, 1, 0, 0], np.int32))
WEIGHTS = np.array([3.0, 1.0, 2.0, 5.0], np.float32)
K_LOCAL = 2
HIER_PODS = 2
G = np.array([0, 1, 1, 0], np.int32)          # G[A_PREV] == CLUSTERS[0]
A_PREV = np.array([0, 1, 2, 3], np.int32)
KMKEY_SEED = 9
SRC = Path(__file__).resolve().parent.parent / "src"


def _leaves_close(got, expect, atol, what):
    got, expect = tree_paths_and_leaves(got), tree_paths_and_leaves(expect)
    assert [p for p, _ in got] == [p for p, _ in expect]
    for (p, a), (_, b) in zip(got, expect):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
                                   atol=atol, err_msg=f"{what} {p}")


def _rows(tree, sl):
    return jax.tree.map(lambda x: np.asarray(x)[sl], tree)


def test_fleet_inner_rules_match_reference():
    assert fleet_inner_rules().logical_to_physical == \
        {k: tuple(v) for k, v in jsf.fleet_inner_rules().logical_to_physical.items()}
    assert not any("pod" in v for v in fleet_inner_rules().logical_to_physical.values())


@pytest.fixture(scope="module")
def census_proc():
    """:data:`_CENSUS_CODE` started in a subprocess at once, so that it
    runs beside the spawned ranks (a process group is process-wide)."""
    env = {**subprocess_env(), "PYTHONPATH": str(SRC)}
    proc = subprocess.Popen([sys.executable, "-c", _CENSUS_CODE], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def runs(census_proc, tmp_path_factory):
    """The reference's smoke swarm, its two rounds (whole stack,
    ``axis_name=None``) on the injected decisions and one two-tier round
    (``hier_pods=2``) seeded from the first round's stats; beside the
    second round and the two-tier one, one spawn of 4 gloo ranks running
    ``placed_fleet`` on both pod mesh shapes from the same inputs.
    Returns (reference, {shape: [rank results]})."""
    jcfg = jax_get_config(ARCH).smoke()
    jmodel = jax_build_model(jcfg)
    jopt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=LR, eps=EPS))
    sp = jax.vmap(jmodel.init)(jax.random.split(jax.random.PRNGKey(0), N))
    so = jax.vmap(jopt.init)(sp)
    rng = np.random.default_rng(0)
    batches = []
    for _ in CLUSTERS:
        toks = rng.integers(0, jcfg.vocab_size, (N, ROWS, SEQ), dtype=np.int32)
        batches.append({"tokens": toks, "labels": toks})
    vt = rng.integers(0, jcfg.vocab_size, (N, 1, 2, SEQ), dtype=np.int32)
    val = {"tokens": vt, "labels": vt}
    step = jax.jit(jeng.make_fleet_round(jmodel, jopt, K, LOCAL_STEPS))

    def ref_round(p, o, r):
        return step(p, o, jax.tree.map(jnp.asarray, batches[r]), jnp.float32(LR),
                    jnp.asarray(CLUSTERS[r]), jnp.asarray(WEIGHTS))

    p, o, stats = ref_round(sp, so, 0)
    rounds = [jax.tree.map(np.asarray, {"params": p, "opt": o, "stats": stats})]
    m = N // HIER_PODS
    kmkey = jax.random.PRNGKey(KMKEY_SEED)
    pod_idx = np.stack([jax_kmeans_init_idx(jax.random.fold_in(kmkey, q),
                                            rounds[0]["stats"][q * m:(q + 1) * m], K_LOCAL)
                        for q in range(HIER_PODS)])
    ref = {"params": jax.tree.map(np.asarray, sp), "opt": jax.tree.map(np.asarray, so),
           "rounds": rounds}

    d = tmp_path_factory.mktemp("placed")
    inputs = {"arch": ARCH, "lr": LR, "eps": EPS, "k": K, "local_steps": LOCAL_STEPS,
              "shapes": SHAPES, "weights": WEIGHTS, "clusters": CLUSTERS,
              "params": ref["params"], "opt": ref["opt"], "batches": batches,
              "hier": {"k_local": K_LOCAL, "val": val, "g": G, "a_prev": A_PREV,
                       "pod_init_idx": pod_idx}}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn_cpu_ranks, placed_fleet, 4, str(d / "in.pkl"), str(d))
        p, o, stats = ref_round(p, o, 1)
        rounds.append(jax.tree.map(np.asarray, {"params": p, "opt": o, "stats": stats}))
        hp, _, ho = jax.jit(jeng.make_fleet_round(jmodel, jopt, K, LOCAL_STEPS,
                                                  hier_k_local=K_LOCAL, hier_pods=HIER_PODS))(
            sp, so, jax.tree.map(jnp.asarray, batches[0]), jax.tree.map(jnp.asarray, val),
            jnp.float32(LR), jnp.asarray(G), jnp.asarray(True), jnp.arange(N, dtype=jnp.int32),
            jnp.asarray(A_PREV), kmkey, jnp.asarray(WEIGHTS))
        ref["hier"] = jax.tree.map(np.asarray, {"params": hp, "out": ho._asdict()})
        spawned.result()
    out = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return ref, {shape: [o[shape] for o in out] for shape in SHAPES}


@pytest.fixture(scope="module")
def ref_run(runs):
    return runs[0]


@pytest.fixture(scope="module")
def placed_run(runs):
    return runs[1]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_placed_rounds_match_reference_whole_stack(placed_run, ref_run, shape):
    """Each rank's pod after each of two rounds: params, adam state and
    stats within 1e-5 of the reference's whole-stack rounds; the pod's
    ranks hold the same values; Eq. 2's census is 1 + #leaves
    all-reduces of this rank's shard sums, and the upload merge one
    all-gather of (count, mean, var) a leaf."""
    m = N // shape[0]
    for res in placed_run[shape]:
        sl = slice(res["pod"] * m, (res["pod"] + 1) * m)
        for r, (got, want) in enumerate(zip(res["rounds"], ref_run["rounds"])):
            _leaves_close(got["params"], _rows(want["params"], sl), 1e-5, f"round {r} params")
            _leaves_close(got["opt"], _rows(want["opt"], sl), 1e-5, f"round {r} opt")
            np.testing.assert_allclose(got["stats"], want["stats"][sl], rtol=0, atol=1e-5)
            eq2 = [e for e in got["census"] if e[2] == "eq2"]
            shard = sum(4 * K * int(np.prod(s[1:])) for s in got["local"])
            assert len(eq2) == 1 + len(got["local"]) and all(e[0] == "all_reduce" for e in eq2)
            assert sum(e[1] for e in eq2) == 4 * K + shard
            merge = [e for e in got["census"] if e[2] == "stats_merge"]
            assert merge == [("all_gather", 8 * 3 * m * len(got["local"]), "stats_merge")]
    for pod in range(shape[0]):
        same = [res for res in placed_run[shape] if res["pod"] == pod]
        for res in same[1:]:
            _leaves_close(res["rounds"][-1]["params"], same[0]["rounds"][-1]["params"], 0.0,
                          "pod replicas")
    if shape[1] > 1 or shape[2] > 1:
        assert any(tuple(s) != tuple(f) for s, f in
                   zip(placed_run[shape][0]["rounds"][0]["local"],
                       [np.shape(x) for _, x in tree_paths_and_leaves(
                           _rows(ref_run["params"], slice(0, m)))])), "nothing was split"


def test_placed_rounds_match_shard_map_path(placed_run):
    """The port's shard_map path over the pod group (world 2) on the same
    rounds: params within 1e-5, stats within 1e-5."""
    for res in placed_run[SHAPES[0]]:
        for got, sm in zip(res["rounds"], res["shard_map"]):
            _leaves_close(got["params"], sm["params"], 1e-5, "auto vs shard_map")
            np.testing.assert_allclose(got["stats"], sm["stats"], rtol=0, atol=1e-5)


def test_placed_allones_churn_is_bitwise_churn_free(placed_run):
    for res in placed_run[SHAPES[0]]:
        _leaves_close(res["churn"]["params"], res["rounds"][0]["params"], 0.0, "churn params")
        np.testing.assert_array_equal(res["churn"]["stats"], res["rounds"][0]["stats"])


def test_placed_hier_round_matches_reference(placed_run, ref_run):
    """The two-tier surface, one pod a pod group, against the reference's
    stacked round over 2 pods: a_local and counts equal, summaries and
    params within 1e-5, the means equal on every rank."""
    m = N // HIER_PODS
    want = ref_run["hier"]
    for res in placed_run[SHAPES[0]]:
        pod, h = res["pod"], res["hier"]
        rows = slice(pod * K_LOCAL, (pod + 1) * K_LOCAL)
        _leaves_close(h["params"], _rows(want["params"], slice(pod * m, (pod + 1) * m)), 1e-5,
                      "hier params")
        np.testing.assert_array_equal(h["out"]["a_local"], want["out"]["a_local"][pod * m:
                                                                                  (pod + 1) * m])
        np.testing.assert_array_equal(h["out"]["counts"], want["out"]["counts"][rows])
        for f in ("centroids", "wsums", "valsums"):
            np.testing.assert_allclose(h["out"][f], want["out"][f][rows], rtol=1e-6, atol=1e-5,
                                       err_msg=f)
        for f in ("mean_val", "train_loss"):
            assert abs(float(h["out"][f]) - float(want["out"][f])) <= 1e-6, f


def _split(x, sizes):
    return list(torch.split(x, sizes, dim=1))


@pytest.mark.parametrize("sizes", [(5, 5), (3, 7), (4, 0, 6), (1, 2, 7), (10, 0)])
def test_shard_merge_equals_whole_stats(sizes):
    """The upload merge of a leaf split by hand (even, uneven, with an
    empty shard) against the plain stats of the whole leaf: within 1e-5
    relative; an empty shard's NaN adds nothing."""
    x = torch.randn(3, 10, 4, generator=torch.Generator().manual_seed(len(sizes))) * 3 + 1.5
    shards = _split(x, list(sizes))
    stats = torch.stack([torch.stack(ref.param_stats_batched(s), -1) for s in shards])
    counts = torch.tensor([[s[0].numel()] * 3 for s in shards])
    got = merge_shard_stats(stats, counts)
    want = torch.stack(ref.param_stats_batched(x), -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(got).all()


def test_shard_merge_of_nothing_is_nan_and_var_is_clamped():
    stats = torch.full((2, 3, 2), float("nan"))
    got = merge_shard_stats(stats, torch.zeros((2, 3)))
    assert torch.isnan(got).all()
    const = torch.stack([torch.tensor([[2.0, -1e-9]]), torch.tensor([[2.0, 0.0]])])
    assert merge_shard_stats(const, torch.tensor([[4], [4]]))[0, 1] == 0.0


_CENSUS_CODE = r"""
import json, sys, torch
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.engine import make_fleet_round
from repro_torch.launch import dryrun, swarm_fleet as sf
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.models.model import abstract_params, build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding.rules import distribute_stacked
from repro_torch.utils.tree import tree_leaves
torch.set_num_threads(1)
rec = sf.lower_fleet_round("granite-3-2b", k=3, seq=16, per_client_batch=4,
                           mesh_shape=(2, 2, 2), smoke=True)
out = {"rec": rec}
cfg = sf.fleet_runtime_config("granite-3-2b", smoke=True)
for L in rec["probe_layers"]:
    pcfg = dryrun._probe_cfg(cfg, L)
    params = abstract_params(pcfg)
    with dryrun.fake_world(8):
        dm = make_pod_mesh((2, 2, 2))
        inner = dm["data", "model"]
        placed = distribute_stacked(sf._stacked_meta(params, 1), inner, sf.fleet_inner_rules())
        out[str(L)] = [list(x.to_local().shape) for x in tree_leaves(placed)]
pcfg = dryrun._probe_cfg(cfg, 2)
oc = OptimizerConfig(name="adamw", lr=3e-4)
with dryrun.fake_world(1):
    w1 = sf.fleet_round_census(pcfg, oc, make_pod_mesh((1, 1, 1)), n_clients=2,
                               per_client_batch=4, seq=16, k=3, n_local_steps=2)
model, opt = build_model(pcfg), make_optimizer(oc)
pa = abstract_params(pcfg)
meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
batch = {k: meta((2, 4, 16), torch.int32) for k in ("tokens", "labels")}
census = dryrun.Census()
with census:
    make_fleet_round(model, opt, 3, 2)(sf._stacked_meta(pa, 2), sf._stacked_meta(opt.init(pa), 2),
                                       batch, 3e-4, meta((2,), torch.int32),
                                       meta((2,), torch.float32))
out["world1_flops"], out["unplaced_flops"] = w1["flops"], census.flops
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def census_run(census_proc):
    out, err = census_proc.communicate(timeout=300)
    assert census_proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_lower_fleet_round_census_on_a_fake_2x2x2_mesh(census_run):
    """At each probe depth: the pod axis carries only Eq. 2's all-reduces,
    1 + #leaves of them, of 4 * k * (1 + the rank's shard elements) bytes;
    DTensor's FSDP / tensor-parallel collectives ride data and model;
    the merge is one all-gather; the record extrapolates to the depth."""
    rec = census_run["rec"]
    assert rec["mesh"] == "2x2x2" and rec["n_clients"] == 2 and rec["n_layers"] == 2
    for L in map(str, rec["probe_layers"]):
        p, shards = rec["probes"][L], census_run[L]
        want = 4 * 3 * (1 + sum(int(np.prod(s[1:])) for s in shards))
        assert p["tags"]["eq2"] == {"count": 1 + len(shards), "bytes": want}
        assert p["by_axis"]["pod"] == {"allreduce_": {"count": 1 + len(shards), "bytes": want}}
        assert p["tags"]["stats_merge"] == {"count": 1, "bytes": 8 * 3 * len(shards)}
        assert p["by_axis"]["data_model"]["allgather_"] == {"count": 1,
                                                            "bytes": 8 * 3 * len(shards) * 4}
        assert p["by_axis"]["data"] and p["by_axis"]["model"]
        assert p["memory"]["params_bytes"] == 4 * sum(int(np.prod(s)) for s in shards)
    assert rec["cost"]["flops_per_device"] > 0 and rec["memory"]["argument_bytes"] > 0


def test_fleet_census_flops_at_world_one_equal_the_unplaced_round(census_run):
    assert census_run["world1_flops"] == census_run["unplaced_flops"] > 0


def test_fleet_setup_and_pod_mesh_refuse_other_layouts():
    """An spmd other than the two, "auto" on a FleetMesh and "shard_map"
    on anything else raise; a pod mesh needs three sizes, a process
    group, and a world of their product."""
    model = build_model(get_config(ARCH).smoke())
    opt = make_optimizer(OptimizerConfig(name="adam", lr=LR))
    with pytest.raises(ValueError, match="one of"):
        fleet_setup(model, opt, None, k=K, spmd="gspmd")
    with pytest.raises(ValueError, match="shard_map.*FleetMesh"):
        fleet_setup(model, opt, None, k=K)
    with pytest.raises(ValueError, match="three positive sizes"):
        make_pod_mesh((2, 2))
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_pod_mesh((1, 1, 1))
    mesh = make_fleet_mesh(N, device="cpu")
    try:
        with pytest.raises(ValueError, match="DeviceMesh"):
            fleet_setup(model, opt, mesh, k=K, spmd="auto")
        with pytest.raises(ValueError, match="needs a world of 2 ranks, got 1"):
            make_pod_mesh((2, 1, 1))
    finally:
        mesh.close()
