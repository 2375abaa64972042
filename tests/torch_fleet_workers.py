"""Rank entry points of the fleet tests (``tests/test_torch_fleet.py``),
run in processes that ``repro_torch.launch.mesh.spawn_cpu_ranks`` spawns
and joins over gloo. This module imports only torch, numpy and
``repro_torch`` (never JAX): a spawned rank imports it to find its
function. Inputs and results travel as pickled numpy trees in files the
test names; rank r writes ``{out}/rank{r}.pkl``."""
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(out_dir, rank, result):
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def _slice(tree, sl):
    if isinstance(tree, dict):
        return {k: _slice(v, sl) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_slice(v, sl) for v in tree]
    return tree[sl]


def _eq2_cases(rank, world, d, group):
    """Eq. 2 over ``world`` ranks on the rank's slice of ``d``'s inputs:
    plain, masked, the singleton plan (bitwise the identity) and the
    census of each."""
    from repro_torch.core.aggregation import cluster_fedavg_psum, cluster_fedavg_psum_masked
    from repro_torch.utils.collectives import CENSUS
    from repro_torch.utils.tree import tree_leaves

    n = d["assignments"].shape[0]
    sl = slice(rank * n // world, (rank + 1) * n // world)
    x = bridge.tree_from_numpy(_slice(d["tree"], sl))
    a = torch.as_tensor(d["assignments"][sl])
    w = torch.as_tensor(d["weights"][sl])
    out = {}
    mark = CENSUS.mark()
    out["psum"] = bridge.tree_to_numpy(cluster_fedavg_psum(x, a, w, k=n, group=group))
    out["census"] = [tuple(e) for e in CENSUS.since(mark)]
    out["masked"] = bridge.tree_to_numpy(cluster_fedavg_psum_masked(
        x, a, torch.as_tensor(d["eff_weights"][sl]), torch.as_tensor(d["present"][sl]), k=n,
        group=group))
    ones = torch.ones(a.shape, dtype=torch.bool)
    masked_ones = cluster_fedavg_psum_masked(x, a, w * 1.0, ones, k=n, group=group)
    plain = cluster_fedavg_psum(x, a, w, k=n, group=group)
    out["allones_bitwise"] = all(torch.equal(p, q) for p, q in
                                 zip(tree_leaves(masked_ones), tree_leaves(plain)))
    single = cluster_fedavg_psum(x, torch.arange(sl.start, sl.stop, dtype=torch.int32), w, k=n,
                                 group=group)
    out["singleton_bitwise"] = all(torch.equal(p, q) for p, q in
                                   zip(tree_leaves(single), tree_leaves(x)))
    return out


def two_ranks(rank, in_path, out_dir):
    """The 2-rank checks: Eq. 2, one two-tier round (one pod a rank)
    against the reference's stacked two-pod round, and a 2-round flat
    ``run_fleet`` with its final params."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core.engine import make_fleet_round
    from repro_torch.data.dr import make_dr_swarm_data
    from repro_torch.launch.fleet_driver import run_fleet
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer

    d = _load(in_path)
    group = dist.group.WORLD
    result = {"eq2": _eq2_cases(rank, 2, d["eq2"], group)}

    h = d["hier"]
    n = h["weights"].shape[0]
    sl = slice(rank * n // 2, (rank + 1) * n // 2)
    model = build_model(get_config(h["arch"]))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=h["lr"], eps=h["eps"]))
    step = make_fleet_round(model, opt, n, h["local_steps"], group=group,
                            hier_k_local=h["k_local"])
    sp, _, out = step(bridge.tree_from_numpy(_slice(h["params"], sl)),
                      bridge.tree_from_numpy(_slice(h["opt"], sl)),
                      bridge.tree_from_numpy(_slice(h["batch"], sl)),
                      bridge.tree_from_numpy(_slice(h["val"], sl)), h["lr"],
                      torch.as_tensor(h["g"]), torch.tensor(True),
                      torch.as_tensor(h["clusters0"][sl]), torch.as_tensor(h["a_prev"][sl]),
                      torch.as_tensor(h["pod_init_idx"][rank:rank + 1]),
                      torch.as_tensor(h["weights"][sl]))
    result["hier"] = {"params": bridge.tree_to_numpy(sp),
                      "out": {f: np.asarray(getattr(out, f)) for f in out._fields}}

    f = d["fleet"]
    clients = make_dr_swarm_data(image_size=f["image_size"], seed=0, table=f["table"])
    model = build_model(get_config(f["arch"]))
    mesh = make_fleet_mesh(len(clients), device="cpu")
    res = run_fleet(model, make_optimizer(OptimizerConfig(name="adam", lr=2e-3)), mesh, clients,
                    **f["kw"])
    result["fleet"] = {"assignments": [log.assignments for log in res.history],
                       "applied": [log.applied_clusters for log in res.history],
                       "params": bridge.tree_to_numpy(res.params),
                       "eq2": res.comm["eq2_collective_bytes"]}
    _dump(out_dir, rank, result)


def three_ranks(rank, in_path, out_dir):
    """The 3-rank checks, one client a rank: ``cluster_psum_fedavg`` on
    the rank's unstacked tree, and the stacked Eq. 2 on its 1-client
    slice."""
    from repro_torch.core.aggregation import cluster_psum_fedavg

    d = _load(in_path)
    group = dist.group.WORLD
    result = {"eq2": _eq2_cases(rank, 3, d, group)}
    one = bridge.tree_from_numpy(_slice(d["tree"], rank))
    got = cluster_psum_fedavg(one, torch.as_tensor(d["weights"][rank]),
                              torch.as_tensor(d["assignments"][rank]), k=3, group=group)
    result["one_client"] = bridge.tree_to_numpy(got)
    _dump(out_dir, rank, result)


def _full_numpy(tree):
    from repro_torch.sharding.rules import is_placed
    from repro_torch.utils.tree import tree_map
    return bridge.tree_to_numpy(tree_map(lambda x: x.full_tensor() if is_placed(x) else x, tree))


def placed_fleet(rank, in_path, out_dir):
    """The placed fleet (``fleet_setup(spmd="auto")``) on a 4-rank world,
    for each pod mesh shape of the inputs: the rounds on this rank's pod
    slice with the injected decisions, each round's params, optimizer
    state and stats (whole, ``full_tensor``) and its census. On the first
    shape also: the churn surface with all-ones masks from the initial
    state, the two-tier surface (one pod a pod group), and the
    ``shard_map`` path over the pod group (world 2) on the same rounds."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.launch.mesh import FleetMesh, make_pod_mesh
    from repro_torch.launch.swarm_fleet import fleet_setup
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.collectives import CENSUS

    d = _load(in_path)
    model = build_model(get_config(d["arch"]).smoke())
    opt = make_optimizer(OptimizerConfig(name="adam", lr=d["lr"], eps=d["eps"]))
    n, k, steps = d["weights"].shape[0], d["k"], d["local_steps"]
    result = {}
    for si, shape in enumerate(d["shapes"]):
        dm = make_pod_mesh(shape)
        pod = int(dm.get_coordinate()[0])
        sl = slice(pod * n // shape[0], (pod + 1) * n // shape[0])
        w = torch.as_tensor(d["weights"][sl])

        def state():
            return (bridge.params_from_numpy(_slice(d["params"], sl)),
                    bridge.opt_state_from_numpy(_slice(d["opt"], sl)))

        def batch(r):
            return bridge.tree_from_numpy(_slice(d["batches"][r], sl))

        prog = fleet_setup(model, opt, dm, k=k, n_local_steps=steps, spmd="auto")
        sp, so = (prog.place(t) for t in state())
        rounds = []
        for r, clusters in enumerate(d["clusters"]):
            mark = CENSUS.mark()
            sp, so, stats = prog.step(sp, so, batch(r), d["lr"],
                                      torch.as_tensor(clusters[sl]), w)
            rounds.append({"params": _full_numpy(sp), "opt": _full_numpy(so),
                           "stats": stats.numpy(), "local": [tuple(x.to_local().shape) for x in
                                                            _leaves_of(sp)],
                           "census": [tuple(e) for e in CENSUS.since(mark)]})
        out = {"pod": pod, "coord": [int(c) for c in dm.get_coordinate()], "rounds": rounds}
        if si == 0:
            ones = torch.ones(sl.stop - sl.start, dtype=torch.bool)
            churn = fleet_setup(model, opt, dm, k=k, n_local_steps=steps, spmd="auto",
                                with_churn=True)
            cp, _, cstats = churn.step(*(churn.place(t) for t in state()), batch(0), d["lr"],
                                       torch.as_tensor(d["clusters"][0][sl]), w * 1.0, ones, ones)
            out["churn"] = {"params": _full_numpy(cp), "stats": cstats.numpy()}
            h = d["hier"]
            hier = fleet_setup(model, opt, dm, k=k, n_local_steps=steps, spmd="auto",
                               hier_k_local=h["k_local"])
            hp, _, ho = hier.step(*(hier.place(t) for t in state()), batch(0),
                                  bridge.tree_from_numpy(_slice(h["val"], sl)), d["lr"],
                                  torch.as_tensor(h["g"]), torch.tensor(True),
                                  torch.arange(sl.start, sl.stop, dtype=torch.int32),
                                  torch.as_tensor(h["a_prev"][sl]),
                                  torch.as_tensor(h["pod_init_idx"][pod:pod + 1]), w)
            out["hier"] = {"params": _full_numpy(hp),
                           "out": {f: np.asarray(getattr(ho, f)) for f in ho._fields}}
            fm = FleetMesh(group=dm.get_group("pod"), rank=pod, world=shape[0],
                           device=torch.device("cpu"))
            flat = fleet_setup(model, opt, fm, k=k, n_local_steps=steps).step
            fp, fo = state()
            sm = []
            for r, clusters in enumerate(d["clusters"]):
                fp, fo, fstats = flat(fp, fo, batch(r), d["lr"], torch.as_tensor(clusters[sl]), w)
                sm.append({"params": bridge.tree_to_numpy(fp), "stats": fstats.numpy()})
            out["shard_map"] = sm
        result[tuple(shape)] = out
    _dump(out_dir, rank, result)


def _leaves_of(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)
