"""Shared helpers of the port's tests (``test_torch_*.py``): the torch
thread pool each test process runs on, and the reference's random
draws, rebuilt from its JAX keys exactly as the reference derives them,
handed to the port as plain arrays. JAX is imported inside the helpers
that use it, so that ``test_torch_cuda.py`` (run where JAX is not
installed) can import this module for :func:`pin_torch_threads`."""
import functools
import os

import numpy as np


def torch_thread_share() -> int:
    """This process's share of the cores: the cores it may run on over
    the pytest-xdist workers that run beside it (1 without xdist)."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // workers)


def pin_torch_threads() -> int:
    """Size torch's intra-op pool to :func:`torch_thread_share` and return
    it. Every ``test_torch_*.py`` calls this at import: pytest imports
    every test module of a worker at collection, so the pool is set once
    for the worker's whole session, whichever module runs first.

    The suite runs under ``pytest -n``: parallel workers, each with a
    pool as wide as the machine by default (48 threads for 6 workers on
    8 cores). A vmapped round is thousands of small ops, and each waits
    at the pool's barrier for threads that the other workers have
    preempted, so a round that takes seconds alone took minutes in the
    suite, and the spinning pools slowed the reference's JAX tests on
    the other workers too. Idempotent; the inter-op pool is left as it
    is (it cannot be resized once started)."""
    import torch

    n = torch_thread_share()
    if torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return n


def subprocess_env(env=None) -> dict:
    """``env`` (default ``os.environ``) with one OpenMP thread, for a
    process a port test starts: it runs beside the other workers too."""
    return {**(os.environ if env is None else env), "OMP_NUM_THREADS": "1"}


def jax_bso_draws(key, k: int, n: int):
    """(r1, g, r2, g2) as ``repro.core.bso.brain_storm_jax`` draws them
    from ``key`` (bso.py, the split and per-cluster fold_in draws)."""
    import jax
    import jax.numpy as jnp

    k_rep, k_member, k_swap, k_other = jax.random.split(key, 4)
    ids = jnp.arange(k, dtype=jnp.uint32)
    r1 = jax.vmap(lambda c: jax.random.uniform(jax.random.fold_in(k_rep, c)))(ids)
    g = jax.vmap(lambda c: jax.random.gumbel(jax.random.fold_in(k_member, c), (n,)))(ids)
    r2 = jax.vmap(lambda c: jax.random.uniform(jax.random.fold_in(k_swap, c)))(ids)
    g2 = jax.vmap(lambda c: jax.vmap(lambda o: jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(k_other, c), o)))(ids))(ids)
    return tuple(np.array(t) for t in (r1, g, r2, g2))


def jax_kmeans_init_idx(key, X, k: int, mask=None, weights=None) -> np.ndarray:
    """The rows of ``X`` that ``repro.core.kmeans.kmeans_pp_init`` picks
    from ``key`` (under the participation ``mask`` and the point
    ``weights``, if given): each seed centroid is a copy of one row.
    Without weights a seed is the first equal row. With weights it is
    looked up among the eligible rows only (positive weight, present),
    and the match must be unique: summary rows can coincide, and a
    zero-weight copy of an eligible row must not be taken for it."""
    import jax.numpy as jnp

    from repro.core.kmeans import kmeans_pp_init
    C0 = np.asarray(kmeans_pp_init(key, jnp.asarray(X), k,
                                   mask=None if mask is None else jnp.asarray(mask, bool),
                                   weights=None if weights is None else jnp.asarray(weights)))
    X = np.asarray(X)
    if weights is None:
        idx = [int(np.flatnonzero((X == c).all(axis=1))[0]) for c in C0]
        return np.asarray(idx, np.int64)
    eligible = np.asarray(weights) > 0
    if mask is not None:
        eligible &= np.asarray(mask, bool)
    idx = []
    for c in C0:
        hits = np.flatnonzero((X == c).all(axis=1) & eligible)
        assert len(hits) == 1, f"seed row matches {len(hits)} eligible rows"
        idx.append(int(hits[0]))
    return np.asarray(idx, np.int64)


@functools.lru_cache(maxsize=None)
def _jit_pod_summaries():
    import jax

    from repro.core.engine import pod_summaries
    return jax.jit(pod_summaries, static_argnums=(4, 5, 7))


def jax_pod_summaries(feats, val, weights, present, k_local: int, kmeans_iters: int, key, pods):
    """The reference's ``engine.pod_summaries``, jitted once per static
    (k_local, kmeans_iters, pods), as its round runs it."""
    return _jit_pod_summaries()(feats, val, weights, present, k_local, kmeans_iters, key, pods)


def jax_hier_keys(k_kmeans, n_pods: int):
    """(pod keys, global key) as the reference's two-tier coordinator
    derives them from the round's k-means key
    (``engine._hier_coordinate_and_aggregate``): ``k_pods, k_global =
    split(k_kmeans)``, and pod p seeds from ``fold_in(k_pods, p)``."""
    import jax

    k_pods, k_global = jax.random.split(k_kmeans)
    return [jax.random.fold_in(k_pods, p) for p in range(n_pods)], k_global


def jax_hier_draws(k_kmeans, k_bso, feats, present, pods, k_local: int, k: int,
                   kmeans_iters: int):
    """The reference's two-tier round draws, as the port's ``RoundDraws``
    takes them: ``(pod seed rows (P, k_local), local to each pod;
    global seed rows (k,) among the P * k_local summary rows; brain-storm
    draws over those rows from k_bso)``. The global seed rows are found
    in the reference's own summaries (``pod_summaries`` from the same
    pod key, its weights the member counts); ``feats`` are the round's
    (N, F) stats after the local phase."""
    import jax
    import jax.numpy as jnp

    feats = np.asarray(feats)
    pod_keys, k_global = jax_hier_keys(k_kmeans, len(pods))
    pod_idx = np.stack([
        jax_kmeans_init_idx(pod_keys[p], feats[list(ids)], k_local,
                            mask=None if present is None else np.asarray(present)[list(ids)])
        for p, ids in enumerate(pods)])
    n = feats.shape[0]
    C, counts, _, _, _ = jax_pod_summaries(
        jnp.asarray(feats), jnp.zeros((n,)), jnp.ones((n,)),
        None if present is None else jnp.asarray(present, bool), k_local, kmeans_iters,
        jax.random.split(k_kmeans)[0], pods)
    g_idx = jax_kmeans_init_idx(k_global, C, k, weights=counts)
    return pod_idx, g_idx, jax_bso_draws(k_bso, k, len(pods) * k_local)


def assert_lm_round_matches_reference(jcfg, cfg, clients, *, k: int, lr: float, local_steps: int,
                                      batch: int, eps: float):
    """One BSO-SL round of the LM ``jcfg`` (the reference's config) and
    ``cfg`` (the port's, built from its asdict) from the reference's
    fresh state, its batch rows, k-means++ seeds and brain-storm draws
    injected into the port's ``swarm_round``; adam at ``eps``. val_acc
    within 1e-6 (token accuracy is a ratio of argmax hits, equal unless a
    logit tie flips), assignments, centers and events equal, train loss
    (the router's aux included for moe) within 1e-4 relative, params
    within atol 1e-4 (5% of one adam step at lr 2e-3)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
    from repro.core import engine as jeng
    from repro.core.diststats import swarm_distribution_matrix as jax_feats
    from repro.models import build_model as jax_build_model
    from repro.optim.optimizers import make_optimizer as jax_make_optimizer
    from repro.train.steps import make_train_step as jax_make_train_step
    from repro_torch.bridge import params_to_numpy, state_from_numpy
    from repro_torch.configs import OptimizerConfig
    from repro_torch.core import engine as teng
    from repro_torch.core.bso import BSODraws
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.utils.tree import tree_paths_and_leaves

    n = len(clients)
    jmodel = jax_build_model(jcfg)
    jopt = jax_make_optimizer(JaxOptimizerConfig(name="adam", lr=lr, eps=eps))
    jecfg = jeng.EngineConfig(model=jmodel, opt=jopt, local_steps=local_steps, batch_size=batch,
                              lr=lr, aggregation="bso", n_clusters=k, p1=0.9, p2=0.8,
                              kmeans_iters=20)
    jdata = jeng.make_swarm_data(jcfg, clients)
    state0 = jax.tree.map(np.asarray, jax.jit(
        lambda key: jeng.make_swarm_state(jmodel, jopt, clients, key))(jax.random.PRNGKey(0)))
    jstate = jax.tree.map(jnp.asarray, state0)
    _, k_local, k_kmeans, k_bso = jax.random.split(jstate.key, 4)
    sample_keys = jax.random.split(k_local, local_steps)
    batch_idx = np.stack([np.asarray(jax.random.randint(kt, (n, batch), 0,
                                                        jdata.train_n[:, None]))
                          for kt in sample_keys])
    step = jax_make_train_step(jmodel, jopt)
    feats = jax.jit(lambda s: jax_feats(jeng.local_phase(
        step, s.params, s.opt_state, lr, sample_keys,
        lambda kt: jeng.sample_round_batch(kt, jdata, batch))[0]))(jstate)
    draws = teng.RoundDraws(
        batch_idx=torch.from_numpy(batch_idx),
        kmeans_init_idx=torch.from_numpy(jax_kmeans_init_idx(k_kmeans, feats, k)),
        bso=BSODraws(*(torch.from_numpy(t) for t in jax_bso_draws(k_bso, k, n))))

    jnew, jm = jeng.jit_swarm_round(jstate, jdata, jecfg)

    tcfg = teng.EngineConfig(
        model=build_model(cfg), opt=make_optimizer(OptimizerConfig(name="adam", lr=lr, eps=eps)),
        local_steps=local_steps, batch_size=batch, lr=lr, aggregation="bso", n_clusters=k,
        p1=0.9, p2=0.8, kmeans_iters=20)
    tstate = state_from_numpy(state0._asdict(), "cpu")
    tnew, tm = teng.swarm_round(tstate, teng.make_swarm_data(cfg, clients, device="cpu"), tcfg,
                                draws=draws)

    np.testing.assert_array_equal(tm.assignments.numpy(), np.asarray(jm.assignments))
    np.testing.assert_array_equal(tm.centers.numpy(), np.asarray(jm.centers))
    assert int(tm.n_replaced) == int(jm.n_replaced)
    assert int(tm.n_swapped) == int(jm.n_swapped)
    np.testing.assert_allclose(tm.val_acc.numpy(), np.asarray(jm.val_acc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tm.train_loss), float(jm.train_loss), rtol=1e-4)
    jp = jax.tree.map(np.asarray, jnew.params)
    tp = params_to_numpy(tnew.params)
    pairs = list(zip(tree_paths_and_leaves(tp), tree_paths_and_leaves(jp)))
    assert len(pairs) == len(tree_paths_and_leaves(jp)) == len(tree_paths_and_leaves(tp))
    for (path, a), (jpath, b) in pairs:
        assert path == jpath
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=path)
    np.testing.assert_array_equal(tnew.opt_state["step"].numpy(),
                                  np.asarray(jnew.opt_state["step"]))
