"""Shared helpers of the port's parity tests (``test_torch_*.py``): the
reference's random draws, rebuilt from its JAX keys exactly as the
reference derives them, handed to the port as plain arrays."""
import jax
import jax.numpy as jnp
import numpy as np


def jax_bso_draws(key, k: int, n: int):
    """(r1, g, r2, g2) as ``repro.core.bso.brain_storm_jax`` draws them
    from ``key`` (bso.py, the split and per-cluster fold_in draws)."""
    k_rep, k_member, k_swap, k_other = jax.random.split(key, 4)
    ids = jnp.arange(k, dtype=jnp.uint32)
    r1 = jax.vmap(lambda c: jax.random.uniform(jax.random.fold_in(k_rep, c)))(ids)
    g = jax.vmap(lambda c: jax.random.gumbel(jax.random.fold_in(k_member, c), (n,)))(ids)
    r2 = jax.vmap(lambda c: jax.random.uniform(jax.random.fold_in(k_swap, c)))(ids)
    g2 = jax.vmap(lambda c: jax.vmap(lambda o: jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(k_other, c), o)))(ids))(ids)
    return tuple(np.array(t) for t in (r1, g, r2, g2))


def jax_kmeans_init_idx(key, X, k: int) -> np.ndarray:
    """The rows of ``X`` that ``repro.core.kmeans.kmeans_pp_init`` picks
    from ``key``: each seed centroid is a copy of one row."""
    from repro.core.kmeans import kmeans_pp_init
    C0 = np.asarray(kmeans_pp_init(key, jnp.asarray(X), k))
    X = np.asarray(X)
    idx = [int(np.flatnonzero((X == c).all(axis=1))[0]) for c in C0]
    return np.asarray(idx, np.int64)
