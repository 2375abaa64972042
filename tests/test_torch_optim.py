"""The port's optimizers and train step against the JAX reference.

The optimizer runs inside the client vmap in both packages, so the
global-norm clip and adam's step count are per client."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils.tree import tree_global_norm as jax_global_norm  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy, opt_state_to_numpy,  # noqa: E402
                                params_from_numpy, params_to_numpy)
from repro_torch.configs import OptimizerConfig, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.steps import make_eval_step, make_train_step  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402

N_CLIENTS = 3
LR = 2e-3


def _client_params():
    """Three clients' squeezenet weights, stacked, from the reference."""
    init = jax_build_model(jax_get_config("squeezenet-dr")).init
    return jax.jit(jax.vmap(init))(jax.random.split(jax.random.PRNGKey(0), N_CLIENTS))


def _small_params():
    """Three clients' small conv-and-dense tree (the optimizers see only
    leaves, so a small tree keeps the reference's compiles short)."""
    rng = np.random.default_rng(0)
    shapes = {"conv": {"w": (3, 3, 2, 4), "b": (4,)}, "fc": {"w": (8, 5), "b": (5,)}}
    return jax.tree.map(lambda s: jnp.asarray(rng.normal(size=(N_CLIENTS,) + s), jnp.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


@jax.jit
def _grads(params, step):
    """Per-client gradient-shaped trees of very different norms, so a
    clip set between them clips some clients and not others."""
    scales = jnp.asarray([0.02, 1.0, 40.0])[:, None]
    leaves, tree = jax.tree_util.tree_flatten(params)
    out = []
    for i, leaf in enumerate(leaves):
        key = jax.random.fold_in(jax.random.PRNGKey(100 + step), i)
        g = jax.random.normal(key, leaf.shape)
        out.append(g * scales.reshape((-1,) + (1,) * (leaf.ndim - 1)))
    return jax.tree_util.tree_unflatten(tree, out)


def _assert_trees_close(tpt, jpt, **tol):
    tl = tree_paths_and_leaves(tpt)
    jl = tree_paths_and_leaves(jax.tree.map(np.asarray, jpt))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, a), (_, b) in zip(tl, jl):
        np.testing.assert_allclose(a, b, err_msg=p, **tol)


@pytest.mark.parametrize("name,clip,wd", [("adam", "median", 0.0), ("adam", 0.0, 0.0),
                                          ("adamw", "median", 0.01), ("sgd", "median", 0.0),
                                          ("momentum", "median", 0.0), ("adam", 1.0, 0.0)])
def test_three_updates_match_reference_with_per_client_clip(name, clip, wd):
    """Three vmapped updates from the same gradients. ``clip="median"``
    sets grad_clip to the middle client's norm, so one client is
    clipped, one is not and the third sits on the edge: a clip over the
    whole stack instead of per client would fail. rtol/atol 1e-5: the
    same fp32 arithmetic in both packages."""
    jparams = _small_params()
    if clip == "median":
        norms = np.asarray(jax.jit(jax.vmap(jax_global_norm))(_grads(jparams, 0)))
        clip = float(np.median(norms))
    jopt = jax_make_optimizer(JaxOptimizerConfig(name=name, lr=LR, grad_clip=clip,
                                                 weight_decay=wd))
    topt = make_optimizer(OptimizerConfig(name=name, lr=LR, grad_clip=clip, weight_decay=wd))
    jstate = jax.jit(jax.vmap(jopt.init))(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tstate = opt_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jupd = jax.jit(jax.vmap(jopt.update, in_axes=(0, 0, 0, None)))
    tupd = torch.func.vmap(topt.update, in_dims=(0, 0, 0, None))
    for s in range(3):
        g = _grads(jparams, s)
        jparams, jstate = jupd(g, jstate, jparams, LR)
        tparams, tstate = tupd(params_from_numpy(jax.tree.map(np.asarray, g)), tstate,
                               tparams, LR)
    _assert_trees_close(params_to_numpy(tparams), jparams, rtol=1e-5, atol=1e-5)
    _assert_trees_close(opt_state_to_numpy(tstate), jstate, rtol=1e-5, atol=1e-5)


def test_vmapped_train_and_eval_step_match_reference():
    """One vmapped train step (gradient and sgd update inside the client
    vmap) and the eval step, on bridged weights and the same batches.
    sgd keeps the update linear in the gradient, so the tolerance is the
    gradient's: rtol/atol 1e-4 for fp32 convolutions in another order."""
    jm = jax_build_model(jax_get_config("squeezenet-dr"))
    tm = build_model(get_config("squeezenet-dr"))
    jopt = jax_make_optimizer(JaxOptimizerConfig(name="sgd", lr=0.1))
    topt = make_optimizer(OptimizerConfig(name="sgd", lr=0.1))
    jparams = _client_params()
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(N_CLIENTS, 4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(-1, 5, size=(N_CLIENTS, 4)).astype(np.int32)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tbatch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}

    jnew, _, jmet = jax.jit(jax.vmap(jax_make_train_step(jm, jopt), in_axes=(0, 0, 0, None)))(
        jparams, jax.jit(jax.vmap(jopt.init))(jparams), jbatch, 0.1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    tnew, tstate, tmet = torch.func.vmap(make_train_step(tm, topt), in_dims=(0, 0, 0, None))(
        tparams, torch.func.vmap(topt.init)(tparams), tbatch, 0.1)
    _assert_trees_close(params_to_numpy(tnew), jnew, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]), rtol=1e-5)
    assert tstate["step"].tolist() == [1] * N_CLIENTS

    jev = jax.jit(jax.vmap(jax_make_eval_step(jm)))(jparams, jbatch)
    tev = torch.func.vmap(make_eval_step(tm))(tparams, tbatch)
    np.testing.assert_array_equal(tev["acc"].numpy(), np.asarray(jev["acc"]))
    np.testing.assert_allclose(tev["loss"].numpy(), np.asarray(jev["loss"]), rtol=1e-5)


def test_unported_optimizer_raises():
    with pytest.raises(ValueError, match="adafactor"):
        make_optimizer(OptimizerConfig(name="adafactor"))
