"""The port's CNN family and model interface against the JAX reference:
logits and gradients of all four DR CNNs on bridged reference weights,
XLA's SAME padding, and the masked loss and accuracy."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import cnn as jax_cnn  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

ARCHS = ["squeezenet-dr", "alexnet-dr", "vgg-dr", "inception-dr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_cnn_logits_and_grads_match_reference(arch):
    """Forward logits and loss gradients at 16 px on the reference's own
    initial weights. rtol 1e-5 / atol 1e-4: fp32 convolutions summed in
    another order by XLA and by oneDNN, over up to 8 conv layers."""
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(7))
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 3, -1, 4], np.int32)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    jlogits, ((jloss, _), jgrads) = jax.jit(lambda p, b: (
        jm.forward(p, b)[0], jax.value_and_grad(jm.loss, has_aux=True)(p, b)))(jp, jbatch)

    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tbatch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    tlogits, _ = tm.forward(tp, tbatch)
    tgrads, (tloss, _) = torch.func.grad_and_value(tm.loss, has_aux=True)(tp, tbatch)

    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-4)
    jg = jax.tree.map(np.asarray, jgrads)
    tg = params_to_numpy(tgrads)
    for (path, a), (jpath, b) in zip(tree_paths_and_leaves(tg), tree_paths_and_leaves(jg)):
        assert path == jpath
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4, err_msg=path)


@pytest.mark.parametrize("size,k,stride,pads", [(32, 3, 2, (0, 1)), (32, 5, 2, (1, 2)),
                                                (16, 3, 1, (1, 1)), (15, 3, 2, (1, 1)),
                                                (8, 1, 1, (0, 0)), (16, 5, 1, (2, 2))])
def test_same_pads_are_xlas(size, k, stride, pads):
    assert cnn.same_pads(size, k, stride) == pads


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (32, 5, 2), (15, 3, 2), (9, 5, 1)])
def test_conv2d_same_matches_xla(size, k, stride):
    """The stride-2 SAME conv pads asymmetrically; the port must match
    XLA exactly where torch's padding=k//2 would be off."""
    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    expect = np.asarray(jax_cnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       stride=stride))
    got = cnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
                     torch.from_numpy(b), stride=stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


def test_maxpool_same_pads_with_minus_inf():
    """The inception pool branch: all-negative inputs must never see a
    zero from the padding."""
    rng = np.random.default_rng(1)
    x = -np.abs(rng.normal(size=(2, 7, 7, 3))).astype(np.float32) - 1.0
    expect = np.asarray(jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                              (1, 3, 3, 1), (1, 1, 1, 1), "SAME"))
    got = cnn.maxpool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 1).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("labels", [[0, 1, 2, 3, 4, 1], [2, -1, 4, -1, 0, 0],
                                    [-1, -1, -1, -1, -1, -1]])
def test_cross_entropy_and_accuracy_mask_negative_labels(labels):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = np.asarray(labels, np.int32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels)
    np.testing.assert_allclose(float(tmodel.cross_entropy(tl, ty)),
                               float(jax_model.cross_entropy(jl, jy)), rtol=1e-6, atol=1e-6)
    assert float(tmodel.accuracy(tl, ty)) == float(jax_model.accuracy(jl, jy))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Same paths, shapes and dtypes as the reference's tree (the draws
    themselves differ)."""
    jp = jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    model = build_model(get_config(arch))
    tp = model.init(torch.Generator().manual_seed(0))
    jl = tree_paths_and_leaves(jp)
    tl = tree_paths_and_leaves(tp)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, a), (_, b) in zip(tl, jl):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", p
    assert model.param_count(tp) == sum(int(np.prod(b.shape)) for _, b in jl)
