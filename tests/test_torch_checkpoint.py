"""The port's checkpoints (``repro_torch.checkpoint``) and the
train-to-serve bridge (``serve.load_checkpoint``) against the JAX
reference on the CPU: the reference's four checkpoint tests on the port,
files crossing between the packages (the reference's fp32 and bf16
files restored by the port bitwise, the port's fp32 files by the
reference's ``restore_into`` bitwise), and a swarm checkpoint written by
the reference with its fleet export's extras (``model_config``,
``n_clients``, ``client_weights``), loaded and served by both."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as jax_serve  # noqa: E402
from repro.checkpoint import restore_into as jax_restore_into  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.bridge import tree_to_numpy  # noqa: E402
from repro_torch.checkpoint import restore_into, save_checkpoint  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import BucketSpec  # noqa: E402
from repro_torch.utils.tree import tree_map, tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32)},
            "list": [torch.zeros((2,)), torch.full((3,), 7.0)]}


def _assert_trees_equal(got, expect):
    pg, pe = tree_paths_and_leaves(got), tree_paths_and_leaves(expect)
    assert [p for p, _ in pg] == [p for p, _ in pe]
    for (p, a), (_, b) in zip(pg, pe):
        assert a.dtype == b.dtype, p
        assert torch.equal(a, b), p


# ------------------------------------------- the reference's four, on the port


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "ckpt", tree, step=42, extra={"note": "x"})
    restored, step = restore_into(tree_map(torch.zeros_like, tree), tmp_path / "ckpt")
    assert step == 42
    _assert_trees_equal(restored, tree)
    manifest = json.loads((tmp_path / "ckpt.json").read_text())
    assert manifest["extra"] == {"note": "x"}
    assert manifest["leaves"]["nested/b"] == {"shape": [4], "dtype": "int32"}


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path / "c", {"a": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_into({"a": torch.ones((3, 3))}, tmp_path / "c")


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(tmp_path / "c", {"a": torch.ones((2,))})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        restore_into({"a": torch.ones((2,)), "b": torch.ones((1,))}, tmp_path / "c")


def test_swarm_stacked_checkpoint(tmp_path):
    stacked = {"w": torch.arange(12.0).reshape(3, 4)}
    save_checkpoint(tmp_path / "swarm", stacked, step=7)
    restored, step = restore_into(tree_map(torch.zeros_like, stacked), tmp_path / "swarm")
    assert step == 7
    assert torch.equal(restored["w"], stacked["w"])


def test_restore_onto_a_meta_example_lands_on_the_given_device(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path / "c", tree)
    example = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    restored, _ = restore_into(example, tmp_path / "c", device="cpu")
    _assert_trees_equal(restored, tree)


# ----------------------------------------------------- across the packages


def _jax_tree(dtype):
    rng = np.random.default_rng(0)
    return {"w": jnp.asarray(rng.normal(size=(3, 5, 4)), dtype),
            "blocks": [{"b": jnp.asarray(rng.normal(size=(3, 7)), dtype)},
                       {"b": jnp.asarray(rng.normal(size=(3, 7)), dtype)}],
            "step": jnp.arange(3, dtype=jnp.int32)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_port_restores_the_references_files_bitwise(tmp_path, dtype):
    """fp32 and bf16: a bf16 leaf is raw two-byte values in the npz,
    read by the manifest's dtype."""
    tree = _jax_tree(dtype)
    jax_save_checkpoint(tmp_path / "ref", tree, step=3, extra={"k": 1})
    expect = jax.tree.map(np.asarray, tree)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    example = {"w": torch.empty((3, 5, 4), dtype=tdt),
               "blocks": [{"b": torch.empty((3, 7), dtype=tdt)} for _ in range(2)],
               "step": torch.empty((3,), dtype=torch.int32)}
    restored, step = restore_into(example, tmp_path / "ref")
    assert step == 3
    got = tree_to_numpy(restored)
    for (p, a), (_, b) in zip(tree_paths_and_leaves(got), tree_paths_and_leaves(expect)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=p)


def test_reference_restores_the_ports_fp32_files_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"w": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
            "blocks": [{"b": torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))}],
            "n": torch.arange(3, dtype=torch.int32)}
    save_checkpoint(tmp_path / "port", tree, step=9)
    example = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree_to_numpy(tree)))
    restored, step = jax_restore_into(example, tmp_path / "port")
    assert step == 9
    expect = tree_to_numpy(tree)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                              jax.tree_util.tree_flatten_with_path(expect)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_port_writes_bf16_as_the_reference_does(tmp_path):
    """The same values, the same manifest, the same two-byte payload."""
    vals = np.random.default_rng(2).normal(size=(2, 6)).astype(ml_dtypes.bfloat16)
    jax_save_checkpoint(tmp_path / "ref", {"h": jnp.asarray(vals)})
    save_checkpoint(tmp_path / "port",
                    {"h": torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16)})
    jm = json.loads((tmp_path / "ref.json").read_text())
    tm = json.loads((tmp_path / "port.json").read_text())
    assert tm == jm
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert a["h"].dtype.itemsize == b["h"].dtype.itemsize == 2
        assert a["h"].tobytes() == b["h"].tobytes()
    restored, _ = restore_into({"h": torch.empty((2, 6), dtype=torch.bfloat16)}, tmp_path / "port")
    assert restored["h"].view(torch.int16).numpy().tobytes() == vals.tobytes()


# ------------------------------------------------------------ load_checkpoint


def _fleet_checkpoint(tmp_path, arch, n, weights, smoke=True):
    """A client-stacked swarm checkpoint written by the reference's
    ``save_checkpoint`` with the extras its fleet export writes
    (``launch/fleet_driver.py``), since that export is red here."""
    jcfg = jax_get_config(arch)
    jcfg = jcfg.smoke() if smoke else jcfg
    jm = jax_build_model(jcfg)
    stacked = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(5), n))
    path = tmp_path / "fleet"
    jax_save_checkpoint(path, stacked, step=4, extra={
        "model_config": dataclasses.asdict(jcfg), "n_clients": n,
        "client_weights": [float(w) for w in weights]})
    return path, stacked


@pytest.fixture(scope="module")
def lm_ckpt(tmp_path_factory):
    return _fleet_checkpoint(tmp_path_factory.mktemp("lm"), "granite-3-2b", 3, [12.0, 5.0, 9.0])


def test_load_checkpoint_rebuilds_the_references_config(lm_ckpt):
    path, _ = lm_ckpt
    jm, _ = jax_serve.load_checkpoint(path)
    tm, _ = serve.load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg == ModelConfig(**dataclasses.asdict(jm.cfg))
    assert tm is build_model(tm.cfg)                 # a cache hit: the config hashes
    tm2, _ = serve.load_checkpoint(path, use_pallas=True, device="cpu")
    assert tm2.cfg.use_pallas and not tm.cfg.use_pallas


def test_load_checkpoint_mean_and_client_match_reference(lm_ckpt):
    path, stacked = lm_ckpt
    _, jmean = jax_serve.load_checkpoint(path)
    _, tmean = serve.load_checkpoint(path, device="cpu")
    ja = jax.tree.map(np.asarray, jmean)
    for (p, a), (_, b) in zip(tree_paths_and_leaves(tree_to_numpy(tmean)),
                              tree_paths_and_leaves(ja)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=p)
    for i in range(3):
        _, jc = jax_serve.load_checkpoint(path, client=f"client:{i}")
        _, tc = serve.load_checkpoint(path, client=f"client:{i}", device="cpu")
        for (p, a), (_, b) in zip(tree_paths_and_leaves(tree_to_numpy(tc)),
                                  tree_paths_and_leaves(jax.tree.map(np.asarray, jc))):
            np.testing.assert_array_equal(a, b, err_msg=p)
            np.testing.assert_array_equal(a, dict(tree_paths_and_leaves(
                jax.tree.map(np.asarray, stacked)))[p][i], err_msg=p)


def test_load_checkpoint_then_generate_matches_reference(lm_ckpt):
    """fp32 on the CPU, token for token (the reference's jnp decode
    path, as tests/test_torch_serve.py holds it)."""
    path, _ = lm_ckpt
    jm, jp = jax_serve.load_checkpoint(path)
    tm, tp = serve.load_checkpoint(path, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=n) for n in (3, 8, 5)]
    kw = dict(max_new_tokens=5, buckets=(BucketSpec(2, 16),))
    ref = jax_serve.generate(jm, jp, prompts, **kw)
    got = serve.generate(tm, tp, prompts, device="cpu", **kw)
    assert [r.tokens for r in got] == [r.tokens for r in ref]


def test_load_checkpoint_then_classify_matches_reference(tmp_path):
    """A squeezenet-dr stack: the served labels of both packages."""
    path, _ = _fleet_checkpoint(tmp_path, "squeezenet-dr", 3, [4.0, 1.0, 2.0], smoke=False)
    jm, jp = jax_serve.load_checkpoint(path)
    tm, tp = serve.load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    imgs = list(np.random.default_rng(4).normal(size=(5, 32, 32, 3)).astype(np.float32))
    ref = jax_serve.classify(jm, jp, imgs, batch_buckets=(1, 4))
    got = serve.classify(tm, tp, imgs, batch_buckets=(1, 4), device="cpu")
    assert [o.label for o in got] == [o.label for o in ref]
    np.testing.assert_allclose([o.confidence for o in got], [o.confidence for o in ref],
                               rtol=0, atol=1e-5)


def test_load_checkpoint_refuses_a_file_without_its_config(tmp_path):
    save_checkpoint(tmp_path / "bare", {"w": torch.ones((2, 3))})
    with pytest.raises(ValueError, match="model_config"):
        serve.load_checkpoint(tmp_path / "bare", device="cpu")


def test_load_checkpoint_needs_a_card_unless_told(monkeypatch, lm_ckpt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_checkpoint(lm_ckpt[0])
