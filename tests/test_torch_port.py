"""The port's package as a whole: it imports neither JAX nor the JAX
package, its configs match the reference's, the bridge round-trips,
and its entry points refuse to fall back to the CPU."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import fields  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.configs.base import SwarmConfig as JaxSwarmConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.utils.tree import tree_paths_and_leaves as jax_paths  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import REGISTRY, OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = ["squeezenet-dr", "alexnet-dr", "vgg-dr", "inception-dr"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of repro_torch in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


@pytest.mark.parametrize("arch", ARCHS)
def test_cnn_configs_match_reference(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    for f in fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_registry_holds_the_four_cnns_and_refuses_others():
    assert sorted(REGISTRY) == sorted(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("granite-3-2b")


@pytest.mark.parametrize("ours,theirs", [(OptimizerConfig, JaxOptimizerConfig),
                                         (SwarmConfig, JaxSwarmConfig)])
def test_optimizer_and_swarm_defaults_match_reference(ours, theirs):
    """Every field the port keeps has the reference's default (the
    swarm's unread ``stat_granularity`` is not carried over)."""
    a, b = ours(), theirs()
    assert {f.name for f in fields(a)} <= {f.name for f in fields(b)}
    for f in fields(a):
        assert getattr(a, f.name) == getattr(b, f.name), f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_paths_follow_the_reference_order(arch):
    shapes = jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert [p for p, _ in tree_paths_and_leaves(bridge.params_from_numpy(tree))] == \
        [p for p, _ in jax_paths(tree)]


def test_bridge_round_trip_is_the_identity_and_keeps_dtypes():
    rng = np.random.default_rng(0)
    tree = {"conv1": {"w": rng.normal(size=(3, 3, 3, 4)).astype(np.float32),
                      "b": np.zeros((4,), np.float32)},
            "half": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
            "step": np.array([1, 2], np.int32)}
    t = bridge.params_from_numpy(tree)
    assert t["conv1"]["w"].dtype == torch.float32 and t["half"].dtype == torch.bfloat16
    assert t["step"].dtype == torch.int32
    back = bridge.params_to_numpy(t)
    for (p, a), (_, b) in zip(tree_paths_and_leaves(back), tree_paths_and_leaves(tree)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b)


def test_state_round_trip():
    rng = np.random.default_rng(1)
    state = {"params": {"w": rng.normal(size=(2, 3)).astype(np.float32)},
             "opt_state": {"step": np.array([4, 4], np.int32),
                           "m": {"w": np.ones((2, 3), np.float32)},
                           "v": {"w": np.full((2, 3), 2.0, np.float32)}},
             "round": np.int32(3), "n_samples": np.array([5.0, 9.0], np.float32)}
    s = bridge.state_from_numpy(state, "cpu", seed=7)
    assert s.round == 3 and s.generator.initial_seed() == 7
    back = bridge.state_to_numpy(s)
    assert back["round"] == 3
    np.testing.assert_array_equal(back["n_samples"], state["n_samples"])
    np.testing.assert_array_equal(back["opt_state"]["v"]["w"], state["opt_state"]["v"]["w"])
    np.testing.assert_array_equal(back["params"]["w"], state["params"]["w"])


def test_resolve_device_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
