"""The port's package as a whole: it imports neither JAX nor the JAX
package, its configs match the reference's, the bridge round-trips,
its entry points refuse to fall back to the CPU, it covers the
reference's public names, and every port test module pins its torch
pool."""
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
from torch_parity import pin_torch_threads, subprocess_env, torch_thread_share  # noqa: E402

pin_torch_threads()

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
    env = {**subprocess_env(), "PYTHONPATH": str(SRC)}
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
    """The four CNNs, the reference's four dense LMs, its two moe LMs, its
    ssm and its hybrid LM, its encoder-decoder and its vlm; an arch
    neither package registers stays unknown."""
    assert sorted(REGISTRY) == sorted(ARCHS + ["granite-3-2b", "command-r-35b", "deepseek-7b",
                                               "deepseek-67b", "kimi-k2-1t-a32b",
                                               "llama4-maverick-400b-a17b", "mamba2-370m",
                                               "zamba2-1.2b", "whisper-base", "internvl2-26b"])
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")


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


def test_chip_smoke_reads_ptxas_report_per_kernel():
    """chip_smoke.py's phase-1 report: one line a kernel from nvcc's
    ``-Xptxas -v`` output, the mangled name made readable (the length
    digits of the name run on from the anonymous namespace's hash)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SRC.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    text = (
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention"
        "_cu_23f0aea719flash_attention_mmaILi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiiifNS_7Stri"
        "desEi' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 248 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__149a08a1_15_flash_decode_cu_"
        "3aa291d819flash_decode_kernelI6__halfLi256EEEvPKT_S4_S4_PKiPS2_PfS8_S8_PiiiiiifNS_7St"
        "ridesEi' for 'sm_90a'\n"
        "ptxas info    : Used 48 registers, used 1 barriers, 16 bytes smem\n")
    assert smoke.ptxas_report(text) == [
        "flash_attention_mma<64>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads; Used 248 registers, used 1 barriers",
        "flash_decode_kernel<fp16,256>: Used 48 registers, used 1 barriers, 16 bytes smem"]
    assert smoke.ptxas_report("") == []


def test_build_log_is_empty_until_a_library_is_built(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.build_log("flash_decode") == ""
    _build.library_path("flash_decode").with_suffix(".log").write_text("ptxas info")
    assert _build.build_log("flash_decode") == "ptxas info"


# ------------------------------------------------------------ the public surface

import ast  # noqa: E402

REF = SRC / "repro"
PORT = SRC / "repro_torch"
# a reference name ("name", or "Class.method" for a public method of a
# public class) that the port module of the same path does not define:
# its port name as "module path:name", or why the port has none
SURFACE_MAP = {
    "core/bso.py": {"brain_storm_jax": "core/bso.py:brain_storm"},
    "core/engine.py": {
        "BucketedSwarmData.tree_flatten": "none: JAX's pytree hook, to pass the layout "
                                          "through jit; torch needs none",
        "BucketedSwarmData.tree_unflatten": "none: JAX's pytree hook, to pass the layout "
                                            "through jit; torch needs none"},
    "kernels/ref.py": {"ref_attention": "kernels/ref.py:attention",
                       "ref_decode_attention": "kernels/ref.py:decode_attention",
                       "ref_kmeans_assign": "kernels/ref.py:kmeans_assign",
                       "ref_param_stats": "kernels/ops.py:param_stats",
                       "ref_param_stats_batched": "kernels/ref.py:param_stats_batched"},
    "kernels/param_stats.py": {"param_stats": "kernels/ops.py:param_stats"},
    "kernels/ops.py": {"auto_interpret": "none: Pallas's interpret mode; a CPU tensor takes "
                                         "the plain version"},
    "launch/dryrun.py": {"build_lowered": "launch/dryrun.py:build_census"},
    "launch/comm.py": {"collective_bytes": "none: an HLO parser; the port counts collectives "
                                           "in launch.dryrun.Census and utils.collectives.CENSUS"},
    "launch/mesh.py": {"make_host_mesh": "none: JAX's host-device mesh; make_fleet_mesh and "
                                         "spawn_cpu_ranks make CPU ranks"},
    "launch/swarm_fleet.py": {"force_host_device_count": "none: launch.dryrun.fake_world's "
                                                         "fake process group takes its place"},
    "sharding/rules.py": {"build_param_shardings": "sharding/rules.py:build_param_placements"},
}


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _bound(body) -> set:
    """The names a module or class body binds: defs, classes, assignments
    and imports."""
    out = set()
    for n in body:
        if isinstance(n, (*_DEFS, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, ast.ImportFrom):
            out.update(a.asname or a.name for a in n.names)
    return out


def _public_defs(path: Path) -> set:
    """Public top-level defs and classes, and "Class.method" for each
    public method (properties included) of a public class."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (*_DEFS, ast.ClassDef)) and not n.name.startswith("_"):
            out.add(n.name)
            if isinstance(n, ast.ClassDef):
                out.update(f"{n.name}.{m.name}" for m in n.body
                           if isinstance(m, _DEFS) and not m.name.startswith("_"))
    return out


def _defined(path: Path) -> set:
    """Every name a module binds at its top level, and "Class.name" for
    every name a class body binds (a method or a field)."""
    tree = ast.parse(path.read_text())
    out = _bound(tree.body)
    for n in tree.body:
        if isinstance(n, ast.ClassDef):
            out.update(f"{n.name}.{m}" for m in _bound(n.body))
    return out


@pytest.mark.parametrize("module", sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")))
def test_port_covers_every_public_name_of_the_reference(module):
    """Every public def / class of ``src/repro/<module>``, and every
    public method of such a class (read with ``ast``), is defined by
    ``src/repro_torch/<module>`` (the method in the class of the same
    name) or named in :data:`SURFACE_MAP`, with a port name that exists
    or the reason it has none. A class named there answers for its
    methods."""
    port = PORT / module
    assert port.is_file(), f"{module} has no port module"
    have = _defined(port)
    mapped = SURFACE_MAP.get(module, {})
    missing = sorted(n for n in _public_defs(REF / module) - have - set(mapped)
                     if n.split(".")[0] not in mapped)
    assert not missing, f"{module}: {missing} neither ported nor mapped"
    for name, where in mapped.items():
        assert name not in have, f"{module}: {name} is ported; drop it from SURFACE_MAP"
        if where.startswith("none: "):
            continue
        mod, port_name = where.split(":")
        assert port_name in _defined(PORT / mod), f"{module}: {name} -> {where} does not exist"


# ------------------------------------------------------------ the thread pool

def test_every_port_test_module_pins_torch_threads_at_import():
    """Every ``tests/test_torch_*.py`` imports ``pin_torch_threads`` from
    ``torch_parity`` and calls it in its module body, and none sets
    torch's pool itself: each pytest worker runs on one pool sized to
    its share of the cores, whichever module it imports first."""
    files = sorted(Path(__file__).resolve().parent.glob("test_torch_*.py"))
    assert len(files) >= 30
    for path in files:
        tree = ast.parse(path.read_text())
        imported = any(isinstance(n, ast.ImportFrom) and n.module == "torch_parity"
                       and "pin_torch_threads" in {a.name for a in n.names if a.asname is None}
                       for n in tree.body)
        called = any(isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                     and isinstance(n.value.func, ast.Name)
                     and n.value.func.id == "pin_torch_threads" for n in tree.body)
        assert imported and called, f"{path.name} does not call pin_torch_threads() at import"
        resized = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr in ("set_num_threads", "set_num_interop_threads")]
        assert not resized, f"{path.name}:{resized} sizes torch's pool itself"


def test_torch_pool_is_the_workers_share(monkeypatch):
    """The pool is this process's share of its cores over the xdist
    workers (1 thread each under ``-n 6`` on 8 cores; the whole machine
    without xdist), pinning again leaves it so, the share never falls
    below one thread, and a process a test starts gets one thread."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == torch_thread_share() == max(1, cores // workers)
    assert pin_torch_threads() == torch.get_num_threads() == max(1, cores // workers)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    assert torch_thread_share() == max(1, cores // 6)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(4 * cores))
    assert torch_thread_share() == 1
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
    assert torch_thread_share() == cores
    assert subprocess_env({"PATH": "/bin"}) == {"PATH": "/bin", "OMP_NUM_THREADS": "1"}
    assert subprocess_env()["OMP_NUM_THREADS"] == "1"


_TREE = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": [np.ones((2, 2), np.float32) * 0.5, np.arange(2, dtype=np.int32)]}
_TREE2 = {"a": np.full((2, 3), 1.5, np.float32),
          "b": [np.arange(4, dtype=np.float32).reshape(2, 2), np.array([7, 9], np.int32)]}


@pytest.mark.parametrize("name", ["tree_zeros_like", "tree_add", "tree_sub", "tree_scale",
                                  "tree_unstack", "tree_index", "tree_cast", "tree_num_params",
                                  "tree_size_bytes"])
def test_tree_helpers_match_reference(name):
    """Each of the reference's nine tree helpers against the port's on
    the same tree through the bridge: the same leaves (values and dtypes)
    or the same count; the reference's exports from ``repro.utils`` are
    the port's from ``repro_torch.utils``."""
    import jax.numpy as jnp

    import repro.utils as jutils
    import repro.utils.tree as jt
    import repro_torch.utils as tutils
    import repro_torch.utils.tree as tt
    args = {"tree_zeros_like": (_TREE,), "tree_add": (_TREE, _TREE2),
            "tree_sub": (_TREE, _TREE2), "tree_scale": (_TREE, 3.0),
            "tree_unstack": (_TREE, 2), "tree_index": (_TREE, 1),
            "tree_cast": (_TREE,), "tree_num_params": (_TREE,), "tree_size_bytes": (_TREE,)}[name]
    extra_j = (jnp.bfloat16,) if name == "tree_cast" else ()
    extra_t = (torch.bfloat16,) if name == "tree_cast" else ()
    jargs = tuple(jax.tree.map(jnp.asarray, a) if isinstance(a, dict) else a for a in args)
    targs = tuple(bridge.tree_from_numpy(a) if isinstance(a, dict) else a for a in args)
    want = getattr(jt, name)(*jargs, *extra_j)
    got = getattr(tt, name)(*targs, *extra_t)
    if isinstance(want, int):
        assert got == want
    else:
        for w, g in zip(want if isinstance(want, list) else [want],
                        got if isinstance(got, list) else [got]):
            for (p, a), (q, b) in zip(jax_paths(w), tree_paths_and_leaves(bridge.tree_to_numpy(g))):
                assert p == q and np.asarray(a).dtype == b.dtype, (p, np.asarray(a).dtype, b.dtype)
                np.testing.assert_array_equal(np.asarray(a), b)
    exported = {n for n in dir(jutils) if n.startswith("tree_")}
    assert exported <= {n for n in dir(tutils) if n.startswith("tree_")}
