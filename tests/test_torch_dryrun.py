"""The port's production dry-run (``repro_torch.launch.dryrun``) against
the reference's (``repro.launch.dryrun``) on the CPU: the runtime
settings, microbatch guard, FLOP and parameter arithmetic, probe depths
and applicability over the whole (arch x shape) matrix; the abstract
inputs and caches (``models.model.input_specs`` / ``cache_specs``); the
attention ops' FLOP formulas; and the census itself, one train and one
decode step of granite's smoke config on fake 2x2 and 16x16 meshes and
the CLI on one full-width pair, each in a subprocess (a process group
is process-wide)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import dryrun as jax_dryrun  # noqa: E402
from repro.models.model import cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import abstract_params, cache_specs, input_specs  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads, subprocess_env  # noqa: E402

pin_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]


def test_shapes_and_run_config_are_the_references():
    from repro.configs.base import RunConfig as JaxRunConfig
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_dryrun.INPUT_SHAPES.items()}
    assert [(f.name, f.default) for f in dataclasses.fields(RunConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JaxRunConfig)]
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        ["name", "seq_len", "global_batch", "kind"]
    run = RunConfig(get_config("granite-3-2b"), INPUT_SHAPES["train_4k"])
    assert (run.microbatch, run.seed, run.optimizer.name) == (0, 0, "adamw")


@pytest.mark.parametrize("optimized", [False, True])
def test_runtime_settings_match_over_the_matrix(optimized):
    """``runtime_config`` (both profiles), ``optimizer_for``,
    ``microbatches_for`` (16 and 32 data-parallel ranks, an override),
    ``rules_for``, ``_probe_layers``, ``_probe_cfg`` and
    ``shape_applicable`` equal the reference's for every pair."""
    for arch, name in PAIRS:
        cfg = dryrun.runtime_config(arch, INPUT_SHAPES[name], optimized=optimized)
        jcfg = jax_dryrun.runtime_config(arch, jax_dryrun.INPUT_SHAPES[name], optimized=optimized)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), (arch, name)
        assert dataclasses.asdict(dryrun.optimizer_for(cfg)) == \
            dataclasses.asdict(jax_dryrun.optimizer_for(jcfg))
        for n_dp in (16, 32):
            for mo in (0, 4, 64):
                c, j = (dataclasses.replace(x, microbatch_override=mo) for x in (cfg, jcfg))
                assert dryrun.microbatches_for(c, INPUT_SHAPES[name], n_dp) == \
                    jax_dryrun.microbatches_for(j, jax_dryrun.INPUT_SHAPES[name], n_dp)
        assert dryrun._probe_layers(cfg) == jax_dryrun._probe_layers(jcfg)
        L = dryrun._probe_layers(cfg)[0]
        assert dataclasses.asdict(dryrun._probe_cfg(cfg, L)) == \
            dataclasses.asdict(jax_dryrun._probe_cfg(jcfg, L))
        assert dryrun.shape_applicable(arch, name) == jax_dryrun.shape_applicable(arch, name)
        for pod in (True, False):
            c = dataclasses.replace(cfg, fsdp_over_pod=pod)
            j = dataclasses.replace(jcfg, fsdp_over_pod=pod)
            assert dryrun.rules_for(c).logical_to_physical == \
                jax_dryrun.rules_for(j).logical_to_physical


def test_flops_and_active_params_match():
    """``model_flops`` over the matrix, and ``active_params`` on the
    abstract params of every arch at its probe depth (the MoE's
    inactive experts taken off) against the reference's on
    ``jax.eval_shape``."""
    for arch in ASSIGNED_ARCHS:
        shape = INPUT_SHAPES["train_4k"]
        cfg = dryrun.runtime_config(arch, shape)
        cfg = dryrun._probe_cfg(cfg, dryrun._probe_layers(cfg)[1])
        jcfg = jax_dryrun.runtime_config(arch, jax_dryrun.INPUT_SHAPES["train_4k"])
        jcfg = jax_dryrun._probe_cfg(jcfg, jax_dryrun._probe_layers(jcfg)[1])
        jparams = jax.eval_shape(
            lambda c=jcfg: jax_dryrun.build_model(c).init(jax.random.PRNGKey(0)))
        counts = dryrun.active_params(cfg, abstract_params(cfg))
        assert counts == jax_dryrun.active_params(jcfg, jparams), arch
        for name in INPUT_SHAPES:
            assert dryrun.model_flops(cfg, INPUT_SHAPES[name], *counts) == \
                jax_dryrun.model_flops(jcfg, jax_dryrun.INPUT_SHAPES[name], *counts)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_and_cache_specs_match(arch):
    """``input_specs`` and ``cache_specs`` give the reference's shapes and
    dtypes, on ``meta``, for every shape of the arch (its runtime config
    at full width; the cache at the probe depth)."""
    for name in INPUT_SHAPES:
        if not dryrun.shape_applicable(arch, name):
            continue
        shape, jshape = INPUT_SHAPES[name], jax_dryrun.INPUT_SHAPES[name]
        cfg = dryrun.runtime_config(arch, shape)
        jcfg = jax_dryrun.runtime_config(arch, jshape)
        got, want = input_specs(cfg, shape), jax_input_specs(jcfg, jshape)
        assert set(got) == set(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), str(got[k].dtype)[6:]) == \
                (tuple(want[k].shape), str(want[k].dtype)), (arch, name, k)
        if shape.kind != "decode":
            continue
        cfg = dryrun._probe_cfg(cfg, dryrun._probe_layers(cfg)[0])
        jcfg = jax_dryrun._probe_cfg(jcfg, jax_dryrun._probe_layers(jcfg)[0])
        got = tree_paths_and_leaves(cache_specs(cfg, shape))
        flat, _ = jax.tree_util.tree_flatten_with_path(jax_cache_specs(jcfg, jshape))
        assert [(p, tuple(t.shape), str(t.dtype)[6:]) for p, t in got] == \
            [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
              tuple(t.shape), str(t.dtype)) for path, t in flat], (arch, name)


def test_attention_flop_formulas():
    """K3's formula counts 4·D a (query head, key) over the keys a query
    at the cache's last position reads; K4's over the pairs the mask
    keeps (a brute-force count), so the tiles the kernel skips are not
    counted."""
    from torch.utils.flop_counter import FlopCounterMode

    def meta(*s):
        return torch.empty(s, device="meta")
    for window, keys in ((0, 40), (8, 8), (64, 40)):
        with FlopCounterMode(display=False) as fc:
            ops.flash_decode(meta(2, 8, 1, 64), meta(2, 2, 40, 64), meta(2, 2, 40, 64), 39,
                             window=window)
        assert fc.get_total_flops() == 4 * 2 * 8 * 64 * keys
    for causal, window, q_offset in ((True, 0, 0), (True, 5, 0), (False, 0, 0), (True, 0, 4)):
        with FlopCounterMode(display=False) as fc:
            ops.flash_attention(meta(1, 4, 16, 32), meta(1, 2, 20, 32), meta(1, 2, 20, 32),
                                causal=causal, window=window, block_q=16, block_k=20,
                                q_offset=q_offset)
        q, k = np.arange(16)[:, None] + q_offset, np.arange(20)[None, :]
        keep = (k <= q if causal else np.ones((16, 20), bool)) & \
            ((k > q - window) if window else True)
        assert fc.get_total_flops() == 4 * 4 * 32 * int(keep.sum())


def test_failed_op_names_the_op():
    err = RuntimeError("Sharding propagation failed for aten.index_put_.default(Spec(...))")
    assert dryrun.failed_op(err) == "aten.index_put_.default"
    assert dryrun.failed_op(ValueError("no op here")) == ""


def test_probe_on_card_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.probe_on_card("granite-3-2b", "decode_32k")
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        dryrun.probe_on_card("granite-3-2b", "decode_32k", device="cpu")


_CENSUS_SCRIPT = r"""
import dataclasses, json, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import build_param_specs, rules
from repro_torch.models.model import abstract_params
from torch.distributed.device_mesh import init_device_mesh
cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), remat="full")
out = {}
for shape in (ShapeConfig("t", 32, 32, "train"), ShapeConfig("d", 64, 32, "decode")):
    for side in (2, 16):
        with dryrun.fake_world(side * side):
            mesh = init_device_mesh("cpu", (side, side), mesh_dim_names=("data", "model"))
            rec = dryrun.build_census(cfg, shape, mesh)
            params = rules.distribute(abstract_params(cfg), mesh)
            specs = dict(rules.tree_paths_and_leaves(build_param_specs(abstract_params(cfg),
                                                                       mesh)))
            local_ok = all(
                tuple(t.to_local().shape) == rules.local_shape(t.shape, specs[p], mesh)
                for p, t in rules.tree_paths_and_leaves(params))
        out[f"{shape.kind}{side}"] = {"flops": rec["flops"], "coll": rec["collectives"],
                                      "local_ok": local_ok}
out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "repro."))
                          for m in sys.modules)
print(json.dumps(out))
"""


def test_census_of_a_train_and_a_decode_step():
    """``build_census`` runs one train step (remat full, adamw) and one
    decode step of granite's smoke config on ``meta`` DTensors on a fake
    2x2 and a fake 16x16 mesh: it finishes, each param's local shard is
    its dimension over its axes' product, it counts FLOPs and
    collectives, a 16x16 rank does less than a 2x2 one, and nothing of
    JAX or the reference was imported."""
    res = subprocess.run([sys.executable, "-c", _CENSUS_SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=subprocess_env())
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert not out.pop("jax_imported"), "the dry-run pulled in JAX or the reference"
    for key, rec in out.items():
        assert rec["local_ok"], key
        assert rec["flops"] > 0 and rec["coll"], key
        assert sum(c["count"] for c in rec["coll"].values()) > 0, key
    assert out["train16"]["flops"] < out["train2"]["flops"]


def test_cli_writes_a_record_and_exits_1_on_a_failure(tmp_path):
    """``main`` on one full-width pair (the 2x16x16 mesh) writes its census
    record under the output directory; an unknown arch fails, is written
    as a failed record and exits 1."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-3-2b",
           "--shape", "decode_32k", "--mesh", "multi", "--out", str(tmp_path)]
    env = subprocess_env({"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / "dryrun_granite-3-2b_decode_32k_2x16x16.json").read_text())
    assert rec["ok"] and rec["n_params"] == 2_533_531_648
    assert rec["collectives"] and rec["cost"]["flops_per_device"] > 0
    assert rec["memory"]["temp_bytes"] is None and rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    bad = subprocess.run(cmd[:4] + ["no-such-arch"] + cmd[5:], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert bad.returncode == 1
    assert not json.loads((tmp_path / "dryrun_no-such-arch_decode_32k_2x16x16_failed.json")
                          .read_text())["ok"]
