"""The port's placement table (``repro_torch.sharding``) against the
reference's (``repro.sharding.rules``) on the CPU: the reference's own
sharding cases on the port, then spec for spec on shape-only production
meshes (16x16 and 2x16x16) for every assigned arch's params, adamw and
adafactor state and decode caches, at full width and the reference's
probe depths; and the DTensor side: placements, ``shard_act`` under a
fake process group, the flattened pod x data view."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import dryrun as jax_dryrun  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.model import cache_specs as jax_cache_specs  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import abstract_params, build_model, cache_specs  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.sharding import (build_param_specs, logical_axes_for_path, shard_act,  # noqa: E402
                                  spec_for, use_sharding)
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads, subprocess_env  # noqa: E402

pin_torch_threads()

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Shape-only stand-in (the reference's test mesh)."""
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})


# ------------------------------------------------- the reference's cases


def test_logical_axes_for_known_paths():
    assert logical_axes_for_path("embedding/table", 2) == ("p_vocab", "p_embed")
    assert logical_axes_for_path("blocks/0/attn/wq", 2) == ("p_embed", "p_heads")
    assert logical_axes_for_path("blocks/3/mlp/wo", 2) == ("p_mlp", "p_embed")
    assert logical_axes_for_path("moe/experts/wi", 3) == ("p_experts", "p_embed", "p_mlp")
    assert logical_axes_for_path("layers/period0/attn/wq", 3) == \
        ("layers", "p_embed", "p_heads")
    assert logical_axes_for_path("v/blocks/0/mlp/wi/vr", 1) == ("p_embed",)
    assert logical_axes_for_path("v/blocks/0/mlp/wi/vc", 1) == ("p_mlp",)


def test_spec_divisibility_fallback():
    assert spec_for(("p_embed", "p_kv"), MESH, (2048, 8 * 128)) == ("data", "model")
    assert spec_for(("p_kv",), MESH, (8,)) == (None,)


def test_spec_never_reuses_mesh_axis():
    spec = spec_for(("cache_seq", "act_heads"), MESH, (32768, 64))
    flat = [a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))]
    assert len(flat) == len(set(flat))


def test_cache_seq_takes_both_axes_when_batch_is_one():
    spec = spec_for(("batch", "cache_seq", "p_kv", None), MESH, (1, 524288, 8, 128))
    assert spec[0] is None
    assert spec[1] == ("data", "model")


def test_build_param_specs_on_real_smoke_model():
    cfg = get_config("granite-3-2b").smoke()
    params = abstract_params(cfg)
    specs = build_param_specs(params, MESH)
    leaves = tree_paths_and_leaves(specs)
    assert leaves and all(isinstance(s, tuple) for _, s in leaves)
    assert {p for p, _ in leaves} == {p for p, _ in tree_paths_and_leaves(params)}


def test_multipod_fsdp_uses_pod_axis():
    spec = spec_for(("p_embed", "p_mlp"), MESH3, (8192, 22528))
    assert spec[0] == ("data", "pod")
    assert spec[1] == "model"


def test_shard_act_noop_without_context():
    x = torch.ones((4, 8))
    assert shard_act(x, "batch", None) is x


def test_shard_act_passes_through_on_a_shape_only_mesh():
    x = torch.ones((4, 8))
    with use_sharding(MESH):
        assert shard_act(x, "batch", None) is x
        with pytest.raises(ValueError, match="2 axes for a rank-1"):
            shard_act(torch.ones(4), "batch", None)


# --------------------------------- spec for spec, every assigned arch


def _ref_specs(tree, mesh):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_rules.build_param_specs(tree, mesh), is_leaf=lambda x: isinstance(x, P))
    return {"/".join(jax_rules._key_name(k) for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, mesh):
    return dict(tree_paths_and_leaves(build_param_specs(tree, mesh)))


def _assert_same(ref, port, what):
    assert set(ref) == set(port), f"{what}: paths differ: {sorted(set(ref) ^ set(port))[:6]}"
    bad = [(p, ref[p], port[p]) for p in ref if ref[p] != port[p]]
    assert not bad, f"{what}: {len(bad)} specs differ, e.g. {bad[:3]}"


@pytest.fixture(scope="module")
def ref_trees():
    """The reference's abstract params, adamw / adafactor state and
    decode caches of every assigned arch at its probe depth (L2)."""
    out = {}
    for arch in JAX_ARCHS:
        trees = {}
        for shape_name in ("train_4k", "decode_32k", "long_500k"):
            if not jax_dryrun.shape_applicable(arch, shape_name):
                continue
            shape = jax_dryrun.INPUT_SHAPES[shape_name]
            cfg = jax_dryrun.runtime_config(arch, shape)
            cfg = jax_dryrun._probe_cfg(cfg, jax_dryrun._probe_layers(cfg)[1])
            model = jax_build_model(cfg)
            if shape.kind == "train":
                params = jax.eval_shape(lambda m=model: m.init(jax.random.PRNGKey(0)))
                trees["params"] = params
                for name in ("adamw", "adafactor"):
                    opt = jax_make_optimizer(jax_dryrun.OptimizerConfig(name=name))
                    trees[name] = jax.eval_shape(opt.init, params)
            else:
                trees[shape_name] = jax_cache_specs(cfg, shape)
        out[arch] = trees
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_leaf_gets_the_references_spec(arch, ref_trees):
    assert ASSIGNED_ARCHS == JAX_ARCHS
    ref = ref_trees[arch]
    for shape_name in ("train_4k", "decode_32k", "long_500k"):
        if not dryrun.shape_applicable(arch, shape_name):
            continue
        shape = INPUT_SHAPES[shape_name]
        cfg = dryrun.runtime_config(arch, shape)
        cfg = dryrun._probe_cfg(cfg, dryrun._probe_layers(cfg)[1])
        if shape.kind == "train":
            params = abstract_params(cfg)
            trees = {"params": params}
            for name in ("adamw", "adafactor"):
                trees[name] = make_optimizer(OptimizerConfig(name=name)).init(params)
        else:
            trees = {shape_name: cache_specs(cfg, shape)}
        for key, tree in trees.items():
            for mesh, tag in ((MESH, "16x16"), (MESH3, "2x16x16")):
                _assert_same(_ref_specs(ref[key], mesh), _port_specs(tree, mesh),
                             f"{arch} {key} {tag}")


# ----------------------------------------------------- DTensor placements


def test_placements_and_local_shapes():
    """A spec's placements on a DeviceMesh, and the local shard shape it
    gives (the product of a dimension's axes divides it), including a
    dimension split over two axes; a flattened view refuses a spec that
    names only one of its axes."""
    from torch.distributed.tensor import Replicate, Shard

    class NamedMesh:             # the two attributes placements_for reads
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    spec = spec_for(("p_embed", "p_mlp"), MESH3, (8192, 22528))
    assert rules.placements_for(spec, NamedMesh()) == (Shard(0), Shard(0), Shard(1))
    assert rules.local_shape((8192, 22528), spec, MESH3) == (8192 // 32, 22528 // 16)
    assert rules.placements_for((None, None), NamedMesh()) == (Replicate(),) * 3
    view = rules.MeshView(None, MESH3.shape, (("pod", "data"), ("model",)))
    assert rules.placements_for(spec, view) == (Shard(0), Shard(1))
    with pytest.raises(ValueError, match="together"):
        rules.placements_for(("data", None), view)


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert spec_for(("batch",), multi, (256,)) == (("pod", "data"),)


_FAKE_PG_SCRIPT = r"""
import sys, torch
sys.path.insert(0, "src")
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import distribute, rules, shard_act, use_sharding
from repro_torch.configs import get_config
from repro_torch.models.model import abstract_params
with dryrun.fake_world(4):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.empty(8, 6, device="meta"), mesh, [Replicate(), Replicate()])
    assert shard_act(x, "batch", None) is x
    with use_sharding(mesh):
        y = shard_act(x, "batch", None)
    assert y.placements == (Shard(0), Replicate()), y.placements
    assert y.to_local().shape == (4, 6)
    params = distribute(abstract_params(get_config("granite-3-2b").smoke()), mesh)
    wq = params["blocks"][0]["attn"]["wq"]
    assert wq.placements == (Shard(0), Shard(1)) and wq.to_local().shape == (64, 64)
with dryrun.fake_world(512):
    view = rules.flattened_view(make_production_mesh(multi_pod=True, group=dryrun._world()),
                                ("pod", "data"))
    assert view.device_mesh.mesh_dim_names == ("pod_data", "model"), view.device_mesh
    t = distribute(abstract_params(get_config("granite-3-2b")), view)["embedding"]["table"]
    assert t.to_local().shape == (49155, 2048 // 32), t.to_local().shape   # 49,155 rows: odd
print("ok")
"""


def test_shard_act_and_distribute_under_a_fake_process_group():
    """``shard_act`` redistributes a DTensor under ``use_sharding`` and is
    the identity outside it; ``distribute`` places a smoke model's
    params; the flattened pod x data view of the 2x16x16 mesh. In a
    subprocess: a process group is process-wide."""
    out = subprocess.run([sys.executable, "-c", _FAKE_PG_SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=subprocess_env())
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_placement_forms_give_the_plain_loss(remat):
    """Under a shape-only mesh's context ``shard_act`` passes through and
    the context's forms (the select in the cross-entropy, kv heads
    repeated per query head) give the plain loss bitwise."""
    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), remat=remat)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    plain = model.loss(params, batch)[0]
    with use_sharding(MESH):
        placed = model.loss(params, batch)[0]
    assert torch.equal(plain, placed)


def test_two_reduction_argmax_is_argmax():
    """Under a placement context the serve step's and the accuracy's
    argmax is the first index of the maximum, as ``torch.argmax``: ties
    included."""
    from repro_torch.models.model import argmax_last
    logits = torch.randint(0, 4, (3, 5, 33), generator=torch.Generator().manual_seed(2)).float()
    with use_sharding(MESH):
        placed = argmax_last(logits)
    assert torch.equal(placed, torch.argmax(logits, dim=-1))
    assert torch.equal(argmax_last(logits), torch.argmax(logits, dim=-1))
