"""Production dry-run: every (architecture x input shape) pair on the
reference's production meshes (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each pair with 512 placeholder TPU
devices and reads XLA's memory and cost analyses and the collectives of
the optimized HLO. Nothing here compiles a program for a mesh, so the
port answers the same questions in two parts:

- :func:`build_census` runs one step on ``meta`` DTensors under a fake
  process group of the mesh's world size (no rank, no device, nothing
  allocated): params, optimizer state, batch and cache placed by the
  logical-axis table (``repro_torch.sharding``), activations by the
  model's ``shard_act`` calls. A dispatch mode (:class:`Census`) sees
  every op each rank would run on its own shard and counts its FLOPs
  (``torch.utils.flop_counter``'s formulas on the local shapes, so the
  count is per device, replicated work included), the bytes it reads and
  writes (inputs and outputs of each op, unfused), and each collective
  DTensor issues, by op, with its output bytes. This stands in for the
  reference's HLO census (``launch.comm.collective_bytes``), which has no
  torch counterpart. An op without a DTensor placement rule fails the
  record and names the op; nothing is replicated in its place.
- :func:`probe_on_card` runs the real step on one card at the shape's
  per-device batch on the 16x16 mesh and records its ms, its peak memory
  and its FLOPs, which must equal the same step's count on ``meta``.

Both run the reference's depth probe: the step at two small depths
(:func:`_probe_layers`), unrolled, extrapolated linearly to the full
depth (:func:`cost_probe`). ``memory.argument_bytes`` is the placement
table's per-device bytes of params, optimizer state, cache and inputs;
no program is compiled, so no temporary bytes are known.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k --card

Records are written as JSON under ``dryrun_out/`` at the repository
root (git-ignored); any failure exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import time
import traceback
from collections import defaultdict
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig, ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_production_mesh
from repro_torch.models.model import abstract_params, build_model, cache_specs, input_specs
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding import build_param_specs, distribute, spec_for, use_sharding
from repro_torch.sharding.rules import (DEFAULT_LOGICAL_TO_PHYSICAL, AxisRules, flattened_view,
                                        local_shape, placements_for, view_of)
from repro_torch.train.steps import make_serve_step, make_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_paths_and_leaves

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "dryrun_out"

# ---------------------------------------------------------------------------
# runtime settings of the production run (the reference's, field for field)


def runtime_config(arch_id: str, shape: ShapeConfig, optimized: bool = False) -> ModelConfig:
    """Production runtime settings: bf16 activations, the scanned layout,
    ``remat="full"`` for training, the documented 8,192-key window for
    long-context decode on attention families, bf16 params for the
    largest. ``optimized`` adds the kept variants: grouped MoE dispatch
    (H1), vocab padding and q-chunk 256 (H2), an fp8 KV cache (H3)."""
    cfg = get_config(arch_id)
    big = arch_id in ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b",
                      "deepseek-67b", "command-r-35b")
    overrides = dict(dtype="bfloat16", scan_layers=True,
                     remat="full" if shape.kind == "train" else "none")
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        overrides["sliding_window"] = 8192
    if big:
        overrides["param_dtype"] = "bfloat16"
    if optimized:
        if cfg.n_experts:
            overrides["moe_grouped_dispatch"] = True
        if cfg.vocab_size % 128:
            overrides["vocab_round_to"] = 128
        overrides["attn_chunk_q"] = 256
        if shape.kind == "decode" and cfg.n_heads:
            overrides["cache_dtype"] = "float8_e4m3fn"
    return dataclasses.replace(cfg, **overrides)


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    """adafactor (factored states) for bf16-param configs, else adamw."""
    if cfg.param_dtype == "bfloat16":
        return OptimizerConfig(name="adafactor", lr=1e-3, grad_clip=1.0)
    return OptimizerConfig(name="adamw", lr=3e-4, weight_decay=0.1)


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, n_dp: int = 16) -> int:
    """Gradient-accumulation steps (0 off the train shapes). The rows of a
    microbatch must stay divisible by the data-parallel extent (pod x
    data), else the batch axis under-shards and per-device activations
    grow by the lost factor (§Perf H4)."""
    if shape.kind != "train":
        return 0
    B = shape.global_batch
    n_mb = min(cfg.microbatch_override or 16, B)
    while n_mb > 1 and (B // n_mb) % n_dp:
        n_mb //= 2
    return n_mb


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_params: int, n_active: int) -> float:
    """6·N·D for training, 2·N·D for a forward, 2·N a decoded token
    (N the active params, D the tokens)."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def active_params(cfg: ModelConfig, params_abs) -> tuple:
    """(total, active) parameter counts: a MoE activates top_k of its
    n_experts experts' weights."""
    n_total = sum(x.numel() for x in tree_leaves(params_abs))
    if not (cfg.n_experts and cfg.top_k):
        return n_total, n_total
    n_exp = sum(x.numel() for path, x in tree_paths_and_leaves(params_abs)
                if "experts/" in path)
    return n_total, n_total - n_exp + int(n_exp * cfg.top_k / cfg.n_experts)


def rules_for(cfg: ModelConfig) -> AxisRules:
    """The table, with the weights kept inside a pod (``p_embed`` on
    ``data`` only) unless ``cfg.fsdp_over_pod`` (§Perf H4)."""
    table = dict(DEFAULT_LOGICAL_TO_PHYSICAL)
    if not cfg.fsdp_over_pod:
        table["p_embed"] = ("data",)
    return AxisRules(table)


def _probe_layers(cfg: ModelConfig):
    """The two probe depths: one and two periods past the dense prefix."""
    if cfg.family == "moe":
        period = max(cfg.moe_every, 1)
    elif cfg.family == "hybrid":
        period = cfg.attn_every or 1
    else:
        period = 1
    base = cfg.n_dense_layers
    return base + period, base + 2 * period


def _probe_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    kw = dict(n_layers=n_layers, scan_layers=False)
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = n_layers
    return dataclasses.replace(cfg, **kw)


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    """whisper-base skips long_500k, as in the reference."""
    return not (arch_id == "whisper-base" and shape_name == "long_500k")


def per_device_batch(shape: ShapeConfig, n_dp: int = 16) -> int:
    """A device's rows of the shape's batch on the 16x16 mesh's data
    axis (1 where the batch is smaller than the axis, as long_500k's)."""
    return max(shape.global_batch // n_dp, 1)


# ---------------------------------------------------------------------------
# the census


class Census(TorchDispatchMode):
    """Counts what each op of a step does on the tensors it is given.

    Under DTensor the mode steps aside for the DTensor layer
    (``NotImplemented``) and so sees the ops each rank runs on its local
    shard, and the collectives that DTensor issues between them; on
    plain tensors it sees the step's ops as they are. ``flops`` uses
    ``torch.utils.flop_counter``'s registry (the port's attention ops
    included, ``kernels.ops``); ``bytes`` adds up the input and output
    tensor bytes of each op that is neither a view nor an allocation (an
    unfused count); ops on fake tensors, DTensor's own shape
    propagation, are not counted; ``collectives``
    maps op -> {"count", "bytes"}, bytes of the collective's output, and
    ``by_group`` process-group name -> op -> {"count", "bytes"}."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.by_group = defaultdict(lambda: defaultdict(lambda: {"count": 0, "bytes": 0}))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                  # DTensor's shape propagation, not a rank's op
        packet = func._overloadpacket
        name = str(packet)
        if "c10d" in name:
            if "wait" not in name and "wrap" not in name:
                op = name.split(".")[-1]
                for c in (self.collectives[op], self.by_group[_group_name(args)][op]):
                    c["count"] += 1
                    c["bytes"] += _nbytes(out)
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _ALLOCATIONS:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out

    def record(self) -> dict:
        coll = {k: dict(v) for k, v in sorted(self.collectives.items())}
        groups = {g: {k: dict(v) for k, v in sorted(ops_.items())}
                  for g, ops_ in sorted(self.by_group.items())}
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": float(sum(v["bytes"] for v in coll.values())), "collectives": coll,
                "by_group": groups}


def _group_name(args) -> str:
    """The process group a collective's arguments name: a functional
    collective's last string argument, a ``c10d`` op's ProcessGroup."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).group_name
            except RuntimeError:
                continue
    names = [a for a in args if isinstance(a, str)]
    return names[-1] if names else ""


# ops that only allocate: no bytes move
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in this process (rank 0):
    collectives return at once and move nothing. Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _input_spec(t: torch.Tensor, mesh, rules: AxisRules) -> tuple:
    """An input's spec: split on its batch axis (axis 0), the rest whole."""
    axes = ("batch",) + (None,) * (t.dim() - 1) if t.dim() else ()
    return spec_for(axes, mesh, t.shape, rules)


def _place_inputs(specs: dict, mesh, rules: AxisRules) -> dict:
    from torch.distributed.tensor import distribute_tensor
    view = view_of(mesh)
    return {k: distribute_tensor(t, view.device_mesh,
                                 placements_for(_input_spec(t, view, rules), view))
            for k, t in specs.items()}


def _step_fn(cfg: ModelConfig, shape: ShapeConfig, microbatches: int):
    """``build(params, place, batch) -> step(params)``: the train step
    with the config's optimizer and its state (``place``d), the forward,
    or the serve step against the shape's cache (``place``d)."""
    model = build_model(cfg)
    if shape.kind == "train":
        opt = make_optimizer(optimizer_for(cfg))
        step = make_train_step(model, opt, microbatches=microbatches)

        def build(params, place, batch):
            state = place(opt.init(params))
            return lambda p: step(p, state, batch, 1e-3)
        return build
    if shape.kind == "prefill":
        def build(params, place, batch):
            def prefill(p):
                with torch.no_grad():
                    return model.forward(p, batch)[0]
            return prefill
        return build
    serve = make_serve_step(model)

    def build(params, place, batch):
        cache = place(cache_specs(cfg, shape))
        return lambda p: serve(p, batch["tokens"], cache, batch["pos"])
    return build


def build_census(cfg: ModelConfig, shape: ShapeConfig, device_mesh, *,
                 microbatches: int = 0) -> dict:
    """One step of ``cfg`` at ``shape`` on ``meta`` DTensors placed on
    ``device_mesh`` (a ``DeviceMesh`` or a ``sharding.MeshView``, on a
    process group of its size, e.g. :func:`fake_world`). Returns the
    :class:`Census` record."""
    from torch.distributed.tensor.experimental import implicit_replication
    ops.register_sharding_rules()
    rules = rules_for(cfg)
    params_abs = abstract_params(cfg)
    params = distribute(params_abs, device_mesh, rules)
    batch = _place_inputs(input_specs(cfg, shape), device_mesh, rules)
    census = Census()
    with implicit_replication(), use_sharding(device_mesh, rules):
        step = _step_fn(cfg, shape, microbatches)(
            params_abs, lambda tree: distribute(tree, device_mesh, rules), batch)
        with census:
            step(params)
    return census.record()


def _local_bytes(tree, mesh, rules: AxisRules) -> int:
    """Per-device bytes of ``tree`` placed by the table on ``mesh``."""
    specs = dict(tree_paths_and_leaves(build_param_specs(tree, mesh, rules)))
    total = 0
    for path, leaf in tree_paths_and_leaves(tree):
        total += math.prod(local_shape(leaf.shape, specs[path], mesh)) * leaf.element_size()
    return total


def _extrapolate(c1: float, c2: float, L1: int, L2: int, L: int) -> float:
    return c1 + (c2 - c1) / max(L2 - L1, 1) * (L - L1)


def cost_probe(cfg: ModelConfig, shape: ShapeConfig, device_mesh, n_mb: int) -> dict:
    """The census at the two probe depths (unrolled, no microbatches),
    extrapolated linearly to ``cfg.n_layers``; with ``n_mb`` > 1 a third
    census at depth L1 with 2 microbatches adds each extra microbatch's
    bytes and collective bytes (the weights gathered again), ``n_mb - 1``
    times, as the reference's probe does."""
    L1, L2 = _probe_layers(cfg)
    c1 = build_census(_probe_cfg(cfg, L1), shape, device_mesh)
    c2 = build_census(_probe_cfg(cfg, L2), shape, device_mesh)
    L = cfg.n_layers
    out = {k: _extrapolate(c1[k], c2[k], L1, L2, L) for k in ("flops", "bytes", "coll")}
    coll = {}
    for op in sorted(set(c1["collectives"]) | set(c2["collectives"])):
        a = c1["collectives"].get(op, {"count": 0, "bytes": 0})
        b = c2["collectives"].get(op, {"count": 0, "bytes": 0})
        coll[op] = {k: _extrapolate(a[k], b[k], L1, L2, L) for k in ("count", "bytes")}
    if n_mb > 1:
        cmb = build_census(_probe_cfg(cfg, L1), shape, device_mesh, microbatches=2)
        for k in ("bytes", "coll"):
            out[k] += max(cmb[k] - c1[k], 0.0) * (L / L1) * (n_mb - 1)
    out["collectives"] = coll
    out["probe_layers"] = (L1, L2)
    out["probes"] = {str(L1): c1, str(L2): c2}
    return out


def roofline(flops: float, nbytes: float, coll: float) -> dict:
    """Seconds at the H100's peaks: bf16 tensor-core FLOPs, HBM bytes,
    NVLink bytes (one direction)."""
    t = {"t_compute_s": flops / PEAK_FLOPS_BF16, "t_memory_s": nbytes / HBM_BW,
         "t_collective_s": coll / NVLINK_BW}
    t["dominant"] = max((("compute", t["t_compute_s"]), ("memory", t["t_memory_s"]),
                         ("collective", t["t_collective_s"])), key=lambda kv: kv[1])[0]
    return t


def lower_one(arch_id: str, shape_name: str, multi_pod: bool, verbose: bool = True,
              overrides: dict = None, tag: str = "", optimized: bool = False) -> dict:
    """The census record of one pair on one production mesh, run under a
    fake process group of the mesh's 256 or 512 ranks. The reference's
    keys where they carry over: ``n_params``, ``n_active_params``,
    ``microbatches``, ``memory``, ``collectives``, ``cost.*_per_device``,
    ``roofline`` (against the H100)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = runtime_config(arch_id, shape, optimized=optimized)
    if optimized and not tag:
        tag = "opt"
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh_shape = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch_id, "shape": shape_name, "tag": tag, "overrides": overrides or {},
           "mesh": "2x16x16" if multi_pod else "16x16", "ok": False}
    t0 = time.time()
    n_dp = mesh_shape.shape.get("data", 1) * mesh_shape.shape.get("pod", 1)
    mb = microbatches_for(cfg, shape, n_dp)
    params_abs = abstract_params(cfg)
    n_total, n_active = active_params(cfg, params_abs)
    rec.update(n_params=n_total, n_active_params=n_active, microbatches=mb)
    rules = rules_for(cfg)
    state_bytes = 0
    if shape.kind == "train":
        state_bytes = _local_bytes(make_optimizer(optimizer_for(cfg)).init(params_abs),
                                   mesh_shape, rules)
    elif shape.kind == "decode":
        state_bytes = _local_bytes(cache_specs(cfg, shape), mesh_shape, rules)
    params_bytes = _local_bytes(params_abs, mesh_shape, rules)
    input_bytes = sum(math.prod(local_shape(t.shape, _input_spec(t, mesh_shape, rules),
                                            mesh_shape)) * t.element_size()
                      for t in input_specs(cfg, shape).values())
    rec["memory"] = {
        "params_bytes": params_bytes, "state_bytes": state_bytes, "input_bytes": input_bytes,
        "argument_bytes": params_bytes + state_bytes + input_bytes,
        "temp_bytes": None,
        "note": "per device, from the placement table; no program is compiled, so no "
                "temporary bytes are known (probe_on_card measures a card's peak)"}
    with fake_world(mesh_shape.size):
        device_mesh = make_production_mesh(multi_pod=multi_pod, group=_world())
        if multi_pod and _pod_data_together(cfg, shape, mesh_shape, rules):
            # DTensor plans a step on three mesh dimensions in tens of
            # minutes; where every placed tree names pod and data together
            # they are one dimension of 32
            device_mesh = flattened_view(device_mesh, ("pod", "data"))
            rec["mesh_view"] = "pod x data flattened: (32, 16)"
        probe = cost_probe(cfg, shape, device_mesh, mb)
    rec["census_s"] = round(time.time() - t0, 1)
    rec["collectives"] = probe["collectives"]
    rec["cost"] = {"flops_per_device": probe["flops"], "bytes_per_device": probe["bytes"],
                   "collective_bytes_per_device": probe["coll"],
                   "probe_layers": probe["probe_layers"],
                   "counted_on": "each rank's local shards (replicated work counted on "
                                 "every rank); bytes are op inputs + outputs, unfused"}
    rec["probes"] = probe["probes"]
    mf = model_flops(cfg, shape, n_total, n_active)
    rec["roofline"] = {**roofline(probe["flops"], probe["bytes"], probe["coll"]),
                       "model_flops": mf, "flops_global": probe["flops"] * mesh_shape.size,
                       "useful_flops_ratio": mf / max(probe["flops"] * mesh_shape.size, 1.0)}
    rec["ok"] = True
    if verbose:
        r = rec["roofline"]
        print(f"[dryrun] {arch_id:28s} {shape_name:12s} {rec['mesh']:8s} "
              f"census={rec['census_s']:6.1f}s args/dev="
              f"{rec['memory']['argument_bytes'] / 2**30:7.2f}GiB "
              f"Tc={r['t_compute_s']:.3e} Tm={r['t_memory_s']:.3e} "
              f"Tcoll={r['t_collective_s']:.3e} dom={r['dominant']} "
              f"useful={r['useful_flops_ratio']:.2f}", flush=True)
    return rec


def _pod_data_together(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: AxisRules) -> bool:
    """Whether every spec the table gives the params, the optimizer state
    or cache and the inputs names ``pod`` and ``data`` together or not at
    all."""
    trees = [abstract_params(cfg)]
    if shape.kind == "train":
        trees.append(make_optimizer(optimizer_for(cfg)).init(trees[0]))
    elif shape.kind == "decode":
        trees.append(cache_specs(cfg, shape))
    specs = [spec for tree in trees
             for _, spec in tree_paths_and_leaves(build_param_specs(tree, mesh, rules))]
    specs += [_input_spec(t, mesh, rules) for t in input_specs(cfg, shape).values()]
    for spec in specs:
        for part in spec:
            axes = set(() if part is None else (part,) if isinstance(part, str) else part)
            if ("pod" in axes) != ("data" in axes):
                return False
    return True


def _world():
    import torch.distributed as dist
    return dist.group.WORLD


# ---------------------------------------------------------------------------
# the one-card probe


def _card_step(cfg: ModelConfig, shape: ShapeConfig, device: torch.device, batch_rows: int,
               microbatches: int):
    """(params, thunk) of the real step at ``batch_rows`` rows on
    ``device``, random weights and tokens from seed 0; decode runs at
    position S - 1 of a zero cache."""
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    per_dev = dataclasses.replace(shape, global_batch=batch_rows)
    batch = {}
    for k, t in input_specs(cfg, per_dev).items():
        if t.dtype == torch.int32 and t.dim():
            batch[k] = torch.randint(0, cfg.vocab_size, tuple(t.shape), generator=gen,
                                     device=device, dtype=torch.int32)
        elif t.dim():
            batch[k] = torch.randn(tuple(t.shape), generator=gen, device=device).to(t.dtype)
        else:
            batch[k] = torch.full((), shape.seq_len - 1, dtype=t.dtype, device=device)
    if shape.kind == "decode":
        def place(_):
            return model.init_cache(batch_rows, shape.seq_len, device)
    else:
        def place(tree):
            return tree
    return params, _step_fn(cfg, per_dev, microbatches)(params, place, batch)


def _meta_count(cfg: ModelConfig, shape: ShapeConfig, batch_rows: int, microbatches: int):
    """The :class:`Census` of the same step on plain ``meta`` tensors."""
    per_dev = dataclasses.replace(shape, global_batch=batch_rows)
    params = abstract_params(cfg)
    batch = input_specs(cfg, per_dev)
    step = _step_fn(cfg, per_dev, microbatches)(params, lambda t: t, batch)
    census = Census()
    with census:
        step(params)
    return census.record()


def probe_on_card(arch_id: str, shape_name: str, *, layers=None, device=None,
                  overrides: dict = None) -> dict:
    """The real step of ``runtime_config(arch, shape)`` (plus
    ``overrides``) on one card, unrolled at each depth of ``layers``
    (default :func:`_probe_layers`), at the shape's per-device batch on
    the 16x16 mesh (:func:`per_device_batch`), with
    :func:`microbatches_for`'s count for training. Each depth's step runs
    once under :class:`Census` (its FLOPs, held against the ``meta``
    count of the same step) and once timed with CUDA events after
    ``reset_peak_memory_stats``. ms, peak bytes and FLOPs are
    extrapolated to the full depth as :func:`cost_probe` does. Raises
    without a card."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"probe_on_card runs on a CUDA device, not {device}")
    shape = INPUT_SHAPES[shape_name]
    cfg = runtime_config(arch_id, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    layers = tuple(layers or _probe_layers(cfg))
    rows = per_device_batch(shape)
    mb = microbatches_for(cfg, shape)
    rec = {"arch": arch_id, "shape": shape_name, "batch_rows": rows, "microbatches": mb,
           "remat": cfg.remat, "sliding_window": cfg.sliding_window,
           "optimizer": optimizer_for(cfg).name if shape.kind == "train" else None,
           "device": torch.cuda.get_device_name(device), "depths": {}}
    for L in layers:
        pcfg = _probe_cfg(cfg, L)
        params, step = _card_step(pcfg, shape, device, rows, mb)
        census = Census()
        with census:
            out = step(params)
        torch.cuda.synchronize(device)
        del out
        meta = _meta_count(pcfg, shape, rows, mb)
        d = {"flops": census.flops, "meta_flops": meta["flops"], "bytes": census.bytes,
             "meta_bytes": meta["bytes"]}
        torch.cuda.reset_peak_memory_stats(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(params)
        end.record()
        torch.cuda.synchronize(device)
        d["ms"] = start.elapsed_time(end)
        d["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        del out
        rec["depths"][str(L)] = d
        del params, step
        torch.cuda.empty_cache()
    if len(layers) == 2:
        L1, L2 = layers
        a, b = rec["depths"][str(L1)], rec["depths"][str(L2)]
        rec["full_depth"] = {k: _extrapolate(a[k], b[k], L1, L2, cfg.n_layers)
                             for k in a if k in b}
        rec["full_depth"]["n_layers"] = cfg.n_layers
        f = rec["full_depth"]
        rec["roofline"] = roofline(f["flops"], f["bytes"], 0.0)
    return rec


# ---------------------------------------------------------------------------


def save(rec: dict, out_dir: Path = ARTIFACT_DIR) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    kind = "card" if rec.get("depths") else rec.get("mesh", "")
    path = out_dir / f"dryrun_{rec['arch']}_{rec['shape']}_{kind}{tag}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    return path


def failed_op(exc: BaseException) -> str:
    """The op an error names (``aten.x.y``, ``repro_torch.x``), or ""."""
    m = re.search(r"\b(aten|repro_torch|_c10d_functional|c10d)\.[\w.]+", str(exc))
    return m.group(0) if m else ""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the kept §Perf variants (records tagged _opt)")
    ap.add_argument("--card", action="store_true",
                    help="also run probe_on_card for each pair (needs a CUDA device)")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            if not shape_applicable(arch, shape):
                print(f"[dryrun] {arch} {shape}: SKIP (documented)")
                continue
            jobs = [("mesh", mp) for mp in meshes] + ([("card", None)] if args.card else [])
            for kind, mp in jobs:
                try:
                    if kind == "card":
                        rec = probe_on_card(arch, shape)
                        print(f"[dryrun] {arch} {shape} card: {json.dumps(rec['full_depth'])}")
                    else:
                        rec = lower_one(arch, shape, mp, optimized=args.optimized)
                    save(rec, args.out)
                except Exception as e:  # noqa: BLE001
                    op = failed_op(e)
                    failures.append((arch, shape, kind, mp, op, repr(e)))
                    save({"arch": arch, "shape": shape, "tag": "failed",
                          "mesh": "card" if kind == "card" else
                          ("2x16x16" if mp else "16x16"),
                          "ok": False, "failed_op": op, "error": repr(e)[:2000]}, args.out)
                    print(f"[dryrun] {arch} {shape} {kind} multi_pod={mp} FAILED"
                          f"{' at ' + op if op else ''}: {e}")
                    traceback.print_exc()
                    if not args.continue_on_error:
                        raise SystemExit(1)
    if failures:
        print(f"{len(failures)} failures")
        raise SystemExit(1)
    print("dry-run complete: every pair ran its census.")


if __name__ == "__main__":
    main()
