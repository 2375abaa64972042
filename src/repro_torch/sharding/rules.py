"""Logical-axis placement rules on DTensor (counterpart of
``repro.sharding.rules``).

Model code never names mesh axes. A parameter gets *logical* axes from
its tree path and rank (:func:`logical_axes_for_path`); an activation is
annotated with :func:`shard_act`. A rule table maps each logical axis to
mesh axes, tried in order: an axis that does not divide the dimension,
or that the spec already uses, is skipped, so the dimension stays whole
rather than failing.

A spec is a plain tuple with one entry a tensor dimension: ``None``,
one mesh axis name, or a tuple of them (the reference's
``PartitionSpec`` entries). :func:`spec_for` reads the mesh sizes from
``mesh.shape``, a dict (a shape-only mesh) or, on a
``torch.distributed.device_mesh.DeviceMesh``, the sizes of its named
dimensions. :func:`placements_for` turns a spec into DTensor placements,
one ``Shard(d)`` or ``Replicate()`` a mesh dimension.

One difference from the reference: a tensor dimension split over two
mesh axes (``("data", "pod")``) is split data-major by JAX and in mesh
order (``pod`` first on a ``("pod", "data", "model")`` mesh) by DTensor.
Each rank's shard has the same shape and bytes either way; which block
of the dimension a rank holds differs.

Physical mesh axes:
  pod    outer swarm-client / pure data-parallel axis (two pods only)
  data   batch / FSDP axis
  model  tensor-parallel axis
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.utils.tree import tree_map, tree_paths_and_leaves

#: logical axis -> mesh axes, tried in order, each divisibility-checked
DEFAULT_LOGICAL_TO_PHYSICAL = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "cache_seq": ("data", "model"),   # decode's KV cache; at B = 1 (long_500k)
                                      # "data" is free and the cache splits
                                      # 256 ways over its positions
    "embed": (),
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_experts": ("model",),
    # parameters
    "p_embed": ("data", "pod"),        # FSDP axes of the weights
    "p_mlp": ("model",),
    "p_heads": ("model",),
    "p_kv": ("model",),
    "p_vocab": ("model",),
    "p_experts": ("model",),
    "p_state": (),
    "p_conv": (),
    "layers": (),                      # the scanned layout's stacked axis
    "clients": ("pod",),               # the fleet's client axis
}


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a shape-only mesh or a :class:`MeshView`
    (``.shape`` a dict) or of a ``DeviceMesh`` with named dimensions."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclass(frozen=True)
class MeshView:
    """A ``DeviceMesh`` whose dimensions each carry one or more of the
    table's axes: ``dims[i]`` names the axes of mesh dimension i, and
    ``shape`` gives each axis's size, which :func:`spec_for` reads. The
    2x16x16 mesh seen as ``(("pod", "data"), ("model",))`` places a spec
    that names pod and data together on one flattened dimension of 32."""
    device_mesh: object
    shape: dict
    dims: tuple


def view_of(mesh) -> Optional[MeshView]:
    """``mesh`` as a :class:`MeshView`: a ``DeviceMesh`` with one axis a
    dimension, a view as it is, None for a shape-only mesh."""
    if isinstance(mesh, MeshView):
        return mesh
    if isinstance(mesh.shape, dict):
        return None
    return MeshView(mesh, mesh_sizes(mesh), tuple((n,) for n in mesh.mesh_dim_names))


def flattened_view(device_mesh, axes: tuple) -> MeshView:
    """``device_mesh`` with its dimensions ``axes`` (adjacent, in mesh
    order) flattened into one: DTensor plans redistributions on two mesh
    dimensions far faster than on three."""
    sizes = mesh_sizes(device_mesh)
    name = "_".join(axes)
    device_mesh[axes]._flatten(name)
    rest = [n for n in device_mesh.mesh_dim_names if n not in axes]
    first = device_mesh.mesh_dim_names.index(axes[0])
    names = rest[:first] + [name] + rest[first:]
    dims = tuple(axes if n == name else (n,) for n in names)
    return MeshView(device_mesh[tuple(names)], sizes, dims)


@dataclass(frozen=True)
class AxisRules:
    logical_to_physical: dict = field(
        default_factory=lambda: dict(DEFAULT_LOGICAL_TO_PHYSICAL))

    def physical(self, logical: Optional[str], mesh, dim_size: int,
                 taken: set) -> Optional[tuple]:
        """The mesh axes of one logical axis: each candidate in order
        that the spec does not use yet and whose size, times those chosen
        before it, divides ``dim_size``. None if no axis is left."""
        if logical is None:
            return None
        sizes = mesh_sizes(mesh)
        chosen = []
        prod = 1
        for ax in self.logical_to_physical.get(logical, ()):
            if ax in taken or ax not in sizes:
                continue
            if dim_size % (prod * sizes[ax]) == 0:
                chosen.append(ax)
                prod *= sizes[ax]
        if not chosen:
            return None
        taken.update(chosen)
        return tuple(chosen)


DEFAULT_RULES = AxisRules()

# ---------------------------------------------------------------------------
# parameter path -> logical axes

# the first pattern that matches the path wins
_PARAM_PATH_RULES = [
    # embeddings / heads
    (r"embedding/table$",            ("p_vocab", "p_embed")),
    (r"pos_embedding/table$",        (None, "p_embed")),
    (r"lm_head/w$",                  ("p_embed", "p_vocab")),
    # attention
    (r"attn.*/wq$",                  ("p_embed", "p_heads")),
    (r"attn.*/wk$",                  ("p_embed", "p_kv")),
    (r"attn.*/wv$",                  ("p_embed", "p_kv")),
    (r"attn.*/wo$",                  ("p_heads", "p_embed")),
    (r"attn.*/(bq|bk|bv)$",          ("p_heads",)),
    (r"attn.*/bo$",                  ("p_embed",)),
    # dense mlp
    (r"mlp/wi$",                     ("p_embed", "p_mlp")),
    (r"mlp/wg$",                     ("p_embed", "p_mlp")),
    (r"mlp/wo$",                     ("p_mlp", "p_embed")),
    (r"mlp/(bi|bg)$",                ("p_mlp",)),
    (r"mlp/bo$",                     ("p_embed",)),
    # moe
    (r"router/w$",                   ("p_embed", "p_experts")),
    (r"router/b$",                   ("p_experts",)),
    (r"experts/wi$",                 ("p_experts", "p_embed", "p_mlp")),
    (r"experts/wg$",                 ("p_experts", "p_embed", "p_mlp")),
    (r"experts/wo$",                 ("p_experts", "p_mlp", "p_embed")),
    (r"shared_expert/wi$",           ("p_embed", "p_mlp")),
    (r"shared_expert/wg$",           ("p_embed", "p_mlp")),
    (r"shared_expert/wo$",           ("p_mlp", "p_embed")),
    # mamba2 / ssm
    (r"ssm/in_proj$",                ("p_embed", "p_heads")),
    (r"ssm/out_proj$",               ("p_heads", "p_embed")),
    (r"ssm/conv_w$",                 ("p_conv", "p_heads")),
    (r"ssm/conv_b$",                 ("p_heads",)),
    (r"ssm/(A_log|dt_bias|D)$",      ("p_heads",)),
    (r"ssm/norm_scale$",             ("p_heads",)),
    # decode caches
    (r"(^|/)(k|v)$",                 ("batch", "cache_seq", "p_kv", None)),
    (r"cross_(k|v)$",                (None, "batch", None, "p_kv", None)),
    (r"(^|/)conv$",                  ("batch", None, "p_heads")),
    (r"(^|/)state$",                 ("batch", "p_heads", None, None)),
    # norms / scalars
    (r"(scale|bias)$",               (None,)),
    # cnn (small models: replicated)
    (r"conv\d*/w$",                  (None, None, None, None)),
    (r"conv\d*/b$",                  (None,)),
    (r"fc\d*/w$",                    ("p_embed", None)),
    (r"fc\d*/b$",                    (None,)),
]


def logical_axes_for_path(path: str, ndim: int) -> tuple:
    """The logical axes of the leaf at ``path`` of rank ``ndim``.

    A rule one axis short of the rank gets a leading ``"layers"`` axis
    (the scanned layout's stacked leaves); any other rank mismatch is
    replicated. Adafactor's factored states inherit their weight's axes:
    ``.../vr`` drops its last axis, ``.../vc`` its second-to-last.
    """
    if path.endswith("/vr"):
        return logical_axes_for_path(path[:-3], ndim + 1)[:-1]
    if path.endswith("/vc"):
        parent = logical_axes_for_path(path[:-3], ndim + 1)
        return parent[:-2] + parent[-1:]
    for pat, axes in _PARAM_PATH_RULES:
        if re.search(pat, path):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                return ("layers",) + axes
            return (None,) * ndim
    return (None,) * ndim


def spec_for(logical_axes: tuple, mesh, shape, rules: AxisRules = DEFAULT_RULES) -> tuple:
    """The spec of a tensor of ``shape`` with ``logical_axes`` on
    ``mesh``: no mesh axis twice, and each dimension divisible by the
    product of its axes' sizes."""
    taken: set = set()
    parts = []
    for logical, dim in zip(logical_axes, shape):
        phys = rules.physical(logical, mesh, int(dim), taken)
        parts.append(None if phys is None else phys[0] if len(phys) == 1 else phys)
    return tuple(parts)


def build_param_specs(params, mesh, rules: AxisRules = DEFAULT_RULES):
    """A tree of specs mirroring ``params`` (any tree of objects with
    ``.shape``: tensors, meta tensors)."""
    specs = {path: spec_for(logical_axes_for_path(path, len(leaf.shape)), mesh, leaf.shape,
                            rules)
             for path, leaf in tree_paths_and_leaves(params)}
    return _map_with_paths(lambda path, _: specs[path], params)


def _map_with_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


# ---------------------------------------------------------------------------
# specs -> DTensor placements


def placements_for(spec: tuple, mesh) -> tuple:
    """One placement a dimension of ``mesh`` (a ``DeviceMesh`` or a
    :class:`MeshView`): ``Shard(d)`` where the spec puts that dimension's
    axes on tensor dimension ``d``, else ``Replicate()``; a mesh dimension
    of one rank is ``Replicate()`` either way (the same layout, and DTensor
    then plans no redistribution over it). Raises where a spec names only
    some of a flattened dimension's axes."""
    from torch.distributed.tensor import Replicate, Shard
    view = view_of(mesh)
    placements = [Replicate()] * len(view.dims)
    for d, part in enumerate(spec):
        axes = set(() if part is None else (part,) if isinstance(part, str) else part)
        for i, dim_axes in enumerate(view.dims):
            if set(dim_axes) <= axes:
                if math.prod(view.shape[a] for a in dim_axes) > 1:
                    placements[i] = Shard(d)
                axes -= set(dim_axes)
            elif set(dim_axes) & axes:
                raise ValueError(f"spec {spec} splits dimension {d} over {sorted(axes)}, "
                                 f"but one mesh dimension carries {dim_axes} together")
    return tuple(placements)


def build_param_placements(params, device_mesh, rules: AxisRules = DEFAULT_RULES):
    """A tree of DTensor placements (a tuple a leaf) mirroring ``params``."""
    return tree_map(lambda s: placements_for(s, device_mesh),
                    build_param_specs(params, device_mesh, rules))


def distribute(params, mesh, rules: AxisRules = DEFAULT_RULES):
    """``params`` as DTensors on ``mesh`` (a ``DeviceMesh`` or a
    :class:`MeshView`), each leaf placed by the table (a ``meta`` leaf
    stays on ``meta``: no rank allocates)."""
    from torch.distributed.tensor import distribute_tensor
    view = view_of(mesh)
    placements = build_param_placements(params, view, rules)
    return tree_map(lambda t, pl: distribute_tensor(t, view.device_mesh, pl), params,
                    placements)


# ---------------------------------------------------------------------------
# client-stacked trees: the fleet's placed leaves


def _shifted(placements, by: int) -> tuple:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(d + by)``:
    between a client-stacked leaf and one client's."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + by) if isinstance(p, Shard) else p for p in placements)


def local_chunk(t: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` under ``placements``: each ``Shard(d)``
    takes this rank's chunk of dimension ``d``, mesh dimensions in
    order (DTensor's layout)."""
    from torch.distributed.tensor import Shard
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(device_mesh.size(i), dim=p.dim)[coord[i]]
    return t


def place_local(t: torch.Tensor, mesh, placements):
    """``t``, whole on every rank, as a DTensor on ``mesh`` (a
    ``DeviceMesh`` or a :class:`MeshView`) with ``placements``: each
    rank keeps its own chunk, so no collective runs."""
    from torch.distributed.tensor import DTensor
    dm = view_of(mesh).device_mesh
    return DTensor.from_local(local_chunk(t, dm, placements), dm, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_stacked(tree, mesh, rules: AxisRules = DEFAULT_RULES):
    """A client-stacked tree ((N, ...) leaves), whole on every rank of
    ``mesh``, as DTensors (no collective): each leaf placed by the table
    as one client's leaf would be, the client axis never split."""
    one = tree_map(lambda x: torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device="meta"),
                   tree)
    return tree_map(lambda t, pl: place_local(t, mesh, _shifted(pl, 1)), tree,
                    build_param_placements(one, mesh, rules))


def place_batch(batch: dict, mesh, rules: AxisRules = DEFAULT_RULES) -> dict:
    """One client's batch leaves, whole on every rank, split on their
    batch axis (axis 0) by the table (no collective)."""
    out = {}
    for k, t in batch.items():
        spec = spec_for(("batch",) + (None,) * (t.dim() - 1), mesh, t.shape, rules)
        out[k] = place_local(t.contiguous(), mesh, placements_for(spec, mesh))
    return out


def is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def on_shard(fn, x, *rest):
    """``fn`` over this rank's shards of ``x`` and ``rest``, placed back
    as ``x`` is (no collective); plain tensors go to ``fn`` as they are."""
    if not is_placed(x):
        return fn(x, *rest)
    from torch.distributed.tensor import DTensor
    out = fn(x.to_local(), *(r.to_local() if is_placed(r) else r for r in rest))
    return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def client_view(x, c: int):
    """Client ``c`` of a stacked DTensor (its client axis never split),
    as a DTensor of one client's shape (no collective)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(x.shape[1:])
    return DTensor.from_local(x.to_local()[c], x.device_mesh, _shifted(x.placements, -1),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def write_client(dst, c: int, x, keep=None) -> None:
    """Client ``c`` of the stacked DTensor ``dst`` set to the one-client
    DTensor ``x`` in place (where the () bool tensor ``keep`` is true,
    if given); ``x`` placed otherwise than a client of ``dst`` (a partial
    sum, a replicated gradient step) is redistributed first."""
    pl = _shifted(dst.placements, -1)
    if tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    slot = dst.to_local()[c]
    src = x.to_local()
    slot.copy_(src if keep is None else torch.where(keep, src, slot))


def mesh_group(device_mesh):
    """One process group over every rank of ``device_mesh``: its own on
    one dimension, else the group of its flattened view."""
    if device_mesh.ndim == 1:
        return device_mesh.get_group()
    return device_mesh._flatten("_".join(device_mesh.mesh_dim_names)).get_group()


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape`` under
    ``spec``."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, part in zip(shape, spec):
        n = 1
        for ax in (() if part is None else (part,) if isinstance(part, str) else part):
            n *= sizes[ax]
        out.append(int(dim) // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# activation placement context


class _ShardingCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: AxisRules = DEFAULT_RULES


_CTX = _ShardingCtx()


@contextlib.contextmanager
def use_sharding(mesh, rules: AxisRules = DEFAULT_RULES):
    """Place the activations that model code annotates with
    :func:`shard_act` on ``mesh`` (a ``DeviceMesh``, a :class:`MeshView`
    or a shape-only mesh) while the context is open. Without it
    :func:`shard_act` is the identity (the single-card regime)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def sharding_active() -> bool:
    """Whether a :func:`use_sharding` context is open."""
    return _CTX.mesh is not None


def places(logical: str, dim_size: int) -> bool:
    """Whether ``logical`` splits a dimension of ``dim_size`` over some
    mesh axis in the open context (False outside one)."""
    mesh = _CTX.mesh
    return mesh is not None and _CTX.rules.physical(logical, mesh, dim_size, set()) is not None


def shard_act(x, *logical_axes):
    """``x`` placed by logical axis names: the identity outside
    :func:`use_sharding`; inside it, a DTensor is redistributed to the
    table's placement on the context's ``DeviceMesh`` (a plain tensor,
    or a shape-only mesh, has nothing to place and passes through).
    The redistribution is an autograd function, so it also runs under
    ``torch.func`` transforms, whose wrapped tensors hide the DTensor."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"shard_act: {len(logical_axes)} axes for a rank-{x.dim()} tensor")
    view = view_of(mesh)
    if view is None:
        return x
    spec = spec_for(logical_axes, view, x.shape, _CTX.rules)
    return _Place.apply(x, view.device_mesh, placements_for(spec, view))


def _base(t):
    """The tensor under ``torch.func``'s wrappers."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


class _Place(torch.autograd.Function):
    """A DTensor redistributed to ``placements``; its gradient goes back
    to the input's placements (a partial sum as replicated) through
    ``_Place`` again, so that it is placed under any ``torch.func`` level
    too. A plain tensor passes through."""

    @staticmethod
    def forward(x, mesh, placements):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def setup_context(ctx, inputs, output):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        x, mesh, _ = inputs
        x = _base(x)
        ctx.mesh = mesh
        ctx.back = (tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
                    if isinstance(x, DTensor) else None)

    @staticmethod
    def backward(ctx, g):
        if ctx.back is None:
            return g, None, None
        return _Place.apply(g, ctx.mesh, ctx.back), None, None
