"""The fleet's mesh on ``torch.distributed`` (counterpart of
``repro.launch.mesh.make_fleet_mesh``).

A rank is a shard of the reference's ``pod`` axis: it holds ``N /
world`` consecutive clients. One card is one rank over NCCL, the
reference's trivial mesh; on the CPU a test or the CLI runs one rank in
process or several spawned ranks over gloo (:func:`spawn_cpu_ranks`,
the counterpart of the reference's ``--devices`` stand-in). Every fleet
function takes its process group from the :class:`FleetMesh` it is
given, so one process can hold a fleet on an NCCL group and another on
a gloo group beside it.

:func:`make_production_mesh` gives the reference's production layouts,
16x16 ``("data", "model")`` and 2x16x16 ``("pod", "data", "model")``,
as a shape-only mesh or, over a process group of their size (a real one
or the dry-run's fake one), as a ``DeviceMesh``; :func:`make_pod_mesh`
gives a ``("pod", "data", "model")`` ``DeviceMesh`` of any shape whose
product is the world, the placed fleet's mesh. The roofline constants
are one NVIDIA H100's (SXM part at its 700 W limit, dense rates), in
place of the reference's TPU v5e ones.
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.utils.device import resolve_device

# per-card constants of the roofline: NVIDIA H100 SXM at 700 W, dense rates
PEAK_FLOPS_BF16 = 989e12          # FLOP/s on the tensor cores
HBM_BW = 3.35e12                  # B/s
NVLINK_BW = 450e9                 # B/s each way (900 GB/s both ways)


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh of named axis sizes and no devices: enough for the
    placement table's specs (``sharding.spec_for`` reads ``.shape``)."""
    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi_pod: bool = False, group=None):
    """16x16 ``("data", "model")``, or 2x16x16 ``("pod", "data",
    "model")`` with ``multi_pod``: ``pod`` the swarm-client / outer
    data-parallel axis, ``data`` the batch and FSDP axis, ``model`` the
    tensor / expert axis. Without ``group`` a :class:`ShapeMesh`; with
    the default (world) process group of 256 or 512 ranks a
    ``DeviceMesh`` over it, on CUDA for NCCL and on the CPU otherwise
    (gloo, or the dry-run's fake backend)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if group is None:
        return ShapeMesh(dict(zip(names, shape)))
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size(group)
    if group is not dist.group.WORLD or world != math.prod(shape):
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs the default process "
                         f"group of {math.prod(shape)} ranks, got a group of {world}")
    device_type = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


POD_MESH_AXES = ("pod", "data", "model")


def make_pod_mesh(shape):
    """A ``("pod", "data", "model")`` ``DeviceMesh`` of ``shape`` over the
    default process group, whose world must be the product of ``shape``
    (the counterpart of the reference's ``make_fleet_mesh``, which builds
    ``(n_pod, 1, 1)``): ``pod`` the swarm-client axis of
    ``swarm_fleet.fleet_setup(spmd="auto")``, ``data`` and ``model`` a
    client's FSDP and tensor axes. On CUDA for NCCL, on the CPU
    otherwise (gloo, or the dry-run's fake backend). The process group
    comes first: :func:`make_fleet_mesh` sets up a world of one,
    :func:`spawn_cpu_ranks` a gloo world, ``launch.dryrun.fake_world`` a
    fake one."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"a pod mesh has three positive sizes (pod, data, model), got {shape}")
    if not dist.is_initialized():
        raise RuntimeError("make_pod_mesh needs a process group (make_fleet_mesh, "
                           "spawn_cpu_ranks or launch.dryrun.fake_world sets one up)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} pod mesh needs a world of "
                         f"{math.prod(shape)} ranks, got {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=POD_MESH_AXES)


@dataclass
class FleetMesh:
    """A fleet's process group and this process's place in it."""
    group: object                    # the process group of every fleet collective
    rank: int                        # this process's rank in ``group``
    world: int                       # ranks in ``group`` (pods)
    device: torch.device             # where this rank's clients live
    owns_world: bool = False         # this mesh set up the default process group
    shape: dict = field(default_factory=dict)

    def __post_init__(self):
        self.shape = {"pod": self.world}

    axis_names = ("pod",)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def close(self) -> None:
        """Destroy the default process group if this mesh set it up."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_world = False


def _backend_for(device: torch.device, backend):
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, not {device}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown fleet backend {backend!r} (nccl or gloo)")
    return backend


def make_fleet_mesh(n_clients: int, *, backend=None, device=None) -> FleetMesh:
    """The fleet mesh of ``n_clients`` clients on ``device`` (``cuda``
    unless given). The backend is ``nccl`` on a CUDA device and ``gloo``
    on the CPU. With a process group already set up, the mesh takes the
    default group when its backend matches, else a new group of the same
    ranks on ``backend``; without one it sets up a world of one rank,
    rendezvousing through a ``FileStore`` under a temporary directory,
    so no port is opened (:meth:`FleetMesh.close` destroys it).

    Raises where the world size does not divide ``n_clients``. The
    reference instead keeps the largest device count that divides it:
    a single controller can leave devices idle, a rank cannot sit out a
    collective."""
    device = resolve_device(device)
    backend = _backend_for(device, backend)
    owns = False
    if not dist.is_initialized():
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="fleet_"), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        owns = True
    group = (dist.group.WORLD if dist.get_backend() == backend
             else dist.new_group(backend=backend))
    world = dist.get_world_size(group)
    if n_clients % world:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"{world} ranks do not divide {n_clients} clients: every rank "
                         "holds an equal contiguous slice of the client axis")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return FleetMesh(group=group, rank=dist.get_rank(group), world=world, device=device,
                     owns_world=owns)


def _rank_main(rank: int, fn, world: int, store_path: str, args):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_ranks(fn, world: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned CPU processes joined
    over gloo, each with one intra-op thread; raises if a rank fails.
    ``fn`` must be importable by the children (a module-level function),
    and results come back through files the caller names in ``args``."""
    store_path = os.path.join(tempfile.mkdtemp(prefix="fleet_"), "store")
    mp.spawn(_rank_main, args=(fn, world, store_path, args), nprocs=world, join=True)
