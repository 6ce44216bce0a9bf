"""Device meshes over ``torch.distributed`` (designcsg_tpu/parallel/mesh.py of
the JAX package).

The scaling model (SURVEY.md §5.8): rays and voxel slabs shard over the
ranks of a mesh, the scene (object banks, tape, arbitrary data: a few hundred
KB) is replicated, and the fit's gradients all-reduce.  The JAX package runs
one controller over a ``jax.sharding.Mesh`` and ``shard_map``; here, as is
PyTorch's idiom, every rank is a process with one device and runs the same
program (``torchrun --nproc-per-node N``, or a launcher of its own), and the
collectives come from ``torch.distributed``: NCCL on the card, gloo on the
CPU.  A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
world's ranks in rank order; each rank's device is ``cuda:<local rank>``, or
the CPU when the mesh is made with ``device="cpu"``.

One process per card also gives each rank its own kernel libraries, so a
unit whose object bank sits in constant memory (csrc/common.cuh) serves one
card's stream in each process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .. import resolve_device

RAY_AXIS = "rays"


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)`` (multi-process
    bring-up; every rank calls it before building meshes), or nothing when
    the group is already initialized, as the JAX package's
    ``jax.distributed.initialize`` wrapper does nothing then.  Without a
    ``backend`` the rank's card picks NCCL, the CPU gloo."""
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


def _local_rank() -> int:
    """The rank's index among the ranks of its host (``LOCAL_RANK``, which
    ``torchrun`` sets; else the global rank modulo the host's cards)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    return dist.get_rank() % count if count else 0


def _world(device: torch.device) -> None:
    """The process group, made where none exists: from the environment a
    launcher such as ``torchrun`` sets (``WORLD_SIZE`` above 1), else a
    world of one process on an in-process store, so one card (or the CPU)
    needs no launcher."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device) -> DeviceMesh:
    device = resolve_device(device)
    _world(device)
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks; the world has {world}: "
                         f"launch one process per device")
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank())
    return DeviceMesh(device.type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = RAY_AXIS, device=None) -> DeviceMesh:
    """1-D mesh over the world's ranks (rays and voxels need one axis; a 2-D
    ("host", "chip") mesh is :func:`make_mesh_2d`).  ``n_devices`` must be
    the world's size where it is given: each rank holds one device.
    ``device`` is the ranks' device type: the card unless ``"cpu"``.
    Without a process group this is a world of one."""
    device = resolve_device(device)
    _world(device)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _mesh((n,), (axis_name,), device)


def make_mesh_2d(hosts: Optional[int] = None, axis_names=("host", "chip"), device=None) -> DeviceMesh:
    """("host", "chip") mesh: ``hosts`` rows of the world's ranks in rank
    order (each host's ranks consecutive, as ``torchrun`` numbers them).
    ``hosts`` defaults to the world's size over ``LOCAL_WORLD_SIZE`` (the
    ranks of one host; one host without it)."""
    device = resolve_device(device)
    _world(device)
    world = dist.get_world_size()
    if hosts is None:
        hosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    return _mesh((hosts, world // hosts), tuple(axis_names), device)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The rank's device in ``mesh``: ``cuda:<local rank>`` or the CPU."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, _local_rank())


def mesh_rank(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index over all mesh axes jointly, flattened rank-major;
    the mesh's size).  Rows and points shard over all axes this way, so the
    1-D and 2-D meshes run one program (render.py of the JAX package)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    index = 0
    for c, n in zip(coord, mesh.shape):
        index = index * n + c
    return index, mesh.size()


def replicated(mesh: DeviceMesh):
    """The placements of a tensor every rank holds whole (the JAX package's
    ``NamedSharding(mesh, P())``)."""
    return (Replicate(),) * mesh.ndim


def row_sharded(mesh: DeviceMesh, axis_name: str = RAY_AXIS):
    """The placements of a tensor whose leading axis (image rows, point
    batches) shards over the mesh axis ``axis_name``, replicated over any
    other (``NamedSharding(mesh, P(axis_name))``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"the mesh has no axis {axis_name!r}: its axes are {names}")
    return tuple(Shard(0) if name == axis_name else Replicate() for name in names)


def gather_rows(block: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``block`` (equal shapes), concatenated along the leading
    axis in the mesh's rank-major order, on every rank."""
    _, n = mesh_rank(mesh)
    if n == 1:
        return block
    parts = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(parts, block.contiguous())
    return torch.cat(parts)


def broadcast_from_first(obj, mesh: DeviceMesh):
    """The mesh's first rank's ``obj`` (any picklable value), on every rank."""
    _, n = mesh_rank(mesh)
    if n == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh_device(mesh))
    return box[0]
