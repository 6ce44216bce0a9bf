"""Multi-device voxel-grid evaluation for export
(designcsg_tpu/parallel/export.py of the JAX package).

The z-rows of each slab of the export grid shard over the mesh, the scene
replicated (the voxel-tile data parallelism of SURVEY.md §2.7): rank k
evaluates rows ``[k*per, (k+1)*per)`` of the slab with the grid kernel (K3)
on the card or the plain tape on the CPU, and ``all_gather`` assembles the
slab on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..compiler import CompiledScene
from ..ops.cuda.sdf_kernel import lattice_points, make_grid_eval
from ..ops.interpreter import make_primary_sdf
from .mesh import gather_rows, make_mesh, mesh_device, mesh_rank


def make_sharded_corner_provider(
    scene: CompiledScene,
    center,
    half_diameter: float,
    resolution: int,
    mesh: Optional[DeviceMesh] = None,
    use_kernels: Optional[bool] = None,
) -> Callable[[int, int], np.ndarray]:
    """``corner_provider(z0, sz) -> f32[sz+1, res+1, res+1]`` (numpy, on
    every rank): the SDF at the lattice ``lo + cell * (x, y, z0 + z)`` of
    ``center ± half_diameter``, with the slab's z-rows split across the
    mesh's ranks (the last rank's block may overhang; the overhang is
    sliced off).  ``use_kernels`` (the JAX package's ``use_pallas``): the
    grid kernel's field, K3 on the card (its plain version on the CPU); by
    default on the card for a scene with CUDA bodies.  Otherwise the exact
    tape evaluates the same lattice, made on the rank's device."""
    from ..ops.cuda.brushes_kernel import supports_scene

    mesh = mesh or make_mesh()
    device = mesh_device(mesh)
    k, n = mesh_rank(mesh)
    r1 = resolution + 1
    center = np.asarray(center, np.float64)
    cell = 2.0 * half_diameter / resolution
    lo32 = np.asarray(center - half_diameter, np.float32)
    cell32 = np.float32(cell)
    if use_kernels is None:
        use_kernels = device.type == "cuda" and supports_scene(scene)
    arrays = scene.arrays.to_torch(device)
    if use_kernels:
        grid_eval = make_grid_eval(scene)

        def eval_rows(z0f: float, rows: int) -> torch.Tensor:
            return grid_eval(arrays, lo32, cell32, np.float32(z0f), rows, r1)

    else:
        sdf = make_primary_sdf(scene)

        def eval_rows(z0f: float, rows: int) -> torch.Tensor:
            pts = lattice_points(lo32, cell32, np.float32(z0f), rows, r1, r1, device)
            return sdf(pts.reshape(-1, 3), arrays).reshape(rows, r1, r1)

    def provider(z0: int, sz: int) -> np.ndarray:
        nz = sz + 1
        per = -(-nz // n)  # rows per rank (the last rank's block may overhang)
        block = eval_rows(float(z0 + k * per), per)
        return gather_rows(block, mesh)[:nz].cpu().numpy()

    return provider
