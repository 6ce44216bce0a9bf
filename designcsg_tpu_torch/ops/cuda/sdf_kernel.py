"""SDF point evaluation (k2) and grid evaluation: CUDA kernels and their plain
versions.

Counterparts of the JAX package's ops/pallas/sdf_kernel.py
(``make_pallas_point_eval``, ``make_grid_eval``).  Kernel source:
csrc/sdf_kernels.cu plus the scene code generated by ops/cuda/tape.py.

Each wrapper takes its plain version for tensors on the CPU, and for tensors
on a CUDA device launches its kernel or raises.  ``arrays`` is a SceneArrays
of tensors on the same device as the points.  Kernels and plain versions
evaluate each brush's twin, the field its CUDA body computes (Logo's baked
letters through csrc/table.cuh, K6; the exact tape for every other design).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...compiler import CompiledScene, SceneArrays
from ..interpreter import make_primary_sdf
from .build import bank_pointers, check_launch, load, on_cuda, ptr, require_cuda_f32, stream_handle
from .tape import sdf_kernel_source

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


def _library(scene: CompiledScene) -> ctypes.CDLL:
    lib = load("sdf", sdf_kernel_source(scene))
    lib.launch_point_eval.argtypes = [_P, _P, ctypes.c_longlong] + [_P] * 7
    lib.launch_point_eval.restype = ctypes.c_int
    lib.launch_grid_eval.argtypes = [_P, _I, _I, _I, _F, _F, _F, _F, _F] + [_P] * 7
    lib.launch_grid_eval.restype = ctypes.c_int
    return lib


def make_point_eval(scene: CompiledScene):
    """``point_eval(points f32[N, 3], arrays) -> f32[N]``, the k2 SDF (no gizmo,
    twin field) at arbitrary points.  ``point_eval.plain`` is its plain
    version."""
    plain = make_primary_sdf(scene, field="twin")
    libs = {}

    def point_eval(points: torch.Tensor, arrays: SceneArrays) -> torch.Tensor:
        if not on_cuda(points):
            return plain(points, arrays)
        device = points.device
        require_cuda_f32("points", points, device)
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(f"points must be [N, 3], got {tuple(points.shape)}")
        if "lib" not in libs:
            libs["lib"] = _library(scene)
        n = points.shape[0]
        out = torch.empty((n,), dtype=torch.float32, device=device)
        if n == 0:
            return out
        rc = libs["lib"].launch_point_eval(
            ptr(points), ptr(out), n, *bank_pointers(scene, arrays, device), stream_handle(device)
        )
        check_launch("point_eval", rc)
        return out

    point_eval.plain = plain
    return point_eval


def lattice_points(lo, cell, z0, slab: int, ny: int, nx: int, device) -> torch.Tensor:
    """f32[slab, ny, nx, 3] lattice ``lo + cell * (x, y, z0 + z)``, rounded as
    the grid kernel rounds it: one f32 product, then one f32 sum."""
    lo = [float(v) for v in np.asarray(lo, np.float32).reshape(3)]
    cell, z0 = float(np.float32(cell)), float(np.float32(z0))

    def axis(n):
        return torch.arange(n, dtype=torch.float32, device=device)

    x = lo[0] + cell * axis(nx)
    y = lo[1] + cell * axis(ny)
    z = lo[2] + cell * (z0 + axis(slab))
    return torch.stack(
        [
            x[None, None, :].expand(slab, ny, nx),
            y[None, :, None].expand(slab, ny, nx),
            z[:, None, None].expand(slab, ny, nx),
        ],
        dim=-1,
    )


def make_grid_eval(scene: CompiledScene):
    """``grid_eval(arrays, lo, cell, z0, slab, ny, nx=None) -> f32[slab, ny, nx]``,
    the SDF (twin field) at the lattice ``lo + cell * (x, y, z0 + z)`` —
    z-major, no coordinate input.  The device is that of ``arrays``.
    ``grid_eval.plain`` is its plain version."""
    sdf = make_primary_sdf(scene, field="twin")
    libs = {}

    def plain(arrays, lo, cell, z0, slab: int, ny: int, nx: Optional[int] = None):
        nx = ny if nx is None else nx
        return sdf(lattice_points(lo, cell, z0, slab, ny, nx, arrays.ad.device), arrays)

    def grid_eval(arrays, lo, cell, z0, slab: int, ny: int, nx: Optional[int] = None):
        if not on_cuda(arrays.ad):
            return plain(arrays, lo, cell, z0, slab, ny, nx)
        nx = ny if nx is None else nx
        device = arrays.ad.device
        if "lib" not in libs:
            libs["lib"] = _library(scene)
        out = torch.empty((slab, ny, nx), dtype=torch.float32, device=device)
        if out.numel() == 0:
            return out
        lox, loy, loz = (float(v) for v in np.asarray(lo, np.float32).reshape(3))
        rc = libs["lib"].launch_grid_eval(
            ptr(out), slab, ny, nx, lox, loy, loz,
            float(np.float32(cell)), float(np.float32(z0)),
            *bank_pointers(scene, arrays, device), stream_handle(device),
        )
        check_launch("grid_eval", rc)
        return out

    grid_eval.plain = plain
    return grid_eval
