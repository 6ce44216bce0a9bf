"""SDF point evaluation (k2) and grid evaluation: CUDA kernels and their plain
versions.

Counterparts of the JAX package's ops/pallas/sdf_kernel.py
(``make_pallas_point_eval``, ``make_grid_eval`` with its optional exact
per-tile cull, K7).  Kernel source: csrc/sdf_kernels.cu plus the scene code
generated by ops/cuda/tape.py.

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
from ..cull import array_bank_reader, make_culled_sdf, make_tape_culler, stack_cull
from ..interpreter import eval_context, make_normal_fn, make_primary_sdf
from .build import check_launch, load, on_cuda, ptr, require_cuda_f32, scene_args
from .tape import sdf_kernel_source

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int


# The launchers' trailing arguments (csrc/common.cuh SCENE_PARAMS): the bank
# pointers, the bank buffer, the card and the stream.
_SCENE = [_P] * 7 + [_I, _P]


def _library(scene: CompiledScene, gizmo: bool, device: torch.device, fd: bool = False,
             cull: bool = False) -> ctypes.CDLL:
    """The point/grid unit for ``device``, or with ``fd`` the same source
    built without FMA contraction for K1's FD form (build.EXTRA_FLAGS), or
    with ``cull`` the unit that also carries the culled grid."""
    lib = load("sdf_fd" if fd else "sdf", sdf_kernel_source(scene, gizmo, cull=cull), device)
    lib.launch_point_eval.argtypes = [_P, _P, ctypes.c_longlong] + _SCENE
    lib.launch_point_eval.restype = ctypes.c_int
    lib.launch_point_eval_fd.argtypes = [_P, _P, _P, ctypes.c_longlong] + _SCENE
    lib.launch_point_eval_fd.restype = ctypes.c_int
    lib.grid_eval_z_ranges.argtypes = [_I, _I, _I, _I, _P, _P]
    lib.grid_eval_z_ranges.restype = ctypes.c_int
    for fn in (lib.launch_grid_eval,) + ((lib.launch_grid_eval_cull,) if cull else ()):
        fn.argtypes = [_P, _I, _I, _I, _F, _F, _F, _F, _F] + _SCENE
        fn.restype = ctypes.c_int
    return lib


def kernel_name(kernel: str, gizmo: bool) -> str:
    """The launch-count name of a point or grid kernel: each setting of the
    gizmo is a library of its own and is counted apart."""
    return f"{kernel}_gizmo" if gizmo else kernel


def make_point_eval(scene: CompiledScene, gizmo: bool = False):
    """``point_eval(points f32[N, 3], arrays) -> f32[N]``, the SDF (twin
    field) at arbitrary points: the k2 field, or with ``gizmo`` the k1 field
    (the tape min-ed with the axis gizmo, sdf_kernel.py:76-90 of the JAX
    package).  ``point_eval.plain`` is its plain version.

    ``point_eval.fd(points, arrays) -> (f32[N], f32[N, 3])`` is K1 in its FD
    form: the same SDF and its central-difference normal (six more
    evaluations at ``NORMAL_EPSILON``) from one launch (kernel
    ``point_eval_fd``, with ``gizmo`` ``point_eval_fd_gizmo``; the unit
    built without FMA contraction, so that every product and sum rounds as
    in the plain version), in the order of its plain version
    ``point_eval.fd.plain``: ``point_eval.plain`` composed with
    ops/interpreter.py ``make_normal_fn``."""
    plain = make_primary_sdf(scene, gizmo=gizmo, field="twin")
    plain_normal = make_normal_fn(plain)
    name = kernel_name("point_eval", gizmo)
    fd_name = kernel_name("point_eval_fd", gizmo)
    libs = {}

    def checked(points: torch.Tensor, fd: bool = False):
        device = points.device
        require_cuda_f32("points", points, device)
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(f"points must be [N, 3], got {tuple(points.shape)}")
        if (fd, device) not in libs:
            libs[fd, device] = _library(scene, gizmo, device, fd)
        return device, libs[fd, device]

    def point_eval(points: torch.Tensor, arrays: SceneArrays) -> torch.Tensor:
        if not on_cuda(points):
            return plain(points, arrays)
        device, lib = checked(points)
        n = points.shape[0]
        out = torch.empty((n,), dtype=torch.float32, device=device)
        if n == 0:
            return out
        args, _bank = scene_args(scene, arrays, device, lib)
        rc = lib.launch_point_eval(ptr(points), ptr(out), n, *args)
        check_launch(name, rc)
        return out

    def fd_plain(points: torch.Tensor, arrays: SceneArrays):
        return plain(points, arrays), plain_normal(points, arrays)

    def fd(points: torch.Tensor, arrays: SceneArrays):
        if not on_cuda(points):
            return fd_plain(points, arrays)
        device, lib = checked(points, fd=True)
        n = points.shape[0]
        out = torch.empty((n,), dtype=torch.float32, device=device)
        normal = torch.empty((n, 3), dtype=torch.float32, device=device)
        if n == 0:
            return out, normal
        args, _bank = scene_args(scene, arrays, device, lib)
        rc = lib.launch_point_eval_fd(ptr(points), ptr(out), ptr(normal), n, *args)
        check_launch(fd_name, rc)
        return out, normal

    point_eval.plain = plain
    point_eval.kernel = name
    fd.plain = fd_plain
    fd.kernel = fd_name
    point_eval.fd = fd
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


#: The culled grid kernel's tile, (z, y, x) lattice points (csrc/interval.cuh).
CULL_TILE = (8, 8, 32)


def _axis_tiles(coords: torch.Tensor, size: int):
    """Per tile of ``size`` consecutive lattice coordinates: (min, max)."""
    n = coords.shape[0]
    pad = (-n) % size
    lo = torch.cat([coords, coords[-1:].expand(pad)]).reshape(-1, size)
    return lo.amin(1), lo.amax(1)


def make_grid_eval(scene: CompiledScene, gizmo: bool = False, cull: Optional[bool] = None):
    """``grid_eval(arrays, lo, cell, z0, slab, ny, nx=None) -> f32[slab, ny, nx]``,
    the SDF (twin field; with ``gizmo`` min-ed with the axis gizmo) at the
    lattice ``lo + cell * (x, y, z0 + z)`` — z-major, no coordinate input.
    The device is that of ``arrays``.  ``grid_eval.plain`` is its plain
    version.

    With ``cull=True`` and a tape that can be culled (ops/cull.py), the grid
    is cut into tiles of 8 z by 8 y by 32 x points, each tile's cull is
    computed once on its box, and the tape skips the groups that cannot
    change any value in it (kernel ``grid_eval_cull``; the plain version does
    the same at the same tiles, and ``counts=`` a dict accumulates its
    ``evals``, ``group_evals``, ``chains`` and ``column_group_evals`` (per
    group, the lattice columns whose tiles keep it at some z); with
    ``gizmo`` the gizmo has
    a cull slot of its own, cull.py:347 of the JAX package).  The values
    equal the unculled grid's."""
    sdf = make_primary_sdf(scene, gizmo=gizmo, field="twin")
    culler = make_tape_culler(scene, gizmo=gizmo) if cull else None
    name = kernel_name("grid_eval" if culler is None else "grid_eval_cull", gizmo)
    culled_sdf = None if culler is None else make_culled_sdf(scene, culler, field="twin")
    libs = {}

    def plain(arrays, lo, cell, z0, slab: int, ny: int, nx: Optional[int] = None, counts=None):
        nx = ny if nx is None else nx
        pts = lattice_points(lo, cell, z0, slab, ny, nx, arrays.ad.device)
        if culler is None:
            return sdf(pts, arrays)
        spans = [_axis_tiles(pts[:, 0, 0, 2], CULL_TILE[0]), _axis_tiles(pts[0, :, 0, 1], CULL_TILE[1]),
                 _axis_tiles(pts[0, 0, :, 0], CULL_TILE[2])]
        shape = tuple(span[0].shape[0] for span in spans)  # tiles along z, y, x
        box = tuple(
            (span[0].reshape(view).expand(shape), span[1].reshape(view).expand(shape))
            for span, view in ((spans[2], (1, 1, -1)), (spans[1], (1, -1, 1)), (spans[0], (-1, 1, 1)))
        )
        preds, substs = stack_cull(*culler(box, array_bank_reader(arrays), eval_context(scene, arrays)),
                                   shape)
        device = arrays.ad.device
        tz, ty, tx = (torch.arange(n, device=device) // t for n, t in zip((slab, ny, nx), CULL_TILE))
        tile = ((tz[:, None, None] * shape[1] + ty[None, :, None]) * shape[2] + tx[None, None, :])
        tile = tile.reshape(-1)
        if counts is not None:
            counts["chains"] = counts.get("chains", 0) + preds[..., 0].numel()
            # Per group, the lattice columns in whose tiles it is kept at
            # some z: where the column form needs its frame terms.
            width = [(torch.arange(m, device=preds.device) * t).clamp(max=n) for m, t, n in
                     ((shape[1] + 1, CULL_TILE[1], ny), (shape[2] + 1, CULL_TILE[2], nx))]
            columns = (width[0].diff()[:, None] * width[1].diff()[None, :])[..., None]
            cols = (preds.any(0) * columns).sum((0, 1)).tolist()
            prior = counts.get("column_group_evals", [0] * len(cols))
            counts["column_group_evals"] = [p + c for p, c in zip(prior, cols)]
        preds, substs = preds.reshape(-1, preds.shape[-1]), substs.reshape(-1, substs.shape[-1])
        out = culled_sdf(pts.reshape(-1, 3), arrays, preds[tile], substs[tile], counts)
        return out.reshape(slab, ny, nx)

    def grid_eval(arrays, lo, cell, z0, slab: int, ny: int, nx: Optional[int] = None):
        if not on_cuda(arrays.ad):
            return plain(arrays, lo, cell, z0, slab, ny, nx)
        nx = ny if nx is None else nx
        device = arrays.ad.device
        if device not in libs:
            libs[device] = _library(scene, gizmo, device, cull=culler is not None)
        lib = libs[device]
        out = torch.empty((slab, ny, nx), dtype=torch.float32, device=device)
        if out.numel() == 0:
            return out
        lox, loy, loz = (float(v) for v in np.asarray(lo, np.float32).reshape(3))
        launch = lib.launch_grid_eval if culler is None else lib.launch_grid_eval_cull
        args, _bank = scene_args(scene, arrays, device, lib)
        rc = launch(ptr(out), slab, ny, nx, lox, loy, loz, float(np.float32(cell)),
                    float(np.float32(z0)), *args)
        check_launch(name, rc)
        return out

    grid_eval.plain = plain
    grid_eval.culler = culler
    grid_eval.kernel = name
    return grid_eval
