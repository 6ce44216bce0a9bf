"""Active-block surface extraction.

The reference descends an octree so that the CPU visits only cells near the
surface (cms/main/Headers/mesh.hpp:214-308).  Here the corner grid is
evaluated on the device slab by slab, and only the blocks of cells that the
surface crosses leave it (export/active.py of the JAX package):

  1. the slab provider evaluates the corner values of a slab on the device:
     the grid kernel (K3) on the kernels' field, or the plain tape on a
     lattice made on the device on the exact tape's field;
  2. a per-block activity mask reduces on the device: a block is active iff
     some cell in it has corners on both sides of the surface (the octree's
     corner-sign descend test, mesh.hpp:176-183);
  3. the active blocks' corner sub-grids are gathered on the device (one
     indexing op) and copied to the host;
  4. the host assembles their triangles (native ``mc_blocks``, or the numpy
     fallback) and welds exactly as the dense path does.

The triangle set is the dense path's: the same cells, corner values and
table; only the enumeration order, and so the vertex numbering, differs.
With a device mesh (parallel/mesh.py) each rank evaluates its z-rows of the
slab and ``all_gather`` assembles the slab on every rank, where the mask and
the gather run (the JAX package keeps the slab sharded and lets GSPMD insert
the halo exchanges; the explicit gather is the plain equivalent).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..evaluator import BatchEvaluator
from ..ops.cuda.sdf_kernel import lattice_points
from ..ops.marching_cubes import Mesh, _block_triangles, assemble_mesh

#: The largest block (z, y, x cells) :func:`choose_block` picks.
BLOCK_CAP = (4, 8, 8)


def make_slab_provider(evaluator: BatchEvaluator, device_mesh=None) -> Callable:
    """``provider(lo f64[3], cell, z0, rows, r1) -> f32[rows, r1, r1]`` on the
    evaluator's device: corner values at ``lo + cell * (x, y, z0 + z)``,
    rounded as the grid kernel rounds them.  On the kernels' field the grid
    kernel computes them (its plain version on the CPU); on the exact tape's
    field the plain tape evaluates the same lattice, made on the device,
    ``chunk_size`` points at a time.  With ``device_mesh`` the slab's z-rows
    shard over the mesh's ranks (all axes jointly), each rank evaluating
    ``ceil(rows / n)`` of them (the last block may overhang), and every rank
    gets the whole slab (active.py:108-178 of the JAX package)."""
    # A mesh shards the rows here: the evaluator's own point shards would
    # split each rank's block again.
    point_eval = evaluator.point_eval if device_mesh is None else evaluator.local_point_eval

    def evaluate(lo, cell, z0, rows: int, r1: int) -> torch.Tensor:
        lo32, cell32, arrays = np.asarray(lo, np.float32), np.float32(cell), evaluator.device_arrays
        if evaluator.use_kernels:
            return evaluator.grid_eval(arrays, lo32, cell32, np.float32(z0), rows, r1)
        pts = lattice_points(lo32, cell32, np.float32(z0), rows, r1, r1, evaluator.device)
        pts, step = pts.reshape(-1, 3), evaluator.chunk_size
        vals = torch.cat([point_eval(pts[s : s + step], arrays)
                          for s in range(0, pts.shape[0], step)])
        return vals.reshape(rows, r1, r1)

    if device_mesh is None:
        return evaluate
    from ..parallel.mesh import gather_rows, mesh_rank

    k, n = mesh_rank(device_mesh)

    def provider(lo, cell, z0, rows: int, r1: int) -> torch.Tensor:
        per = -(-rows // n)
        return gather_rows(evaluate(lo, cell, z0 + k * per, per, r1), device_mesh)[:rows]

    return provider


def _cell_min_max(vals: torch.Tensor):
    """Per cell of a corner grid f32[sz+1, ny+1, nx+1]: the min and max of
    its 8 corner values."""
    sz, ny, nx = (n - 1 for n in vals.shape)
    corners = [vals[dz : dz + sz, dy : dy + ny, dx : dx + nx]
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    m, big = corners[0], corners[0]
    for c in corners[1:]:
        m, big = torch.minimum(m, c), torch.maximum(big, c)
    return m, big


def block_mask(vals: torch.Tensor, bz: int, by: int, bx: int) -> torch.Tensor:
    """bool[sz/bz, ny/by, nx/bx]: the block holds a cell whose corners
    straddle the surface (min < 0 <= max), on the device of ``vals``."""
    m, big = _cell_min_max(vals)
    sz, ny, nx = m.shape
    active = (m < 0.0) & (big >= 0.0)
    return active.reshape(sz // bz, bz, ny // by, by, nx // bx, bx).any(5).any(3).any(1)


def gather_blocks(vals: torch.Tensor, origins: torch.Tensor, bz: int, by: int, bx: int) -> torch.Tensor:
    """f32[K, bz+1, by+1, bx+1]: the corner sub-grids of the blocks whose
    local (z, y, x) cell origins are ``origins`` i64[K, 3], in one gather."""
    dev = vals.device
    z = origins[:, 0, None, None, None] + torch.arange(bz + 1, device=dev)[None, :, None, None]
    y = origins[:, 1, None, None, None] + torch.arange(by + 1, device=dev)[None, None, :, None]
    x = origins[:, 2, None, None, None] + torch.arange(bx + 1, device=dev)[None, None, None, :]
    return vals[z, y, x]


def choose_block(resolution: int, slab_cells: int) -> Tuple[int, int, int]:
    """The largest power-of-two (bz, by, bx) <= ``BLOCK_CAP`` dividing (slab,
    res, res).  Any block gives the same triangle set.  The JAX package caps at
    (4, 16, 16) to save bytes on its TPU host link (~50 MB/s).  The card's
    PCIe link moves a 513^3 grid's active blocks in milliseconds, so here
    the host's marching cubes over the copied cells is what a block costs,
    and a smaller block hugs the surface more tightly: fewer cells are
    copied and marched, for a halo (one more corner row per axis) of 58%
    more corners than cells against 41%."""

    def largest_divisor(n: int, cap: int) -> int:
        d = 1
        while d * 2 <= cap and n % (d * 2) == 0:
            d *= 2
        return d

    return (largest_divisor(slab_cells, BLOCK_CAP[0]), largest_divisor(resolution, BLOCK_CAP[1]),
            largest_divisor(resolution, BLOCK_CAP[2]))


def host_blocks(blocks: np.ndarray, coords_xyz: np.ndarray, resolution: int, midpoint: bool,
                use_native: Optional[bool] = None):
    """Triangles of gathered corner blocks f32[K, bz+1, by+1, bx+1] at the
    global (x, y, z) cell origins ``coords_xyz``: (keys i64[T, 3], pos
    f32[T, 3, 3])."""
    from .. import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        return native.mc_blocks(blocks, coords_xyz, resolution, midpoint)
    keys, pos = [], []
    for b in range(blocks.shape[0]):
        k, p = _block_triangles(blocks[b], tuple(coords_xyz[b]), resolution, midpoint)
        if k.shape[0]:
            keys.append(k)
            pos.append(p)
    if not keys:
        return np.zeros((0, 3), np.int64), np.zeros((0, 3, 3), np.float32)
    return np.concatenate(keys), np.concatenate(pos)


def extract_surface_active(
    evaluator: BatchEvaluator,
    center: np.ndarray,
    half_diameter: float,
    resolution: int,
    midpoint: bool = False,
    slab_cells: int = 32,
    block: Optional[Tuple[int, int, int]] = None,
    progress: Optional[Callable[[str, float], None]] = None,
    use_native: Optional[bool] = None,
    slab_store=None,
    stats: Optional[dict] = None,
    device_mesh=None,
) -> Mesh:
    """March ``resolution^3`` cells over ``center ± half_diameter``, copying
    only surface-active blocks to the host.  Produces the triangle set of
    :func:`..ops.marching_cubes.extract_surface` on the same field.  Needs
    ``slab_cells | resolution``.

    ``slab_store`` / ``stats``: per-slab resume shards and per-slab triangle
    counts (``stats["slab_triangles"]``), as in ``extract_surface``.
    ``device_mesh`` shards each slab's z-rows over its ranks
    (:func:`make_slab_provider`); every rank assembles the whole mesh."""
    res = int(resolution)
    slab = min(int(slab_cells), res)
    if res % slab != 0:
        raise ValueError(f"slab_cells={slab} must divide resolution={res}")
    bz, by, bx = block if block is not None else choose_block(res, slab)
    if slab % bz or res % by or res % bx:
        raise ValueError(f"block {(bz, by, bx)} must divide {(slab, res, res)}")
    center = np.asarray(center, dtype=np.float64)
    cell = 2.0 * half_diameter / res
    lo = center - half_diameter
    r1 = res + 1
    provider = make_slab_provider(evaluator, device_mesh)
    step = torch.tensor([bz, by, bx], device=evaluator.device)
    all_keys, all_pos = [], []
    for z0 in range(0, res, slab):
        cached = slab_store.load(z0) if slab_store is not None else None
        if cached is not None:
            keys, pos = cached["keys"].reshape(-1, 3), cached["pos"].reshape(-1, 3, 3)
        else:
            vals = provider(lo, cell, z0, slab + 1, r1)
            origins = torch.nonzero(block_mask(vals, bz, by, bx)) * step
            blocks = gather_blocks(vals, origins, bz, by, bx).cpu().numpy()
            origins = origins.cpu().numpy()
            coords = np.stack([origins[:, 2], origins[:, 1], origins[:, 0] + z0], -1)
            keys, pos = host_blocks(blocks, coords, res, midpoint, use_native)
            if slab_store is not None:
                slab_store.save(z0, keys=keys, pos=pos)
        if keys.shape[0]:
            all_keys.append(keys.reshape(-1))
            all_pos.append(pos.reshape(-1, 3))
        if stats is not None:
            stats.setdefault("slab_triangles", {})[z0] = int(keys.shape[0])
        if progress is not None:
            progress("extract", (z0 + slab) / res)
    return assemble_mesh(all_keys, all_pos, lo, cell, use_native=use_native)
