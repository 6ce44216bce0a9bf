"""Adaptive multi-resolution surface extraction: octree parity.

The reference's CMS extractor walks an octree, refining any node that (a) is
below ``minimumOctreeLevel``, (b) shows *edge ambiguity* (interior points
sampled at grid resolution along its 12 edges change sign more than the
corner signs imply), or (c) crosses a *complex surface* (angle between unit
normals at edge endpoints exceeds ``complexSurfaceThreshold``), capped at
``maximumOctreeLevel``; leaves emit lookup-table triangles at edge midpoints
(cms/main/Headers/mesh.hpp:214-308).  The result: flat regions keep coarse
triangles, creases get fine ones.

As in the JAX package (export/adaptive.py, which this module follows line
for line), the same refinement *criteria* run as a breadth-first level sweep
over active cell sets -- each level is one batched wave of device
evaluations instead of a pointer chase:

  level L = min_level .. max_level:
    1. the corner signs and the near-band flag of the active cells, whose
       list lives on the evaluator's device from level to level
       (BatchEvaluator.eval_surface_cells): only the surface cells come to
       the host;
    2. classify the cells:
         - *surface cell*  : corner signs straddle zero (on the device);
         - *near cell*     : min |corner| <= sqrt(3)*cell*1.1 -- the Lipschitz
           bound replacing the reference's center-sample sphere cull
           (mesh.hpp:167-170, same 1.1 fudge factor);
         - *complex cell*  : max angle between corner normals across the 12
           cube edges > complex_surface_threshold (mesh.hpp:242-258; normals
           from the evaluator, batched);
         - *ambiguous cell*: interior points at grid_level resolution along
           any edge add sign transitions beyond what the endpoints imply
           (the wiggle the corner signs cannot see, mesh.hpp:221-238);
    3. emit simple surface cells at this level; refine complex/ambiguous/
       near cells into their 8 children for the next wave, on the device;
       at max_level emit every surface cell.

Vertices are *canonical* across levels: a cut cube edge's vertex sits at the
midpoint of the *max_level* sub-edge containing the sign crossing, computed
on the max_level integer lattice, so it is the same bit for bit whichever
level emits it.  Transition cracks then decompose into small per-face sliver
loops, which are closed exactly: retopologize handles the collinear ones,
and every remaining boundary loop is capped with a minimal-area
triangulation (export/retopo.py:stitch_boundary_loops).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..compiler import ExportConfig
from ..evaluator import BatchEvaluator
from ..observability import span, to_device, to_host
from ..ops.marching_cubes import (
    CORNERS,
    EDGE_AXIS,
    EDGE_ORIGIN,
    EDGES,
    Mesh,
    assemble_mesh,
    triangle_table,
)
from .retopo import retopologize, stitch_boundary_loops

# The reference's sphere-cull fudge (mesh.hpp:165 "sqrt3scaling = 1.1f").
_CULL_FACTOR = 1.1
# Interior samples per edge for the *ambiguity test* are capped: beyond ~7
# the verdict almost never changes but the eval count grows linearly.
_MAX_EDGE_SAMPLES = 7


def _canonical_offsets(
    evaluator: BatchEvaluator,
    cells: np.ndarray,  # i64[M, 3] emitted cells at level L
    vals: np.ndarray,  # f32[M, 8] their corner values
    scale: int,  # 2**(max_level - L): fine sub-edges per cell edge
    lo: np.ndarray,
    fine_cell: float,  # world size of one max_level cell
) -> np.ndarray:
    """f32[M, 12] — for each cut cube edge, the vertex offset along the edge
    in *fine* (max_level) lattice units: the midpoint of the fine sub-edge
    containing the first sign crossing.  Uncut edges hold the plain midpoint
    (never read).  All levels compute this on the same integer fine lattice,
    so coincident edges yield bit-identical vertices regardless of level."""
    M = cells.shape[0]
    offs = np.full((M, 12), 0.5 * scale, dtype=np.float32)
    if M == 0 or scale == 1:
        if scale == 1:
            offs[:] = 0.5
        return offs
    inside = vals < 0.0
    cut = inside[:, EDGES[:, 0]] != inside[:, EDGES[:, 1]]  # [M, 12]
    if not cut.any():
        return offs
    sel = np.nonzero(cut)
    # Unique geometric edges (several cells share each): fine-lattice key.
    orig_fine = (cells[:, None, :] + EDGE_ORIGIN[None, :, :]) * scale  # [M,12,3]
    axis = np.broadcast_to(EDGE_AXIS[None, :], (M, 12))
    nf = 1 << 20  # coordinate stride; far above any resolution in use
    # (axis*nf^3 tops out near 2^61 — still inside int64)
    key = (
        (axis.astype(np.int64) * nf + orig_fine[..., 2]) * nf + orig_fine[..., 1]
    ) * nf + orig_fine[..., 0]
    keys_cut = key[sel]
    ukeys, inv = np.unique(keys_cut, return_inverse=True)
    uaxis = ukeys // (nf * nf * nf)
    rem = ukeys % (nf * nf * nf)
    uorig = np.stack([rem % nf, (rem // nf) % nf, rem // (nf * nf)], axis=-1)

    # Sample the whole edge on the fine lattice: endpoints + interior points,
    # all from integer fine coordinates (bit-identical across levels).
    steps = np.arange(scale + 1, dtype=np.int64)
    unit = np.eye(3, dtype=np.int64)[uaxis]  # [U, 3]
    pts_fine = uorig[:, None, :] + steps[None, :, None] * unit[:, None, :]
    v = evaluator.eval_sdf_at_lattice(
        pts_fine.reshape(-1, 3), lo, fine_cell
    ).reshape(-1, scale + 1)
    s = v < 0.0
    trans = s[:, 1:] != s[:, :-1]  # [U, scale]
    any_t = trans.any(axis=1)
    first = np.where(any_t, trans.argmax(axis=1), scale // 2)
    offs[sel] = (first[inv] + 0.5).astype(np.float32)
    return offs


def _emit_cells(
    cells: np.ndarray,  # i64[M, 3] (x, y, z) cell coords at this level
    vals: np.ndarray,  # f32[M, 8] corner SDF values (CORNERS order)
    offs: np.ndarray,  # f32[M, 12] canonical vertex offsets (fine units)
    scale: int,  # 2**(max_level - L)
    fine_res: int,  # 2**max_level
) -> Tuple[np.ndarray, np.ndarray]:
    """Lookup-table triangles for a *list* of cells, with canonical vertex
    positions on the fine lattice.  Returns (vertex_keys i64[T, 3],
    fine_grid_pos f32[T, 3, 3]) — keys encode the doubled fine-lattice
    position (offsets are k+0.5, so doubling makes them integers), making
    welding exact across cells *and* levels."""
    tri_edges, n_tris = triangle_table()
    inside = vals < 0.0
    cfg = (inside.astype(np.int64) << np.arange(8)[None, :]).sum(axis=1)
    counts = n_tris[cfg]
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0, 3), np.int64), np.zeros((0, 3, 3), np.float32)
    tri_cell = np.repeat(np.arange(cells.shape[0]), counts)
    slot = np.concatenate([np.arange(c) for c in counts if c])
    edges = tri_edges[cfg[tri_cell], slot]  # i64[T, 3]
    axis = EDGE_AXIS[edges]
    orig = EDGE_ORIGIN[edges]  # [T, 3, 3] lower-corner offsets (x, y, z)
    base = (cells[tri_cell][:, None, :] + orig) * scale  # fine units
    off = offs[tri_cell[:, None], edges]  # [T, 3]
    pos = base.astype(np.float32) + off[..., None] * np.eye(
        3, dtype=np.float32
    )[axis]
    pos2 = np.round(pos * 2.0).astype(np.int64)
    n2 = 2 * (fine_res + 1) + 2
    keys = (pos2[..., 2] * n2 + pos2[..., 1]) * n2 + pos2[..., 0]
    return keys, pos


def _edge_angles(normals: np.ndarray) -> np.ndarray:
    """f32[M] max angle between unit corner normals across the 12 cube edges
    (the reference tests every edge, cut or not — mesh.hpp:242-258)."""
    n0 = normals[:, EDGES[:, 0], :]
    n1 = normals[:, EDGES[:, 1], :]
    dots = np.clip((n0 * n1).sum(axis=-1), -1.0, 1.0)
    angles = np.arccos(dots)
    # A NaN normal (zero-length FD gradient at a symmetry point / exact
    # surface corner) means the cell straddles something the normals cannot
    # resolve: treat as maximally complex so it refines, not as "flat".
    return np.where(np.isnan(angles), np.pi, angles).max(axis=1)


def _ambiguous_edges(
    evaluator: BatchEvaluator,
    cells: np.ndarray,  # i64[C, 3] candidate cells
    vals: np.ndarray,  # f32[C, 8] their corner values
    lo: np.ndarray,
    cellsize: float,
    samples_per_edge: int,
) -> np.ndarray:
    """bool[C] — some edge's interior samples (at grid resolution) add sign
    transitions beyond what the endpoints imply (mesh.hpp:221-238's intent:
    a surface wiggle the corner signs cannot see)."""
    C = cells.shape[0]
    if C == 0 or samples_per_edge <= 0:
        return np.zeros((C,), bool)
    corner_pos = cells[:, None, :] + CORNERS[None, :, :]  # [C, 8, 3] int
    a = corner_pos[:, EDGES[:, 0], :]  # [C, 12, 3] grid units (int)
    b = corner_pos[:, EDGES[:, 1], :]
    # Interior samples sit on the (samples+1)x-refined lattice: integer
    # indices there, evaluated through the lattice entry point.
    m = samples_per_edge + 1
    ks = np.arange(1, samples_per_edge + 1)
    idx = a[:, :, None, :] * m + (b - a)[:, :, None, :] * ks[None, None, :, None]
    interior = evaluator.eval_sdf_at_lattice(
        idx.reshape(-1, 3), lo, cellsize / m
    ).reshape(C, 12, samples_per_edge)
    sign_a = vals[:, EDGES[:, 0], None] < 0.0
    sign_b = vals[:, EDGES[:, 1], None] < 0.0
    seq = np.concatenate([sign_a, interior < 0.0, sign_b], axis=2)
    transitions = (seq[:, :, 1:] != seq[:, :, :-1]).sum(axis=2)
    implied = (sign_a[:, :, 0] != sign_b[:, :, 0]).astype(np.int64)
    return (transitions > implied).any(axis=1)


def extract_surface_adaptive(
    evaluator: BatchEvaluator,
    center: np.ndarray,
    half_diameter: float,
    config: ExportConfig,
    progress: Optional[Callable[[str, float], None]] = None,
    stats: Optional[dict] = None,
    heal: bool = True,
    slab_store=None,
) -> Mesh:
    """Multi-resolution extraction over ``center ± half_diameter`` consuming
    ``minimum_octree_level`` / ``maximum_octree_level`` /
    ``complex_surface_threshold`` / ``grid_level`` exactly as the reference
    octree does (see module docstring).  Returns a mesh with coarse
    triangles on flat regions and crack loops closed (``heal=True``).

    ``slab_store`` (a pipeline.SlabStore) persists each completed *level* —
    its emitted triangles and the next wave's cell list — so a crashed run
    resumes at the level in flight instead of restarting (the reference's
    one-shot export loses everything, SURVEY.md §5.4)."""
    min_l = int(config.minimum_octree_level)
    max_l = int(config.maximum_octree_level)
    if not 0 <= min_l <= max_l:
        raise ValueError(f"need 0 <= min {min_l} <= max {max_l} octree level")
    grid_l = max(int(config.grid_level), max_l)
    threshold = float(config.complex_surface_threshold)
    center = np.asarray(center, dtype=np.float64)
    lo = center - half_diameter
    fine_res = 1 << max_l
    fine_cell = 2.0 * half_diameter / fine_res

    level_tris: dict = {}
    level_seconds: dict = {}
    level_cells: dict = {}
    if stats is not None:
        stats["level_triangles"] = level_tris
        stats["level_cells"] = level_cells
        stats["level_seconds"] = level_seconds

    # Each level's cell list lives on the evaluator's device as int32
    # (x, y, z), x fastest: only the surface cells come to the host.
    device = evaluator.device
    n0 = 1 << min_l
    r = torch.arange(n0, dtype=torch.int32, device=device)
    gz, gy, gx = torch.meshgrid(r, r, r, indexing="ij")
    cells = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)

    all_keys = []
    all_pos = []
    levels_emitted = 0
    n_levels = max_l - min_l + 1
    for L in range(min_l, max_l + 1):
        if cells.shape[0] == 0:
            break
        if slab_store is not None:
            shard = slab_store.load(L)
            if shard is not None:
                if shard["keys"].size:
                    all_keys.append(shard["keys"])
                    all_pos.append(shard["pos"])
                    level_tris[L] = int(shard["keys"].size // 3)
                    levels_emitted += 1
                cells = to_device(shard["next_cells"].reshape(-1, 3).astype(np.int32), device)
                if progress is not None:
                    progress("extract", (L - min_l + 1) / n_levels)
                continue
        res = 1 << L
        scale = 1 << (max_l - L)
        cellsize = 2.0 * half_diameter / res
        with span("extract.level"):
            steps = {}
            with span("extract.corners") as steps["corners"]:
                # 1. corner evaluation and classification on the device:
                # mixed corner signs <=> straddles the surface.  Only the
                # surface cells' rows, coordinates and sign bytes come
                # down; the near-band flags stay for the descent.
                # Classification and emission consume only corner SIGNS,
                # so no float32 corner value leaves the device.
                rows, scells, signs, near = evaluator.eval_surface_cells(
                    cells, lo, cellsize, CORNERS,
                    np.sqrt(3.0) * cellsize * _CULL_FACTOR,
                )
                steps["corners"].value = rows.shape[0]
                level_cells[L] = (int(cells.shape[0]), int(rows.shape[0]))
                # Synthetic +-1 corner values of the surface cells: every
                # downstream consumer (_canonical_offsets, _ambiguous_edges,
                # _emit_cells) reads only `vals < 0`, which the sign bits
                # reproduce exactly.
                inside_bits = (signs[:, None] >> np.arange(8, dtype=np.uint8)[None, :]) & 1
                vals = np.where(inside_bits.astype(bool), np.float32(-1.0), np.float32(1.0))

            # 2. which surface cells emit at this level (all of them at
            # max_level); the others of the near band refine.
            emit = np.ones(rows.shape, bool)
            if L < max_l:
                with span("extract.normals") as steps["normals"]:
                    if rows.size:
                        # Normals (6 SDF evals each) only at corners of
                        # SURFACE cells — the complexity test reads nothing
                        # else, and surface cells are a small fraction of
                        # the near-cull wave.
                        norms = evaluator.eval_normal_at_cell_corners(
                            scells, lo, cellsize, CORNERS
                        )
                        emit = ~(_edge_angles(norms) > threshold)  # complex cells refine
                with span("extract.ambiguity") as steps["ambiguity"]:
                    if emit.any():
                        n_samples = min((1 << (grid_l - L)) - 1, _MAX_EDGE_SAMPLES)
                        cand = np.nonzero(emit)[0]
                        amb = _ambiguous_edges(
                            evaluator, scells[cand], vals[cand], lo, cellsize, n_samples
                        )
                        emit[cand[amb]] = False

            # 3. emission at this level, vertices canonical on the fine
            # lattice; then the next wave's cells, made on the device from
            # the near cells that do not emit.
            with span("extract.emit") as steps["emit"]:
                lvl_keys = np.zeros((0,), np.int64)
                lvl_pos = np.zeros((0, 3), np.float32)
                if emit.any():
                    ecells, evals_ = scells[emit], vals[emit]
                    offs = _canonical_offsets(
                        evaluator, ecells, evals_, scale, lo, fine_cell
                    )
                    keys, pos = _emit_cells(ecells, evals_, offs, scale, fine_res)
                    if keys.shape[0]:
                        lvl_keys = keys.reshape(-1)
                        lvl_pos = pos.reshape(-1, 3)
                        all_keys.append(lvl_keys)
                        all_pos.append(lvl_pos)
                        level_tris[L] = int(keys.shape[0])
                        levels_emitted += 1

                if L < max_l:
                    refine = near  # near & ~emit, in place
                    refine[to_device(rows[emit], device)] = False
                    rc = cells[refine]
                    children = to_device(CORNERS.astype(np.int32), device)
                    cells = (rc[:, None, :] * 2 + children[None, :, :]).reshape(-1, 3)
                else:
                    cells = cells[:0]
                if slab_store is not None:
                    slab_store.save(L, keys=lvl_keys, pos=lvl_pos,
                                    next_cells=to_host(cells).astype(np.int64))
        level_seconds[L] = {step: timed.seconds for step, timed in steps.items()}
        if progress is not None:
            progress("extract", (L - min_l + 1) / n_levels)

    if not all_keys:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    # One weld across every level: canonical keys make coincident vertices
    # from different levels identical, so the cross-level seams that CAN
    # match do match exactly.
    with span("extract.mesh_ops"):
        mesh = assemble_mesh(all_keys, all_pos, lo, fine_cell)
        if heal and levels_emitted > 1 and mesh.num_faces:
            # Two-stage crack healing.  (1) All vertices lie on the fine
            # half-lattice; walking triangle edges on it heals collinear
            # T-junctions — the reference's whole retopology pass.  (2) The
            # chord-vs-polyline sliver loops the reference leaves behind
            # are then closed exactly by capping the remaining boundary
            # loops.
            mesh = retopologize(mesh, lo, fine_cell / 2.0)
            mesh = stitch_boundary_loops(
                mesh,
                domain_lo=lo,
                domain_hi=lo + 2.0 * half_diameter,
                eps=fine_cell * 1e-3,
                stats=stats,
            )
    return mesh
