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
       (BatchEvaluator.eval_surface_cells), which keeps the surface cells
       there;
    2. classify the cells, on the device but for the normals' angles:
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
    3. emit simple surface cells at this level, on the device, and bring
       only their triangles to the host; refine complex/ambiguous/near
       cells into their 8 children for the next wave, on the device; at
       max_level emit every surface cell.

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


# The cube's tables on each device the sweep has run on, uploaded once.
_TABLES: dict = {}


def _tables(device: torch.device) -> dict:
    """The cube's tables on ``device``: the corners (int32, the children's
    offsets), each edge's two corners, lower corner, unit step and axis,
    and the triangle table."""
    key = str(device)
    if key not in _TABLES:
        tri_edges, n_tris = triangle_table()
        _TABLES[key] = {name: to_device(table, device) for name, table in (
            ("corners", CORNERS.astype(np.int32)), ("edge_lo", EDGES[:, 0]),
            ("edge_hi", EDGES[:, 1]), ("edge_origin", EDGE_ORIGIN),
            ("edge_step", CORNERS[EDGES[:, 1]] - CORNERS[EDGES[:, 0]]),
            ("edge_axis", EDGE_AXIS), ("tri_edges", tri_edges), ("n_tris", n_tris))}
    return _TABLES[key]


def _edge_bits(tables: dict, signs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """i64[M, 12] twice: 1 where each edge's lower or upper corner lies
    inside (SDF < 0), from the sign bytes (bit k: corner k)."""
    signs = signs[:, None]
    return (signs >> tables["edge_lo"]) & 1, (signs >> tables["edge_hi"]) & 1


def _canonical_offsets(
    evaluator: BatchEvaluator,
    tables: dict,
    cells: torch.Tensor,  # i32[M, 3] emitted cells at level L
    signs: torch.Tensor,  # u8[M] their corners' signs, bit k set iff corner k < 0
    scale: int,  # 2**(max_level - L): fine sub-edges per cell edge
    lo: np.ndarray,
    fine_cell: float,  # world size of one max_level cell
) -> torch.Tensor:
    """f32[M, 12] — for each cut cube edge, the vertex offset along the edge
    in *fine* (max_level) lattice units: the midpoint of the fine sub-edge
    containing the first sign crossing.  Uncut edges hold the plain midpoint
    (never read).  All levels compute this on the same integer fine lattice,
    so coincident edges yield bit-identical vertices regardless of level."""
    M = cells.shape[0]
    device = cells.device
    offs = torch.full((M, 12), 0.5 * scale, dtype=torch.float32, device=device)
    if M == 0 or scale == 1:
        return offs
    bit_lo, bit_hi = _edge_bits(tables, signs)
    ci, ei = torch.nonzero(bit_lo != bit_hi, as_tuple=True)  # the cut edges
    if ci.shape[0] == 0:
        return offs
    # Unique geometric edges (several cells share each): fine-lattice key.
    orig_fine = (cells[ci].long() + tables["edge_origin"][ei]) * scale  # [K, 3]
    nf = 1 << 20  # coordinate stride; far above any resolution in use
    # (axis*nf^3 tops out near 2^61 — still inside int64)
    key = (
        (tables["edge_axis"][ei] * nf + orig_fine[:, 2]) * nf + orig_fine[:, 1]
    ) * nf + orig_fine[:, 0]
    ukeys, inv = torch.unique(key, sorted=True, return_inverse=True)
    uaxis = ukeys // (nf * nf * nf)
    rem = ukeys % (nf * nf * nf)
    uorig = torch.stack([rem % nf, (rem // nf) % nf, rem // (nf * nf)], dim=-1)

    # Sample the whole edge on the fine lattice: endpoints + interior points,
    # all from integer fine coordinates (bit-identical across levels).
    steps = torch.arange(scale + 1, device=device)
    unit = torch.eye(3, dtype=torch.int64, device=device)[uaxis]  # [U, 3]
    pts_fine = uorig[:, None, :] + steps[None, :, None] * unit[:, None, :]
    v = evaluator.eval_sdf_at_lattice_on_device(
        pts_fine.reshape(-1, 3).to(torch.int32), lo, fine_cell
    ).reshape(-1, scale + 1)
    s = v < 0.0
    trans = s[:, 1:] != s[:, :-1]  # [U, scale]
    # The first transition's index; the midpoint where there is none.
    first = torch.where(trans, steps[:-1], scale).amin(dim=1)
    first = torch.where(first == scale, scale // 2, first)
    offs[ci, ei] = first[inv].to(torch.float32) + 0.5
    return offs


def _emit_cells(
    tables: dict,
    cells: torch.Tensor,  # i32[M, 3] (x, y, z) cell coords at this level
    signs: torch.Tensor,  # u8[M] corner signs, the table case (CORNERS order)
    offs: torch.Tensor,  # f32[M, 12] canonical vertex offsets (fine units)
    scale: int,  # 2**(max_level - L)
    fine_res: int,  # 2**max_level
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lookup-table triangles for a *list* of cells, with canonical vertex
    positions on the fine lattice.  Returns (vertex_keys i64[T, 3],
    fine_grid_pos f32[T, 3, 3]) — keys encode the doubled fine-lattice
    position (offsets are k+0.5, so doubling makes them integers), making
    welding exact across cells *and* levels."""
    device = cells.device
    cfg = signs.long()
    counts = tables["n_tris"][cfg]
    total = int(counts.sum())
    if total == 0:
        return (torch.zeros((0, 3), dtype=torch.int64, device=device),
                torch.zeros((0, 3, 3), dtype=torch.float32, device=device))
    tri_cell = torch.repeat_interleave(
        torch.arange(cells.shape[0], device=device), counts, output_size=total)
    # Each triangle's slot in its cell's table row: its place after the
    # cell's first triangle.
    first_tri = torch.cumsum(counts, 0) - counts
    slot = torch.arange(total, device=device) - first_tri[tri_cell]
    edges = tables["tri_edges"][cfg[tri_cell], slot]  # i64[T, 3]
    orig = tables["edge_origin"][edges]  # [T, 3, 3] lower-corner offsets (x, y, z)
    base = (cells[tri_cell].long()[:, None, :] + orig) * scale  # fine units
    off = offs[tri_cell[:, None], edges]  # [T, 3]
    pos = base.to(torch.float32) + off[..., None] * tables["edge_step"][edges].to(torch.float32)
    pos2 = torch.round(pos * 2.0).long()
    n2 = 2 * (fine_res + 1) + 2
    keys = (pos2[..., 2] * n2 + pos2[..., 1]) * n2 + pos2[..., 0]
    return keys, pos


# The complexity test's verdicts are numpy's: numpy's float32 arccos falls
# monotonically with the dot product, so a cut in the float32 order decides
# them, and a table of numpy's own verdicts for this many values either side
# of the cut absorbs any wobble of its rounding there.
_CUT_WINDOW = 1024
# The complexity cuts on each device, per threshold.
_CUTS: dict = {}


def _numpy_complex(dots: np.ndarray, threshold: float) -> np.ndarray:
    """bool: an edge whose unit corner normals' float32 dot product is
    ``dots`` is complex, as numpy decides it: the angle ``arccos`` of the
    clipped dot above ``threshold``, a NaN normal maximally complex
    (mesh.hpp:242-258; the reference tests every edge, cut or not)."""
    angles = np.arccos(np.clip(dots, -1.0, 1.0))
    # A NaN normal (zero-length FD gradient at a symmetry point / exact
    # surface corner) means the cell straddles something the normals cannot
    # resolve: treat as maximally complex so it refines, not as "flat".
    return np.where(np.isnan(angles), np.pi, angles) > threshold


def _order_key(bits):
    """int32 keys of float32 bit patterns, in the floats' order (-0 and +0
    alike); numpy arrays or tensors."""
    return (bits < 0) * -(bits & 0x7FFFFFFF) + (bits >= 0) * bits


def _complexity_cut(threshold: float, device: torch.device) -> Tuple[int, torch.Tensor, bool]:
    """(first key of the window, its verdicts bool[2 * _CUT_WINDOW] on
    ``device``, the NaN verdict) of :func:`_numpy_complex`: the window
    centred where numpy's verdict turns from complex to flat, found by
    bisection over the float32 order."""
    cache = (str(device), float(threshold))
    if cache not in _CUTS:
        def floats(keys):
            keys = np.asarray(keys, np.int64)
            return np.where(keys < 0, -keys | (1 << 31), keys).astype(np.uint32).view(np.float32)

        lo, hi = (int(_order_key(np.float32(x).view(np.int32))) for x in (-1.0, 1.0))
        hi += 1
        while lo < hi:  # the first key numpy finds flat
            mid = (lo + hi) // 2
            if _numpy_complex(floats([mid]), threshold)[0]:
                lo = mid + 1
            else:
                hi = mid
        first = lo - _CUT_WINDOW
        table = _numpy_complex(floats(np.arange(first, first + 2 * _CUT_WINDOW)), threshold)
        nan = bool(_numpy_complex(np.array([np.nan], np.float32), threshold)[0])
        _CUTS[cache] = (first, to_device(table, device), nan)
    return _CUTS[cache]


def _complex_cells(tables: dict, normals: torch.Tensor, threshold: float) -> torch.Tensor:
    """bool[M]: some cube edge's corner normals (f32[M, 8, 3]) lie further
    apart than ``threshold``, bit for bit as :func:`_numpy_complex` judges
    the dot products numpy's ``(n0 * n1).sum(-1)`` makes."""
    first, table, nan = _complexity_cut(threshold, normals.device)
    prod = normals[:, tables["edge_lo"]] * normals[:, tables["edge_hi"]]  # [M, 12, 3]
    dots = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]).clamp(-1.0, 1.0)
    at = _order_key(dots.view(torch.int32)) - first
    width = table.shape[0]
    verdict = (at < 0) | ((at < width) & table[at.clamp(0, width - 1)])
    isnan = torch.isnan(dots)
    verdict = verdict | isnan if nan else verdict & ~isnan
    return verdict.any(dim=1)


def _ambiguous_edges(
    evaluator: BatchEvaluator,
    tables: dict,
    cells: torch.Tensor,  # i32[C, 3] candidate cells
    signs: torch.Tensor,  # u8[C] their corners' signs, bit k set iff corner k < 0
    lo: np.ndarray,
    cellsize: float,
    samples_per_edge: int,
) -> torch.Tensor:
    """bool[C] — some edge's interior samples (at grid resolution) add sign
    transitions beyond what the endpoints imply (mesh.hpp:221-238's intent:
    a surface wiggle the corner signs cannot see)."""
    C = cells.shape[0]
    if C == 0 or samples_per_edge <= 0:
        return torch.zeros((C,), dtype=torch.bool, device=cells.device)
    a = cells[:, None, :].long() + tables["edge_origin"]  # [C, 12, 3] grid units (int)
    # Interior samples sit on the (samples+1)x-refined lattice: integer
    # indices there, evaluated through the lattice entry point.
    m = samples_per_edge + 1
    ks = torch.arange(1, m, device=cells.device)
    idx = a[:, :, None, :] * m + tables["edge_step"][:, None, :] * ks[:, None]
    interior = evaluator.eval_sdf_at_lattice_on_device(
        idx.reshape(-1, 3).to(torch.int32), lo, cellsize / m
    ).reshape(C, 12, samples_per_edge)
    bit_a, bit_b = _edge_bits(tables, signs)
    seq = torch.cat([bit_a[..., None], (interior < 0.0).long(), bit_b[..., None]], dim=2)
    transitions = (seq[:, :, 1:] != seq[:, :, :-1]).sum(dim=2)
    implied = (bit_a != bit_b).long()
    return (transitions > implied).any(dim=1)


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
    # (x, y, z), x fastest: only the emitted triangles come to the host.
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
                # mixed corner signs <=> straddles the surface.  The surface
                # cells' rows, coordinates and sign bytes stay there, as do
                # the near-band flags for the descent.  Classification and
                # emission consume only corner SIGNS, so no float32 corner
                # value is kept.
                rows, scells, signs, near = evaluator.eval_surface_cells(
                    cells, lo, cellsize, CORNERS,
                    np.sqrt(3.0) * cellsize * _CULL_FACTOR,
                )
                n_surface = rows.shape[0]
                steps["corners"].value = n_surface
                level_cells[L] = (int(cells.shape[0]), n_surface)
                tables = _tables(device)

            # 2. which surface cells emit at this level (all of them at
            # max_level); the others of the near band refine.
            if L < max_l:
                emit = torch.ones((n_surface,), dtype=torch.bool, device=device)
                with span("extract.normals") as steps["normals"]:
                    if n_surface:
                        # Normals (6 SDF evals each) only at corners of
                        # SURFACE cells — the complexity test reads nothing
                        # else, and surface cells are a small fraction of
                        # the near-cull wave.
                        norms = evaluator.eval_normal_at_cell_corners_on_device(
                            scells, lo, cellsize, CORNERS
                        )
                        emit = ~_complex_cells(tables, norms, threshold)  # complex cells refine
                with span("extract.ambiguity") as steps["ambiguity"]:
                    cand = torch.nonzero(emit).reshape(-1)
                    steps["ambiguity"].value = cand.shape[0]
                    if cand.shape[0]:
                        n_samples = min((1 << (grid_l - L)) - 1, _MAX_EDGE_SAMPLES)
                        emit[cand] = ~_ambiguous_edges(evaluator, tables, scells[cand],
                                                       signs[cand], lo, cellsize, n_samples)

            # 3. emission at this level, vertices canonical on the fine
            # lattice, on the device: only the triangles come down.  Then
            # the next wave's cells, made there from the near cells that do
            # not emit.
            with span("extract.emit") as steps["emit"]:
                lvl_keys = np.zeros((0,), np.int64)
                lvl_pos = np.zeros((0, 3), np.float32)
                ecells, esigns = scells, signs
                if L < max_l:
                    emitted = torch.nonzero(emit).reshape(-1)
                    ecells, esigns = scells[emitted], signs[emitted]
                n_tris = 0
                if ecells.shape[0]:
                    offs = _canonical_offsets(
                        evaluator, tables, ecells, esigns, scale, lo, fine_cell
                    )
                    keys, pos = _emit_cells(tables, ecells, esigns, offs, scale, fine_res)
                    n_tris = keys.shape[0]
                    if n_tris:
                        lvl_keys = to_host(keys.reshape(-1))
                        lvl_pos = to_host(pos.reshape(-1, 3))
                        all_keys.append(lvl_keys)
                        all_pos.append(lvl_pos)
                        level_tris[L] = n_tris
                        levels_emitted += 1
                steps["emit"].value = n_tris

                if L < max_l:
                    refine = near  # near & ~emit, in place
                    refine[rows[emitted]] = False
                    rc = cells[refine]
                    cells = (rc[:, None, :] * 2 + tables["corners"][None, :, :]).reshape(-1, 3)
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
    # match do match exactly.  Each op's span holds the faces it receives.
    with span("extract.mesh_ops"):
        with span("extract.weld", sum(k.size for k in all_keys) // 3):
            mesh = assemble_mesh(all_keys, all_pos, lo, fine_cell)
        if heal and levels_emitted > 1 and mesh.num_faces:
            # Two-stage crack healing.  (1) All vertices lie on the fine
            # half-lattice; walking triangle edges on it heals collinear
            # T-junctions — the reference's whole retopology pass.  (2) The
            # chord-vs-polyline sliver loops the reference leaves behind
            # are then closed exactly by capping the remaining boundary
            # loops.
            with span("extract.retopologize", mesh.num_faces):
                mesh = retopologize(mesh, lo, fine_cell / 2.0)
            with span("extract.stitch", mesh.num_faces):
                mesh = stitch_boundary_loops(
                    mesh,
                    domain_lo=lo,
                    domain_hi=lo + 2.0 * half_diameter,
                    eps=fine_cell * 1e-3,
                    stats=stats,
                )
    return mesh
