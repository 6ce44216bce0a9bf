"""Dense-grid marching-cubes surface extraction.

Replaces the reference's CPU octree/work-queue CMS extractor
(reference: cms/main/Headers/mesh.hpp) with a
dense pipeline: the SDF is evaluated on the full 2^gridLevel
corner grid in device-sized slabs (the octree bottoms out at that grid anyway
— its edge-ambiguity tests sample at grid resolution, mesh.hpp:222), cells are
classified by corner-sign byte, and triangles come from a 256-case lookup
table.  Crack healing (the reference's retopology pass, mesh.hpp:432-529) is
unnecessary on a uniform grid; vertices are welded exactly by global-edge key,
which yields an indexed, watertight mesh directly.

The 256-case table is *generated*, not copied: for each corner-sign
configuration, marching-squares segments are computed per cube face (with the
ambiguous diagonal case resolved by isolating inside corners — a rule that
depends only on shared face signs, hence consistent across neighboring cells,
exactly the property the reference's CMS lookupTable.txt encodes), segments
are chained into closed cycles through the two faces sharing each cube edge,
cycles are oriented outward, and fan-triangulated (the reference strip-
triangulates its cycles, mesh.hpp:185-209 + readLookupTable.hpp).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# Corner c = x + 2y + 4z.
CORNERS = np.array(
    [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], dtype=np.int64
)
# reorder: index c -> coords (x,y,z) with c = x + 2y + 4z
CORNERS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int64)

# 12 edges as (corner_lo, corner_hi) pairs: x-edges, y-edges, z-edges.
EDGES = np.array(
    [
        (0, 1), (2, 3), (4, 5), (6, 7),  # axis 0
        (0, 2), (1, 3), (4, 6), (5, 7),  # axis 1
        (0, 4), (1, 5), (2, 6), (3, 7),  # axis 2
    ],
    dtype=np.int64,
)
EDGE_AXIS = np.array([0] * 4 + [1] * 4 + [2] * 4, dtype=np.int64)
EDGE_ORIGIN = CORNERS[EDGES[:, 0]]  # lower-corner offset of each edge

# 6 faces: (axis, side).  Face corners in cyclic order.
_FACES: List[List[int]] = []
for axis in range(3):
    for side in (0, 1):
        corners = [c for c in range(8) if CORNERS[c][axis] == side]
        # order cyclically: (0,0), (1,0), (1,1), (0,1) in the face's 2D coords
        u_axis, v_axis = [a for a in range(3) if a != axis]
        order = [(0, 0), (1, 0), (1, 1), (0, 1)]
        cyc = []
        for (u, v) in order:
            for c in corners:
                if CORNERS[c][u_axis] == u and CORNERS[c][v_axis] == v:
                    cyc.append(c)
        _FACES.append(cyc)

_EDGE_INDEX = {tuple(sorted(e)): i for i, e in enumerate(map(tuple, EDGES))}


def _face_segments(face: Sequence[int], inside: Sequence[bool]) -> List[Tuple[int, int]]:
    """Marching-squares segments on one face, as pairs of global edge ids.

    Ambiguous (diagonal) case isolates the *inside* corners — consistent
    across the two cells sharing the face because it depends only on the
    face's corner signs."""
    n = 4
    face_edges = [
        _EDGE_INDEX[tuple(sorted((face[i], face[(i + 1) % n])))] for i in range(n)
    ]
    cut = [inside[face[i]] != inside[face[(i + 1) % n]] for i in range(n)]
    ins = [inside[c] for c in face]
    count = sum(ins)
    segments = []
    if count in (1, 3):
        target = True if count == 1 else False
        k = ins.index(target)
        # the odd corner's two adjacent face edges: (k-1, k)
        segments.append((face_edges[(k - 1) % n], face_edges[k]))
    elif count == 2:
        if ins[0] == ins[2]:  # diagonal: two segments, one per inside corner
            for k in range(n):
                if ins[k]:
                    segments.append((face_edges[(k - 1) % n], face_edges[k]))
        else:  # adjacent pair: single segment between the two cut edges
            cut_ids = [face_edges[i] for i in range(n) if cut[i]]
            segments.append((cut_ids[0], cut_ids[1]))
    return segments


def _cycles_for_config(config: int) -> List[List[int]]:
    """Closed cycles of edge indices for one corner-sign byte."""
    inside = [(config >> c) & 1 == 1 for c in range(8)]
    adjacency: dict = {}
    for face in _FACES:
        for a, b in _face_segments(face, inside):
            adjacency.setdefault(a, []).append(b)
            adjacency.setdefault(b, []).append(a)
    for e, nbrs in adjacency.items():
        assert len(nbrs) == 2, (config, e, nbrs)
    cycles = []
    visited = set()
    for start in sorted(adjacency):
        if start in visited:
            continue
        cycle = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [x for x in adjacency[cur] if x != prev]
            # two equal neighbors (2-cycles can't happen; degenerate guard)
            nxt = nxt[0] if nxt else adjacency[cur][0]
            if nxt == start:
                break
            cycle.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        cycles.append(cycle)
    return cycles


def _orient_cycle(cycle: List[int], inside: Sequence[bool]) -> List[int]:
    """Orient so the fan triangles' right-hand normals point outward (toward
    positive SDF).  Uses Newell's normal of the midpoint polygon vs the mean
    inside->outside direction of the cycle's cube edges."""
    mids = []
    outward = np.zeros(3)
    for e in cycle:
        c0, c1 = EDGES[e]
        p0, p1 = CORNERS[c0].astype(float), CORNERS[c1].astype(float)
        mids.append((p0 + p1) / 2.0)
        if inside[c0]:
            outward += p1 - p0
        else:
            outward += p0 - p1
    normal = np.zeros(3)
    for i in range(len(mids)):
        a, b = mids[i], mids[(i + 1) % len(mids)]
        normal += np.cross(a, b)
    if np.dot(normal, outward) < 0:
        return cycle[::-1]
    return cycle


_TABLE_CACHE: Optional[Tuple[np.ndarray, np.ndarray]] = None


def triangle_table() -> Tuple[np.ndarray, np.ndarray]:
    """(tri_edges i64[256, MAXT, 3], n_tris i64[256]) — fan triangulations of
    the oriented cycles for every corner-sign configuration."""
    global _TABLE_CACHE
    if _TABLE_CACHE is not None:
        return _TABLE_CACHE
    all_tris: List[List[Tuple[int, int, int]]] = []
    for config in range(256):
        inside = [(config >> c) & 1 == 1 for c in range(8)]
        tris = []
        for cycle in _cycles_for_config(config):
            cycle = _orient_cycle(cycle, inside)
            for i in range(1, len(cycle) - 1):
                tris.append((cycle[0], cycle[i], cycle[i + 1]))
        all_tris.append(tris)
    maxt = max(len(t) for t in all_tris)
    tri_edges = np.full((256, maxt, 3), -1, dtype=np.int64)
    n_tris = np.zeros((256,), dtype=np.int64)
    for config, tris in enumerate(all_tris):
        n_tris[config] = len(tris)
        for i, t in enumerate(tris):
            tri_edges[config, i] = t
    _TABLE_CACHE = (tri_edges, n_tris)
    return _TABLE_CACHE


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh in world coordinates."""

    vertices: np.ndarray  # f32[V, 3]
    faces: np.ndarray  # i64[F, 3]

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def triangle_soup(self) -> np.ndarray:
        """f32[F, 3, 3] — the reference's Triangle3f representation."""
        return self.vertices[self.faces]

    def signed_volume(self) -> float:
        """Divergence-theorem volume; positive for outward orientation."""
        tri = self.vertices[self.faces].astype(np.float64)
        return float(
            np.sum(np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])))
            / 6.0
        )

    def surface_area(self) -> float:
        tri = self.vertices[self.faces].astype(np.float64)
        cr = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        return float(np.sum(np.linalg.norm(cr, axis=-1)) / 2.0)


def _slab_triangles(
    corner_values: np.ndarray,  # f32[sz+1, ny+1, nx+1] sdf at corners
    z0: int,
    resolution: int,
    midpoint: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (edge_keys i64[K,3], t_params f32[K,3]->positions) for one
    z-slab of cells, vectorized in numpy.  Returns (keys, verts01) where keys
    are global edge ids (weldable) and verts01 are positions in grid units."""
    return _block_triangles(corner_values, (0, 0, z0), resolution, midpoint)


def _block_triangles(
    corner_values: np.ndarray,  # f32[nz+1, ny+1, nx+1] sdf at corners
    origin: Tuple[int, int, int],  # global (x0, y0, z0) cell origin
    resolution: int,
    midpoint: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Like :func:`_slab_triangles` but for a block at an arbitrary global
    cell origin — the host half of the active-block extraction path.  Keys
    are global edge ids against the full ``resolution + 1`` corner grid, so
    blocks weld seamlessly."""
    tri_edges, n_tris = triangle_table()
    x0, y0, z0 = (int(v) for v in origin)
    sz = corner_values.shape[0] - 1
    ny = corner_values.shape[1] - 1
    nx = corner_values.shape[2] - 1

    inside = corner_values < 0.0
    # config byte per cell: bit c set if corner c inside; corner c offset
    config = np.zeros((sz, ny, nx), dtype=np.uint8)
    for c in range(8):
        ox, oy, oz = CORNERS[c]
        config |= (
            inside[oz : oz + sz, oy : oy + ny, ox : ox + nx].astype(np.uint8) << c
        )

    occupied = np.nonzero((config != 0) & (config != 255))
    if occupied[0].size == 0:
        return (
            np.zeros((0, 3), dtype=np.int64),
            np.zeros((0, 3, 3), dtype=np.float32),
        )
    cz, cy, cx = (o.astype(np.int64) for o in occupied)
    ccfg = config[occupied]

    counts = n_tris[ccfg]  # tris per occupied cell
    tri_cell = np.repeat(np.arange(cz.size), counts)
    # per-cell triangle slot indices
    slot = np.concatenate([np.arange(c) for c in counts]) if counts.size else np.zeros(0, np.int64)
    edges = tri_edges[ccfg[tri_cell], slot]  # i64[T, 3] edge ids

    # Edge -> global grid key and position.
    cellx = (cx[tri_cell] + x0)[:, None]
    celly = (cy[tri_cell] + y0)[:, None]
    cellz = (cz[tri_cell] + z0)[:, None]
    axis = EDGE_AXIS[edges]
    orig = EDGE_ORIGIN[edges]  # [T, 3, 3] (x, y, z offsets)
    gx = cellx + orig[..., 0]
    gy = celly + orig[..., 1]
    gz = cellz + orig[..., 2]
    r1 = resolution + 1
    keys = ((axis * r1 + gz) * r1 + gy) * r1 + gx  # i64[T, 3]

    # Vertex positions in grid units (corner grid coordinates).
    if midpoint:
        t = np.full(edges.shape, 0.5, dtype=np.float32)
    else:
        c0 = EDGES[edges][..., 0]
        ox0, oy0, oz0 = CORNERS[c0][..., 0], CORNERS[c0][..., 1], CORNERS[c0][..., 2]
        lx = cx[tri_cell][:, None] + ox0
        ly = cy[tri_cell][:, None] + oy0
        lz = cz[tri_cell][:, None] + oz0
        v0 = corner_values[lz, ly, lx]
        c1 = EDGES[edges][..., 1]
        ox1, oy1, oz1 = CORNERS[c1][..., 0], CORNERS[c1][..., 1], CORNERS[c1][..., 2]
        v1 = corner_values[
            cz[tri_cell][:, None] + oz1,
            cy[tri_cell][:, None] + oy1,
            cx[tri_cell][:, None] + ox1,
        ]
        denom = v0 - v1
        t = np.where(np.abs(denom) > 1e-12, v0 / np.where(denom == 0, 1, denom), 0.5)
        t = np.clip(t, 0.0, 1.0).astype(np.float32)

    base = np.stack([gx, gy, gz], axis=-1).astype(np.float32)
    step = np.eye(3, dtype=np.float32)[axis]  # unit vector along edge axis
    pos = base + t[..., None] * step  # [T, 3, 3] grid-unit positions
    return keys, pos


def extract_surface(
    sdf_eval: Callable[[np.ndarray], np.ndarray],
    center: np.ndarray,
    half_diameter: float,
    resolution: int,
    midpoint: bool = False,
    slab_cells: int = 32,
    progress: Optional[Callable[[str, float], None]] = None,
    corner_provider: Optional[Callable[[int, int], np.ndarray]] = None,
    slab_store=None,
    stats: Optional[dict] = None,
    use_native: Optional[bool] = None,
) -> Mesh:
    """March a ``resolution^3`` cell grid over the box ``center ± half_diameter``.

    ``sdf_eval`` maps f32[N, 3] world points -> f32[N] distances.  Slabs of ``slab_cells`` z-layers are
    evaluated at a time; corner planes shared between slabs are re-evaluated
    (cheap) so slabs are independent — which also makes the loop trivially
    resumable and distributable.

    ``corner_provider(z0, sz) -> f32[sz+1, res+1, res+1]`` overrides the
    point-based evaluation — the CUDA grid kernel synthesizes coordinates
    on the device, so no host point buffers exist at all on that path.

    ``slab_store`` (export/pipeline.py:SlabStore duck type) persists each
    slab's (keys, pos) as it completes and short-circuits evaluation for
    slabs already on disk — crash-resumable extraction at slab granularity
    (the reference loses the whole export on a crash, SURVEY.md §5.4).

    ``stats`` (mutated in place) gains ``slab_triangles[z0] = count`` — the
    per-slab analog of the reference's per-octree-level triangle histogram
    (DesignCSG.cpp:896-924).

    ``use_native`` (default: whether the native library is available)
    takes native/meshops.cpp's ``mc_slab`` and ``weld``; the triangle set is
    the numpy path's, the vertex numbering the native weld's (first
    appearance, not sorted keys).
    """
    from .. import native

    if use_native is None:
        use_native = native.available()
    center = np.asarray(center, dtype=np.float64)
    res = int(resolution)
    r1 = res + 1
    cell = 2.0 * half_diameter / res
    lo = center - half_diameter

    axis_coords = lo[None, :] + cell * np.arange(r1, dtype=np.float64)[:, None]
    xs = axis_coords[:, 0]
    ys = axis_coords[:, 1]
    zs = axis_coords[:, 2]

    all_keys = []
    all_pos = []
    z0 = 0
    while z0 < res:
        sz = min(slab_cells, res - z0)
        cached = slab_store.load(z0) if slab_store is not None else None
        if cached is not None:
            keys, pos = cached["keys"], cached["pos"]
        else:
            if corner_provider is not None:
                vals = np.asarray(corner_provider(z0, sz))
            else:
                zz = zs[z0 : z0 + sz + 1]
                grid = np.stack(
                    np.meshgrid(zz, ys, xs, indexing="ij"), axis=-1
                )  # [sz+1, r1, r1, 3] in (z, y, x) order
                pts = np.stack(
                    [grid[..., 2], grid[..., 1], grid[..., 0]], axis=-1
                ).reshape(-1, 3)
                vals = np.asarray(sdf_eval(pts.astype(np.float32))).reshape(
                    sz + 1, r1, r1
                )
            if use_native:
                keys, pos = native.mc_slab(vals, z0, midpoint)
            else:
                keys, pos = _slab_triangles(vals, z0, res, midpoint)
            if slab_store is not None:
                slab_store.save(z0, keys=keys, pos=pos)
        if keys.shape[0]:
            all_keys.append(keys.reshape(-1))
            all_pos.append(pos.reshape(-1, 3))
        if stats is not None:
            stats.setdefault("slab_triangles", {})[z0] = int(keys.shape[0])
        if progress is not None:
            progress("extract", (z0 + sz) / res)
        z0 += sz

    return assemble_mesh(all_keys, all_pos, lo, cell, use_native=use_native)


def assemble_mesh(
    all_keys: List[np.ndarray],
    all_pos: List[np.ndarray],
    lo: np.ndarray,
    cell: float,
    use_native: Optional[bool] = None,
) -> Mesh:
    """Weld flat (edge-key, grid-unit-position) triangle streams into an
    indexed world-space mesh, dropping degenerate triangles.  Vertices come
    out in sorted edge-key order (``np.unique``), or in order of first
    appearance with the native weld."""
    from .. import native

    if use_native is None:
        use_native = native.available()
    lo = np.asarray(lo, dtype=np.float64)
    if not all_keys:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))

    keys = np.concatenate(all_keys)
    pos = np.concatenate(all_pos)
    if use_native:
        _, inverse, first_idx = native.weld(keys)
    else:
        _, first_idx, inverse = np.unique(keys, return_index=True, return_inverse=True)
    vertices_grid = pos[first_idx]
    vertices = (lo[None, :] + cell * vertices_grid).astype(np.float32)
    faces = inverse.reshape(-1, 3)
    # Drop degenerate triangles (repeated welded vertices).
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return Mesh(vertices=vertices, faces=faces[ok])


def refine_vertices(
    vertices: np.ndarray,
    sdf_eval: Callable[[np.ndarray], np.ndarray],
    normal_eval: Callable[[np.ndarray], np.ndarray],
    steps: int,
    step_scale: float = 1.0,
    progress: Optional[Callable[[str, float], None]] = None,
) -> np.ndarray:
    """Newton-style projection ``p <- p - n(p) * sdf(p)`` — the reference's
    "gradient descent" sharp-feature recovery (mesh.hpp:531-593), applied to
    the welded vertex set (the reference applies it to the triangle soup's
    duplicated vertices; welded-first is equivalent and keeps the mesh
    watertight by construction)."""
    v = np.asarray(vertices, dtype=np.float32)
    for step in range(steps):
        s = np.asarray(sdf_eval(v)).astype(np.float32)
        n = np.asarray(normal_eval(v)).astype(np.float32)
        v = v - step_scale * n * s[:, None]
        if progress is not None:
            progress("refine", (step + 1) / steps)
    return v
