"""Retopology: T-junction crack healing for mixed-resolution meshes.

Port of the reference's crack-patching pass (cms/main/Headers/
mesh.hpp:432-529; export/retopo.py of the JAX package): every triangle
vertex is indexed to a global grid (the reference's Indexer/Deindexer,
mesh.hpp:413-430); each triangle's edges are walked at grid resolution
collecting *occupied* grid points into an n-gon, which is re-triangulated
with an alternating strip (geometry.hpp:228-248).  This heals the cracks that
appear where meshes of different cell sizes meet: the coarse side's edge
passes through lattice points that the fine side has vertices on; inserting
those points makes the two sides share edges exactly.

The uniform-grid extractor (ops/marching_cubes.py, export/active.py) never
produces cracks — welding is exact — so this pass is not in the default
export.  It matters when *mixed resolutions* meet: region exports at
different ``grid_level`` stitched with :func:`merge_meshes`, or meshes from
resumable per-region runs.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.marching_cubes import Mesh


def boundary_edges(mesh: Mesh) -> np.ndarray:
    """i64[B, 2] directed edges that appear in exactly one triangle (crack /
    open-boundary edges).  Direction is as the owning triangle winds them,
    so a hole's boundary traverses it consistently."""
    f = mesh.faces
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    key = np.sort(e, axis=1)
    _, inverse, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    return e[counts[inverse] == 1]


def _min_area_triangulation(
    loop: List[int], verts: np.ndarray
) -> List[Tuple[int, int, int]]:
    """Dynamic-programming minimal-total-area triangulation of a polygon's
    vertex ids (the crack slivers this caps are near-degenerate — area is
    the right cost to keep new triangles inside the sliver)."""
    m = len(loop)
    if m < 3:
        return []
    if m == 3:
        return [(loop[0], loop[1], loop[2])]
    p = verts[loop].astype(np.float64)

    # Edge-vector table E[a, b] = p[b] - p[a]; triangle areas come from one
    # broadcast cross product per loop instead of a python call per (i,k,j)
    # candidate (r4: the per-call np.cross dominated the whole healing
    # stage — ~285k calls over ~9k crack loops).  Loops are sliver-sized
    # (mostly 4-8 vertices), so the O(m^3) area tensor is tiny; very large
    # loops fall back to one vectorized row per (i, j).
    E = p[None, :, :] - p[:, None, :]
    A = None
    if m <= 48:
        C = np.cross(E[:, :, None, :], E[:, None, :, :])
        A = 0.5 * np.linalg.norm(C, axis=-1)  # A[i, k, j] = area(p_i,p_k,p_j)

    cost = np.zeros((m, m))
    split = np.zeros((m, m), dtype=np.int64)
    for span in range(2, m):
        for i in range(m - span):
            j = i + span
            ks = np.arange(i + 1, j)
            if A is not None:
                tri_areas = A[i, ks, j]
            else:
                tri_areas = 0.5 * np.linalg.norm(
                    np.cross(E[i, ks], E[i, j][None]), axis=-1
                )
            c = cost[i, ks] + cost[ks, j] + tri_areas
            t = int(np.argmin(c))
            cost[i, j] = c[t]
            split[i, j] = i + 1 + t
    tris: List[Tuple[int, int, int]] = []

    def emit(i, j):
        if j - i < 2:
            return
        k = int(split[i, j])
        tris.append((loop[i], loop[k], loop[j]))
        emit(i, k)
        emit(k, j)

    emit(0, m - 1)
    return tris


def stitch_boundary_loops(
    mesh: Mesh,
    domain_lo: Optional[np.ndarray] = None,
    domain_hi: Optional[np.ndarray] = None,
    eps: float = 1e-6,
    max_loop: int = 64,
    stats: Optional[dict] = None,
) -> Mesh:
    """Close crack loops by triangulating them — the completion the
    reference's retopology pass lacks.

    Multi-resolution marching cubes leaves *sliver cracks* where a coarse
    cell's contour chord and the neighboring fine cells' contour polyline
    cross the shared face differently; lattice-point insertion
    (:func:`retopologize`, the reference's mesh.hpp:432-529) heals only the
    collinear T-junction case, and the reference ships the rest to gradient
    descent to squash visually.  Here every remaining crack is closed
    exactly: boundary edges (in exactly one triangle) always chain into
    closed loops, each loop is capped with its minimal-area triangulation,
    oriented opposite to the traversal so winding stays consistent.

    Loops lying entirely on the domain box (``domain_lo``/``domain_hi``
    faces) are genuine clip boundaries, not cracks — left open.  Loops
    longer than ``max_loop`` vertices are left open as a safety valve
    (a real crack sliver is local); every loop left open that way is
    *counted and logged* (``stats['open_loops']`` + a warning), so a
    degenerate run cannot silently claim "healed" while leaking cracks."""
    bedges = boundary_edges(mesh)
    if bedges.shape[0] == 0:
        return mesh

    on_domain = None
    if domain_lo is not None and domain_hi is not None:
        v = mesh.vertices
        lo = np.asarray(domain_lo, dtype=np.float64)
        hi = np.asarray(domain_hi, dtype=np.float64)
        on_domain = ((np.abs(v - lo) < eps) | (np.abs(v - hi) < eps)).any(axis=1)

    # next_edge[v] = unused boundary edges leaving v.
    out_edges: dict = {}
    for idx, (a, b) in enumerate(bedges):
        out_edges.setdefault(int(a), []).append(idx)
    used = np.zeros(bedges.shape[0], dtype=bool)

    new_faces: List[Tuple[int, int, int]] = []
    open_loops = 0
    closed_loops = 0
    for start_idx in range(bedges.shape[0]):
        if used[start_idx]:
            continue
        loop = [int(bedges[start_idx, 0])]
        used[start_idx] = True
        cur = int(bedges[start_idx, 1])
        ok = True
        while cur != loop[0]:
            loop.append(cur)
            nxt = None
            for e in out_edges.get(cur, ()):
                if not used[e]:
                    nxt = e
                    break
            if nxt is None or len(loop) > max_loop:
                ok = False
                break
            used[nxt] = True
            cur = int(bedges[nxt, 1])
        if not ok or len(loop) < 3:
            if len(loop) > max_loop:
                open_loops += 1
            continue
        if on_domain is not None and on_domain[np.asarray(loop)].all():
            continue  # clip boundary, not a crack
        # Cap with winding opposite the boundary traversal: boundary edges
        # run as their triangles wind them, so the cap must run reversed to
        # present the matching orientation.
        cap = _min_area_triangulation(loop[::-1], mesh.vertices)
        new_faces.extend(cap)
        closed_loops += 1

    if stats is not None:
        stats["open_loops"] = stats.get("open_loops", 0) + open_loops
        stats["closed_loops"] = stats.get("closed_loops", 0) + closed_loops
    if open_loops:
        logging.getLogger("designcsg_tpu_torch").warning(
            "stitch_boundary_loops left %d crack loop(s) longer than %d "
            "vertices open (healing is incomplete for this mesh)",
            open_loops,
            max_loop,
        )
    if not new_faces:
        return mesh
    faces = np.concatenate(
        [mesh.faces, np.asarray(new_faces, dtype=np.int64).reshape(-1, 3)]
    )
    ok_tri = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return Mesh(vertices=mesh.vertices, faces=faces[ok_tri])


def strip_triangulate(polygon: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Alternating-ends strip triangulation of a polygon's vertex ids,
    preserving the polygon's winding (the reference's
    getIndexTriangleStrip, geometry.hpp:228-248)."""
    m = len(polygon)
    if m < 3:
        return []
    seq = []
    lo, hi = 0, m - 1
    take_front = True
    while lo <= hi:
        if take_front:
            seq.append(polygon[lo])
            lo += 1
        else:
            seq.append(polygon[hi])
            hi -= 1
        take_front = not take_front
    tris = []
    for i in range(len(seq) - 2):
        a, b, c = seq[i], seq[i + 1], seq[i + 2]
        # Alternate winding so every strip triangle matches the polygon's
        # (seq zig-zags front/back, flipping orientation every step).
        tris.append((a, c, b) if i % 2 == 0 else (a, b, c))
    return tris


def merge_meshes(meshes: Iterable[Mesh], weld_eps: float = 0.0) -> Mesh:
    """Concatenate meshes and weld exactly-coincident vertices (or within
    ``weld_eps`` by rounded-coordinate key).  Region exports over adjacent
    boxes share boundary vertices exactly at matching resolutions; at
    mismatched resolutions the result has T-junction cracks — heal with
    :func:`retopologize`."""
    meshes = list(meshes)
    if not meshes:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    verts = np.concatenate([m.vertices for m in meshes]).astype(np.float32)
    offsets = np.cumsum([0] + [m.num_vertices for m in meshes][:-1])
    faces = np.concatenate(
        [m.faces + off for m, off in zip(meshes, offsets)]
    ).astype(np.int64)
    if weld_eps > 0.0:
        key = np.round(verts / weld_eps).astype(np.int64)
    else:
        key = verts.view(np.int32).astype(np.int64).reshape(-1, 3)
    _, first, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = verts[first]
    faces = inverse[faces]
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return Mesh(vertices=verts, faces=faces[ok])


def _lattice_keys(idx: np.ndarray) -> np.ndarray:
    """Collision-free int64 key per lattice point (coords fit in 21 bits
    after offsetting — lattices here are <= 2^12 per axis)."""
    off = np.int64(1) << 20
    return (
        ((idx[..., 2] + off) << 42)
        | ((idx[..., 1] + off) << 21)
        | (idx[..., 0] + off)
    )


def retopologize(
    mesh: Mesh,
    grid_origin: np.ndarray,
    cell: float,
) -> Mesh:
    """Heal T-junction cracks by re-triangulating every triangle against the
    global vertex lattice.

    ``grid_origin``/``cell`` define the finest lattice the mesh's vertices
    live on (for merged region exports: the finest region's grid).  Vertices
    are snapped to lattice indices; each triangle edge is walked along the
    lattice segment between its endpoints, inserting any lattice point
    occupied by another vertex of the mesh; the resulting n-gon is
    strip-triangulated.  Winding is preserved, so a watertight-up-to-cracks
    input becomes edge-manifold.

    Vectorized for reference-scale meshes (the reference runs this per
    triangle in C++, mesh.hpp:432-529): welding, degenerate-face removal,
    per-edge interior-lattice-point discovery and occupancy lookups are all
    batched numpy (sorted-key searchsorted instead of a hash map); only the
    triangles that actually gain vertices — the level-transition seams, a
    tiny fraction — take the per-triangle re-triangulation path."""
    lo = np.asarray(grid_origin, dtype=np.float64)
    v = mesh.vertices.astype(np.float64)
    idx = np.round((v - lo[None, :]) / cell).astype(np.int64)

    # Occupied lattice -> representative vertex id (first occurrence wins —
    # coincident vertices are welded, as in merge_meshes).
    keys = _lattice_keys(idx)
    ukeys, first, inverse = np.unique(
        keys, return_index=True, return_inverse=True
    )
    canon = first[inverse]

    faces = canon[mesh.faces]
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    # Per-edge interior lattice points exist only when gcd(|delta|) >= 2.
    ea = faces  # [T, 3] edge starts (a->b, b->c, c->a)
    eb = faces[:, [1, 2, 0]]
    delta = idx[eb] - idx[ea]  # [T, 3, 3]
    g = np.gcd.reduce(np.abs(delta), axis=-1)  # [T, 3]
    cand = g >= 2
    touched = np.zeros(faces.shape[0], dtype=bool)
    hits_per_edge: dict = {}
    if cand.any():
        ti, ei = np.nonzero(cand)
        gs = g[ti, ei]  # [E]
        starts = idx[ea[ti, ei]]  # [E, 3]
        steps = delta[ti, ei] // gs[:, None]
        # Ragged expansion: edge e contributes gs[e]-1 interior points.
        counts = gs - 1
        total = int(counts.sum())
        owner = np.repeat(np.arange(ti.size), counts)
        k_in_edge = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts
        ) + 1
        pts = starts[owner] + steps[owner] * k_in_edge[:, None]
        pkeys = _lattice_keys(pts)
        pos = np.searchsorted(ukeys, pkeys)
        pos_c = np.minimum(pos, ukeys.size - 1)
        found = ukeys[pos_c] == pkeys
        hit_vid = first[pos_c]
        p_vid = ea[ti, ei][owner]
        q_vid = eb[ti, ei][owner]
        use = found & (hit_vid != p_vid) & (hit_vid != q_vid)
        if use.any():
            for j in np.nonzero(use)[0]:
                e = int(owner[j])
                hits_per_edge.setdefault(
                    (int(ti[e]), int(ei[e])), []
                ).append(int(hit_vid[j]))
            touched[np.unique(ti[owner[use]])] = True

    new_faces_arrays = [faces[~touched]]
    extra: List[Tuple[int, int, int]] = []
    for t in np.nonzero(touched)[0]:
        a, b, c = (int(x) for x in faces[t])
        ngon: List[int] = []
        for ei_, p in enumerate((a, b, c)):
            ngon.append(p)
            ngon.extend(hits_per_edge.get((int(t), ei_), ()))
        dedup = [x for i, x in enumerate(ngon) if x != ngon[i - 1]]
        if len(dedup) >= 3:
            extra.extend(strip_triangulate(dedup))
    if extra:
        new_faces_arrays.append(np.asarray(extra, dtype=np.int64))
    faces = np.concatenate(new_faces_arrays) if new_faces_arrays else faces

    # Compact unused vertices.
    used = np.unique(faces) if faces.size else np.zeros(0, np.int64)
    remap = np.full(mesh.num_vertices, -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    return Mesh(
        vertices=mesh.vertices[used].astype(np.float32),
        faces=remap[faces] if faces.size else faces.reshape(-1, 3),
    )
