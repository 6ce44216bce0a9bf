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

from .. import native
from ..ops.marching_cubes import Mesh


def boundary_edges(mesh: Mesh) -> np.ndarray:
    """i64[B, 2] directed edges that appear in exactly one triangle (crack /
    open-boundary edges).  Direction is as the owning triangle winds them,
    so a hole's boundary traverses it consistently."""
    f = mesh.faces
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    # One int64 key an undirected edge: a 1-D sort, not a row-wise one.
    stride = int(e.max(initial=0)) + 1
    key = np.minimum(e[:, 0], e[:, 1]) * stride + np.maximum(e[:, 0], e[:, 1])
    _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    return e[counts[inverse] == 1]


def _min_area_caps(flat: np.ndarray, lengths: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """i64[sum(lengths - 2), 3]: the loops' caps, loop after loop; the
    loops' vertex ids lie one after another in ``flat``.  A loop's cap is
    its dynamic-programming minimal-total-area triangulation (the crack
    slivers this caps are near-degenerate — area is the right cost to keep
    new triangles inside the sliver), as :func:`_cap_block` solves it for
    all loops of one length together."""
    start = np.cumsum(lengths) - lengths
    out_start = np.cumsum(lengths - 2) - (lengths - 2)
    out = np.zeros((int((lengths - 2).sum()), 3), dtype=np.int64)
    for m in np.unique(lengths):
        sel = lengths == m
        ids = flat[start[sel][:, None] + np.arange(m)]  # [B, m]
        out[out_start[sel][:, None] + np.arange(m - 2)] = _cap_block(ids, verts)
    return out


def _cap_block(ids: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """i64[B, m - 2, 3]: the minimal-area triangulations of B loops of
    length m.  For each span j - i, the best split k of every (loop, i),
    the first of equal costs, costing the triangle (p_i, p_k, p_j) by half
    the norm of (p_k - p_i) x (p_j - p_i); the triangles come out in the
    order of the recursion from (0, m - 1): the split's triangle, then the
    part below it, then the part above."""
    B, m = ids.shape
    p = verts[ids].astype(np.float64)
    cost = np.zeros((B, m, m))
    split = np.zeros((B, m, m), dtype=np.int64)
    for span in range(2, m):
        i = np.arange(m - span)
        j = i + span
        k = i[:, None] + 1 + np.arange(span - 1)  # [I, K]
        origin = p[:, i, None, :]
        area = 0.5 * np.linalg.norm(
            np.cross(p[:, k, :] - origin, (p[:, j, :] - p[:, i, :])[:, :, None, :]), axis=-1)
        c = cost[:, i[:, None], k] + cost[:, k, j[:, None]] + area  # [B, I, K]
        t = np.argmin(c, axis=2)  # [B, I]
        cost[:, i, j] = np.take_along_axis(c, t[..., None], 2)[..., 0]
        split[:, i, j] = i + 1 + t
    # The recursion's order, for all B loops in step: a stack of (i, j).
    rows = np.arange(B)
    stack = np.zeros((B, m, 2), dtype=np.int64)
    stack[:, 0] = (0, m - 1)
    top = np.zeros(B, dtype=np.int64)
    tris = np.zeros((B, m - 2, 3), dtype=np.int64)
    for n in range(m - 2):
        i, j = stack[rows, top, 0], stack[rows, top, 1]
        k = split[rows, i, j]
        tris[:, n] = np.stack([ids[rows, i], ids[rows, k], ids[rows, j]], axis=1)
        # Pop (i, j); push (k, j), then (i, k) on top of it.
        above, below = j - k >= 2, k - i >= 2
        top = top - 1 + above
        stack[rows[above], top[above]] = np.stack([k, j], axis=1)[above]
        top = top + below
        stack[rows[below], top[below]] = np.stack([i, k], axis=1)[below]
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
    degenerate run cannot silently claim "healed" while leaking cracks.

    The boundary edges, the walk and the caps run in one pass of the native
    library (``native.stitch_loops``) when it is available, and in numpy
    otherwise: the same faces either way."""
    if native.available():
        caps, n_boundary, open_loops, closed_loops, degenerate = native.stitch_loops(
            mesh.faces, mesh.vertices, domain_lo, domain_hi, eps, max_loop)
        if not n_boundary:
            return mesh
    else:
        bedges = boundary_edges(mesh)
        if bedges.shape[0] == 0:
            return mesh
        flat, lengths, open_loops = _walk_loops(mesh, bedges, domain_lo, domain_hi, eps,
                                                max_loop)
        closed_loops, degenerate = len(lengths), True
        if lengths:
            caps = _min_area_caps(np.asarray(flat, dtype=np.int64), np.asarray(lengths),
                                  mesh.vertices)

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
    if not closed_loops:
        return mesh
    # Faces with a repeated vertex go; the native caps come without them.
    faces = np.concatenate([mesh.faces, caps])
    if degenerate:
        faces = faces[(faces[:, 0] != faces[:, 1])
                      & (faces[:, 1] != faces[:, 2])
                      & (faces[:, 0] != faces[:, 2])]
    return Mesh(vertices=mesh.vertices, faces=faces)


def _walk_loops(mesh: Mesh, bedges: np.ndarray, domain_lo, domain_hi, eps: float,
                max_loop: int) -> Tuple[List[int], List[int], int]:
    """:func:`stitch_boundary_loops`' walk of the boundary edges in numpy:
    (the loops to cap, reversed, one after another; their lengths; the
    loops left open for exceeding ``max_loop``)."""
    on_domain = None
    if domain_lo is not None and domain_hi is not None:
        v = mesh.vertices
        lo = np.asarray(domain_lo, dtype=np.float64)
        hi = np.asarray(domain_hi, dtype=np.float64)
        on_domain = ((np.abs(v - lo) < eps) | (np.abs(v - hi) < eps)).any(axis=1)

    # The boundary edges leaving each vertex, in index order: positions
    # head[v] .. tail[v] - 1 of ``by_start``; ``head`` moves past used ones.
    # Flat lists of ints keep the garbage collector out of the walk.
    by_start = np.argsort(bedges[:, 0], kind="stable")
    verts_out, first, count = np.unique(bedges[by_start, 0], return_index=True,
                                        return_counts=True)
    head = np.zeros(mesh.num_vertices, dtype=np.int64)
    tail = np.zeros(mesh.num_vertices, dtype=np.int64)
    head[verts_out], tail[verts_out] = first, first + count
    head, tail, by_start = head.tolist(), tail.tolist(), by_start.tolist()
    src, dst = bedges[:, 0].tolist(), bedges[:, 1].tolist()
    used = [False] * len(src)
    on_domain = None if on_domain is None else on_domain.tolist()

    flat: List[int] = []  # the loops to cap, reversed, one after another
    lengths: List[int] = []
    open_loops = 0
    for start_idx in range(len(src)):
        if used[start_idx]:
            continue
        loop = [src[start_idx]]
        used[start_idx] = True
        cur = dst[start_idx]
        ok = True
        while cur != loop[0]:
            loop.append(cur)
            h = head[cur]
            while h < tail[cur] and used[by_start[h]]:
                h += 1
            head[cur] = h
            if h == tail[cur] or len(loop) > max_loop:
                ok = False
                break
            nxt = by_start[h]
            used[nxt] = True
            cur = dst[nxt]
        if not ok or len(loop) < 3:
            if len(loop) > max_loop:
                open_loops += 1
            continue
        if on_domain is not None and all(on_domain[v] for v in loop):
            continue  # clip boundary, not a crack
        # Cap with winding opposite the boundary traversal: boundary edges
        # run as their triangles wind them, so the cap must run reversed to
        # present the matching orientation.
        flat.extend(reversed(loop))
        lengths.append(len(loop))
    return flat, lengths, open_loops


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


def _split_touched(faces, touched, hit_t, hit_e, hit_k, hit_v) -> np.ndarray:
    """i64[N, 3]: each touched triangle's n-gon triangulated as
    :func:`strip_triangulate` does, in triangle order.  The n-gon walks the corners a, b, c, each followed by
    the occupied lattice points inside its edge (``hit_*``: triangle, edge
    0-2, step along the edge, vertex), with every vertex equal to the one
    before it (cyclically) dropped; n-gons under 3 vertices give nothing."""
    tt = np.nonzero(touched)[0]
    tri = np.concatenate([np.repeat(tt, 3), hit_t])
    edge = np.concatenate([np.tile(np.arange(3), tt.size), hit_e])
    step = np.concatenate([np.zeros(3 * tt.size, np.int64), hit_k])  # corners first
    vert = np.concatenate([faces[tt].reshape(-1), hit_v])
    order = np.lexsort((step, edge, tri))
    tri, vert = tri[order], vert[order]
    head = np.flatnonzero(np.r_[True, tri[1:] != tri[:-1]])
    size = np.diff(np.r_[head, tri.size])
    before = np.arange(tri.size) - 1
    before[head] = head + size - 1  # the first vertex follows the last
    keep = vert != vert[before]
    tri, vert = tri[keep], vert[keep]
    _, start, n = np.unique(tri, return_index=True, return_counts=True)
    out_start = np.cumsum(np.maximum(n - 2, 0)) - np.maximum(n - 2, 0)
    out = np.zeros((int(np.maximum(n - 2, 0).sum()), 3), dtype=np.int64)
    for m in np.unique(n[n >= 3]):
        sel = n == m
        polys = vert[start[sel][:, None] + np.arange(m)]  # [B, m]
        q = np.arange(m)
        seq = np.where(q % 2 == 0, q // 2, m - 1 - q // 2)  # front, back, ...
        i = np.arange(m - 2)[:, None]
        corner = seq[i + np.where(i % 2 == 0, [0, 2, 1], [0, 1, 2])]  # [m - 2, 3]
        out[out_start[sel][:, None] + np.arange(m - 2)] = polys[:, corner]
    return out


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
    batched numpy (sorted-key searchsorted instead of a hash map), and so is
    the re-triangulation of the triangles that gain vertices (the
    level-transition seams, a tiny fraction), n-gons of one size together."""
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
    extra = np.zeros((0, 3), dtype=np.int64)
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
            touched[ti[owner[use]]] = True
            extra = _split_touched(faces, touched, ti[owner[use]], ei[owner[use]],
                                   k_in_edge[use], hit_vid[use])
    faces = np.concatenate([faces[~touched], extra])

    # Compact unused vertices.
    used = np.unique(faces) if faces.size else np.zeros(0, np.int64)
    remap = np.full(mesh.num_vertices, -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    return Mesh(
        vertices=mesh.vertices[used].astype(np.float32),
        faces=remap[faces] if faces.size else faces.reshape(-1, 3),
    )
