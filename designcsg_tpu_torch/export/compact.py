"""Compact extraction: marching-cubes compaction on the device.

The active-block path (export/active.py) copies float32 corner blocks to the
host, most of whose values only ever contribute a sign bit.  This module
compacts on the device down to what marching cubes consumes
(export/compact.py of the JAX package):

  * per active cell: its linear index and its 8-bit corner-sign case;
  * per cut edge: its linear index and the interpolation parameter
    ``t = v0 / (v0 - v1)``.

The JAX package counts the active cells and cut edges first and compacts into
power-of-two buckets, because XLA needs fixed shapes; torch compacts to the
exact sizes (``nonzero``).  The host never sees a corner value: triangle
topology comes from the cases through the generated 256-case table, and
vertex positions decode from the edge key and ``t``.  The triangle set is the
dense and active paths' (the same cells, ``t`` formula and table).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..evaluator import BatchEvaluator
from ..ops.marching_cubes import EDGE_AXIS, EDGE_ORIGIN, Mesh, triangle_table
from .active import make_slab_provider


def slab_compact(vals: torch.Tensor, midpoint: bool = False):
    """Compact one slab of corner values f32[sz+1, r1, r1] on its device:
    ``(cell_idx i64[C], case u8[C], [(edge_idx i64[E_a], t f32[E_a]) for the
    x, y and z edges])``, every index slab-local and row-major."""
    inside = (vals < 0.0).to(torch.int32)
    sz, ny, nx = (n - 1 for n in vals.shape)
    case = torch.zeros((sz, ny, nx), dtype=torch.int32, device=vals.device)
    # corner c = cx + 2*cy + 4*cz (ops/marching_cubes.py CORNERS order)
    for c in range(8):
        cx, cy, cz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        case |= inside[cz : cz + sz, cy : cy + ny, cx : cx + nx] << c
    case = case.reshape(-1)
    cells = torch.nonzero((case != 0) & (case != 255)).squeeze(1)

    def edge(v0, v1):
        cut = torch.nonzero(((v0 < 0.0) != (v1 < 0.0)).reshape(-1)).squeeze(1)
        v0, v1 = v0.reshape(-1)[cut], v1.reshape(-1)[cut]
        if midpoint:
            return cut, torch.full_like(v0, 0.5)
        denom = v0 - v1
        t = torch.where(denom.abs() > 1e-12, v0 / torch.where(denom == 0, 1.0, denom), 0.5)
        return cut, t.clamp(0.0, 1.0)

    edges = [edge(vals[:, :, :-1], vals[:, :, 1:]), edge(vals[:, :-1, :], vals[:, 1:, :]),
             edge(vals[:-1], vals[1:])]
    return cells, case[cells].to(torch.uint8), edges


def extract_surface_compact(
    evaluator: BatchEvaluator,
    center: np.ndarray,
    half_diameter: float,
    resolution: int,
    midpoint: bool = False,
    slab_cells: int = 32,
    progress: Optional[Callable[[str, float], None]] = None,
    use_native: Optional[bool] = None,
    slab_store=None,
    stats: Optional[dict] = None,
    device_mesh=None,
) -> Mesh:
    """March ``resolution^3`` cells, copying only the compacted (cell case,
    edge t) streams off the device.  The triangle set of the dense and
    active paths (up to enumeration order).

    ``slab_store`` / ``stats``: per-slab resume shards, and per slab the
    count of active cells under ``stats["slab_cells_active"]``.
    ``device_mesh`` shards each slab's z-rows over its ranks
    (active.py make_slab_provider, compact.py:137-161 of the JAX package)."""
    res = int(resolution)
    slab = min(int(slab_cells), res)
    if res % slab != 0:
        raise ValueError(f"slab_cells={slab} must divide resolution={res}")
    center = np.asarray(center, dtype=np.float64)
    cell = 2.0 * half_diameter / res
    lo = center - half_diameter
    r1 = res + 1
    provider = make_slab_provider(evaluator, device_mesh)
    # Per axis, a z-plane's (ny, nx) of edges: global keys are
    # ((axis * r1 + gz) * r1 + gy) * r1 + gx, as in ops/marching_cubes.py.
    edge_dims = ((r1, res), (res, r1), (r1, r1))
    cells_idx: List[np.ndarray] = []
    cells_cfg: List[np.ndarray] = []
    ekeys: List[np.ndarray] = []
    ets: List[np.ndarray] = []
    for z0 in range(0, res, slab):
        cached = slab_store.load(z0) if slab_store is not None else None
        if cached is not None:
            ci, cc, ek, et = (cached[k] for k in ("cells_idx", "cells_cfg", "edge_keys", "edge_t"))
        else:
            cells, case, edges = slab_compact(provider(lo, cell, z0, slab + 1, r1), midpoint)
            ci = cells.cpu().numpy() + z0 * res * res
            cc = case.cpu().numpy()
            keys, ts = [], []
            for axis, (idx, t) in enumerate(edges):
                ny, nx = edge_dims[axis]
                idx = idx.cpu().numpy()
                gz, rem = idx // (ny * nx) + z0, idx % (ny * nx)
                keys.append(((axis * r1 + gz) * r1 + rem // nx) * r1 + rem % nx)
                ts.append(t.cpu().numpy())
            ek, et = np.concatenate(keys), np.concatenate(ts).astype(np.float32)
            if slab_store is not None:
                slab_store.save(z0, cells_idx=ci, cells_cfg=cc, edge_keys=ek, edge_t=et)
        if ci.shape[0]:
            cells_idx.append(ci)
            cells_cfg.append(cc)
            ekeys.append(ek)
            ets.append(et)
        if stats is not None:
            stats.setdefault("slab_cells_active", {})[z0] = int(ci.shape[0])
        if progress is not None:
            progress("extract", (z0 + slab) / res)
    if not cells_idx:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    return assemble_from_compact(np.concatenate(cells_idx), np.concatenate(cells_cfg),
                                 np.concatenate(ekeys), np.concatenate(ets), res, lo, cell,
                                 use_native)


def assemble_from_compact(
    cells_idx: np.ndarray,  # i64[N] global linear cell index (z*res + y)*res + x
    cells_cfg: np.ndarray,  # u8[N]
    edge_keys: np.ndarray,  # i64[E] global edge keys (duplicates across slabs allowed)
    edge_t: np.ndarray,  # f32[E]
    resolution: int,
    lo: np.ndarray,
    cell: float,
    use_native: Optional[bool] = None,
) -> Mesh:
    """Host assembly: cases -> table -> triangle edge keys; weld the edge keys
    to vertex ids; positions decode from key + t.  A triangle whose edge is
    missing from the stream raises."""
    from .. import native

    if use_native is None:
        use_native = native.available()
    res = int(resolution)
    r1 = res + 1
    if use_native:
        tri_keys = native.cells_to_tri_keys(cells_idx, cells_cfg, res)
    else:
        tri_keys = _cells_to_tri_keys_np(cells_idx, cells_cfg, res)
    if tri_keys.shape[0] == 0:
        return Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    flat = tri_keys.reshape(-1)
    if use_native:
        _, inverse, first_idx = native.weld(flat)
        unique_keys = flat[first_idx]
    else:
        unique_keys, inverse = np.unique(flat, return_inverse=True)
    # t per unique key: look it up in the sorted (key, t) stream.
    order = np.argsort(edge_keys, kind="stable")
    sorted_keys = edge_keys[order]
    pos = np.searchsorted(sorted_keys, unique_keys)
    if not np.array_equal(sorted_keys[np.clip(pos, 0, sorted_keys.size - 1)], unique_keys):
        raise AssertionError("triangle references an edge missing from the compacted stream")
    t = edge_t[order][pos]
    axis = unique_keys // (r1 * r1 * r1)
    rem = unique_keys % (r1 * r1 * r1)
    grid_pos = np.stack([rem % r1, (rem // r1) % r1, rem // (r1 * r1)], axis=-1).astype(np.float64)
    grid_pos = grid_pos + t[:, None].astype(np.float64) * np.eye(3)[axis]
    vertices = (np.asarray(lo)[None, :] + cell * grid_pos).astype(np.float32)
    faces = inverse.reshape(-1, 3)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return Mesh(vertices=vertices, faces=faces[ok])


def _cells_to_tri_keys_np(cells_idx: np.ndarray, cells_cfg: np.ndarray, resolution: int) -> np.ndarray:
    """i64[T, 3] global edge keys of every triangle (numpy fallback)."""
    tri_edges, n_tris = triangle_table()
    res = int(resolution)
    r1 = res + 1
    cz, cy, cx = cells_idx // (res * res), (cells_idx // res) % res, cells_idx % res
    counts = n_tris[cells_cfg]
    tri_cell = np.repeat(np.arange(cells_idx.shape[0]), counts)
    if tri_cell.size == 0:
        return np.zeros((0, 3), np.int64)
    slot = np.concatenate([np.arange(c) for c in counts])
    edges = tri_edges[cells_cfg[tri_cell], slot]  # i64[T, 3]
    axis, orig = EDGE_AXIS[edges], EDGE_ORIGIN[edges]
    gx = cx[tri_cell][:, None] + orig[..., 0]
    gy = cy[tri_cell][:, None] + orig[..., 1]
    gz = cz[tri_cell][:, None] + orig[..., 2]
    return ((axis * r1 + gz) * r1 + gy) * r1 + gx
