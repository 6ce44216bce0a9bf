"""ctypes bindings of the native mesh ops (meshops.cpp).

The port's copy of the JAX package's designcsg_tpu/native: marching-cubes
triangles of a corner slab (``mc_slab``) or of gathered corner blocks
(``mc_blocks``), the triangle edge keys of compacted cells
(``cells_to_tri_keys``), exact vertex welding (``weld``) and the binary STL
writer (``write_stl_soup``); the port's own crack-loop stitch
(``stitch_loops``).  The library is built with g++ at first use into
``build/torch_native/`` of the checkout (keyed by the source's hash, written
atomically, so parallel processes agree) and never beside the source.  Every
caller checks :func:`available` and takes the numpy implementation without a
host compiler, as the JAX package does; the export report records which ran
(``stats["native"]``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().with_name("meshops.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_LL = ctypes.c_longlong
_TABLE = [_I64P, _I64P, _LL, _I64P, _I64P]  # tri_edges, n_tris, maxt, edge_axis, edge_origin


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmeshops_{digest}.so"


def _build(path: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, path)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.mc_slab.restype = _LL
        lib.mc_slab.argtypes = [_F32P, _LL, _LL, _LL, ctypes.c_int, *_TABLE, _I64P, _I64P, _I64P,
                                _LL, _I64P, _F32P]
        lib.mc_blocks.restype = _LL
        lib.mc_blocks.argtypes = [_F32P, _I64P, _LL, _LL, _LL, _LL, _LL, ctypes.c_int, *_TABLE,
                                  _I64P, _I64P, _I64P, _LL, _I64P, _F32P]
        lib.cells_to_tri_keys.restype = _LL
        lib.cells_to_tri_keys.argtypes = [_I64P, _U8P, _LL, _LL, *_TABLE, _LL, _I64P]
        lib.weld.restype = _LL
        lib.weld.argtypes = [_I64P, _LL, _I64P, _I64P]
        lib.stitch_loops.restype = _LL
        lib.stitch_loops.argtypes = [_I64P, _LL, _F64P, _LL, ctypes.c_int, _F64P, _F64P,
                                     ctypes.c_double, _LL, _I64P, _I64P]
        lib.write_stl_soup.restype = _LL
        lib.write_stl_soup.argtypes = [ctypes.c_char_p, _F32P, _LL]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    return _load() is not None


def _tables():
    """The marching-cubes tables as the library takes them, from
    ops/marching_cubes.py's generated table (the two can never drift)."""
    from ..ops.marching_cubes import CORNERS, EDGE_AXIS, EDGE_ORIGIN, EDGES, triangle_table

    tri_edges, n_tris = triangle_table()
    table = [
        np.ascontiguousarray(tri_edges.reshape(-1)), np.ascontiguousarray(n_tris),
        tri_edges.shape[1], np.ascontiguousarray(EDGE_AXIS),
        np.ascontiguousarray(EDGE_ORIGIN.reshape(-1)),
    ]
    corner_edges = [np.ascontiguousarray(EDGES[:, 0]), np.ascontiguousarray(EDGES[:, 1]),
                    np.ascontiguousarray(CORNERS.reshape(-1))]
    return table, corner_edges


def _grow(call, capacity: int):
    """Run ``call(capacity, keys, pos)`` with output buffers that double
    until the triangles fit (the library returns -1 when they do not)."""
    while True:
        keys = np.empty((capacity * 3,), dtype=np.int64)
        pos = np.empty((capacity * 9,), dtype=np.float32)
        n = call(capacity, keys, pos)
        if n >= 0:
            return keys[: n * 3].reshape(n, 3), pos[: n * 9].reshape(n, 3, 3)
        capacity *= 2


def mc_slab(corners: np.ndarray, z0: int, midpoint: bool) -> tuple[np.ndarray, np.ndarray]:
    """Native twin of ops.marching_cubes._slab_triangles.  ``corners`` is
    f32[sz+1, r1, r1]; returns (keys i64[T, 3], pos f32[T, 3, 3] grid units)."""
    lib = _load()
    assert lib is not None
    table, corner_edges = _tables()
    corners = np.ascontiguousarray(corners, dtype=np.float32)
    sz, r1 = corners.shape[0] - 1, corners.shape[1]
    flat = corners.reshape(-1)
    return _grow(
        lambda cap, keys, pos: lib.mc_slab(flat, sz, r1, int(z0), int(midpoint), *table,
                                           *corner_edges, cap, keys, pos),
        max(1 << 16, 4 * sz * r1 * 8),
    )


def mc_blocks(corners: np.ndarray, coords: np.ndarray, resolution: int,
              midpoint: bool) -> tuple[np.ndarray, np.ndarray]:
    """Native twin of ops.marching_cubes._block_triangles over K blocks.
    ``corners`` is f32[K, nz+1, ny+1, nx+1]; ``coords`` is i64[K, 3] global
    (x0, y0, z0) cell origins.  Returns (keys i64[T, 3], pos f32[T, 3, 3])."""
    lib = _load()
    assert lib is not None
    table, corner_edges = _tables()
    corners = np.ascontiguousarray(corners, dtype=np.float32)
    coords = np.ascontiguousarray(coords, dtype=np.int64)
    k = corners.shape[0]
    nz, ny, nx = (corners.shape[1] - 1, corners.shape[2] - 1, corners.shape[3] - 1)
    flat, cflat = corners.reshape(-1), coords.reshape(-1)
    return _grow(
        lambda cap, keys, pos: lib.mc_blocks(flat, cflat, k, nz, ny, nx, int(resolution) + 1,
                                             int(midpoint), *table, *corner_edges, cap, keys, pos),
        max(1 << 16, 2 * k * nz * max(ny, nx)),
    )


def cells_to_tri_keys(cells_idx: np.ndarray, cells_cfg: np.ndarray, resolution: int) -> np.ndarray:
    """Native twin of export.compact._cells_to_tri_keys_np: expands (global
    cell index, config) pairs to i64[T, 3] global edge keys."""
    lib = _load()
    assert lib is not None
    table, _ = _tables()
    cells_idx = np.ascontiguousarray(cells_idx, dtype=np.int64)
    cells_cfg = np.ascontiguousarray(cells_cfg, dtype=np.uint8)
    capacity = max(1 << 12, int(table[2]) * cells_idx.shape[0])
    keys = np.empty((capacity * 3,), dtype=np.int64)
    n = lib.cells_to_tri_keys(cells_idx, cells_cfg, cells_idx.shape[0], int(resolution), *table,
                              capacity, keys)
    assert n >= 0
    return keys[: n * 3].reshape(n, 3)


def weld(keys: np.ndarray) -> tuple[int, np.ndarray, np.ndarray]:
    """Exact-key vertex welding, in order of first appearance.  Returns
    (num_unique, inverse, first_idx)."""
    lib = _load()
    assert lib is not None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    inverse = np.empty((n,), dtype=np.int64)
    first_idx = np.empty((n,), dtype=np.int64)
    num = lib.weld(keys, n, inverse, first_idx)
    return int(num), inverse, first_idx[:num]


def stitch_loops(faces: np.ndarray, vertices: np.ndarray, domain_lo: Optional[np.ndarray],
                 domain_hi: Optional[np.ndarray], eps: float,
                 max_loop: int) -> tuple[np.ndarray, int, int, int, int]:
    """Native twin of export.retopo.stitch_boundary_loops' boundary edges,
    loop walk and caps.  Returns (the caps without a repeated vertex,
    i64[C, 3] in loop order; boundary edges; open loops; closed loops; the
    faces given with a repeated vertex); the domain box applies when both
    of its corners are given."""
    lib = _load()
    assert lib is not None
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    verts = np.ascontiguousarray(vertices, dtype=np.float64)  # exact from float32
    if faces.ndim != 2 or faces.shape[1] != 3 or verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"faces {faces.shape} and vertices {verts.shape} must be [N, 3]")
    has_domain = domain_lo is not None and domain_hi is not None
    lo = np.ascontiguousarray(domain_lo if has_domain else np.zeros(3), dtype=np.float64)
    hi = np.ascontiguousarray(domain_hi if has_domain else np.zeros(3), dtype=np.float64)
    caps = np.empty((3 * faces.shape[0], 3), dtype=np.int64)  # a loop of m edges: m - 2 caps
    counts = np.zeros(4, dtype=np.int64)
    n = lib.stitch_loops(faces.reshape(-1), faces.shape[0], verts.reshape(-1), verts.shape[0],
                         int(has_domain), lo, hi, float(eps), int(max_loop), caps.reshape(-1),
                         counts)
    if n < 0:
        raise IndexError("a face names a vertex outside the mesh")
    return (caps[:n], *(int(c) for c in counts))


def write_stl_soup(path: str, tris: np.ndarray) -> int:
    """Binary STL of a triangle soup f32[T, 3, 3]; returns T."""
    lib = _load()
    assert lib is not None
    tris = np.ascontiguousarray(tris, dtype=np.float32)
    return int(lib.write_stl_soup(path.encode(), tris.reshape(-1), tris.shape[0]))
