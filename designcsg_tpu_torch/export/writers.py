"""Binary STL / PLY mesh writers.

Format parity with the reference's writers (reference:
cms/main/Headers/utils.hpp:41-154): STL is the 80-byte
header + u32 count + 50-byte records with zero normals and **Y/Z swapped**
vertex coordinates; PLY is binary little-endian with float64 vertex positions
and uchar-counted int vertex index lists (what the vendored happly emits).
Pure numpy struct packing — no external mesh library.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..ops.marching_cubes import Mesh


def write_stl(path: str, mesh: Mesh, header_text: str = "") -> int:
    """Binary STL with the reference's conventions: zero normals, vertices
    written as (x, z, y) (utils.hpp:63-76).  Returns the triangle count.
    Without a header the native writer (native/meshops.cpp) writes the same
    bytes when it is available."""
    if not header_text:
        from .. import native

        if native.available():
            return native.write_stl_soup(path, mesh.triangle_soup())
    tri = mesh.triangle_soup().astype("<f4")  # [F, 3, 3]
    n = tri.shape[0]
    records = np.zeros((n, 50), dtype=np.uint8)
    # 12 floats per record: normal(3) + 3 vertices, Y/Z swapped.
    f = np.zeros((n, 12), dtype="<f4")
    f[:, 3] = tri[:, 0, 0]
    f[:, 4] = tri[:, 0, 2]
    f[:, 5] = tri[:, 0, 1]
    f[:, 6] = tri[:, 1, 0]
    f[:, 7] = tri[:, 1, 2]
    f[:, 8] = tri[:, 1, 1]
    f[:, 9] = tri[:, 2, 0]
    f[:, 10] = tri[:, 2, 2]
    f[:, 11] = tri[:, 2, 1]
    records[:, :48] = f.view(np.uint8).reshape(n, 48)
    with open(path, "wb") as fl:
        header = header_text.encode()[:80]
        fl.write(header + b"\x00" * (80 - len(header)))
        fl.write(struct.pack("<I", n))
        fl.write(records.tobytes())
    return n


def read_stl(path: str) -> Mesh:
    """Read back a binary STL (undoing the Y/Z swap) — used by tests and the
    resume path."""
    with open(path, "rb") as fl:
        fl.read(80)
        (n,) = struct.unpack("<I", fl.read(4))
        data = np.frombuffer(fl.read(n * 50), dtype=np.uint8).reshape(n, 50)
    f = data[:, :48].copy().view("<f4").reshape(n, 12)
    tri = np.zeros((n, 3, 3), dtype=np.float32)
    for v in range(3):
        tri[:, v, 0] = f[:, 3 + v * 3 + 0]
        tri[:, v, 2] = f[:, 3 + v * 3 + 1]
        tri[:, v, 1] = f[:, 3 + v * 3 + 2]
    vertices = tri.reshape(-1, 3)
    faces = np.arange(n * 3, dtype=np.int64).reshape(n, 3)
    return Mesh(vertices=vertices, faces=faces)


def write_ply(path: str, mesh: Mesh, soup: bool = True) -> int:
    """Binary little-endian PLY.  ``soup=True`` duplicates vertices per face
    (the reference's happly output, utils.hpp:115-137); ``soup=False`` writes
    the welded indexed mesh (smaller, watertight)."""
    if soup:
        vertices = mesh.triangle_soup().reshape(-1, 3).astype("<f8")
        faces = np.arange(vertices.shape[0], dtype="<i4").reshape(-1, 3)
    else:
        vertices = mesh.vertices.astype("<f8")
        faces = mesh.faces.astype("<i4")
    nv, nf = vertices.shape[0], faces.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {nv}\n"
        "property double x\n"
        "property double y\n"
        "property double z\n"
        f"element face {nf}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    face_records = np.zeros((nf, 13), dtype=np.uint8)
    face_records[:, 0] = 3
    face_records[:, 1:] = faces.view(np.uint8).reshape(nf, 12)
    with open(path, "wb") as fl:
        fl.write(header.encode())
        fl.write(vertices.tobytes())
        fl.write(face_records.tobytes())
    return nf


def read_ply(path: str) -> Mesh:
    """Minimal binary PLY reader for the files this module writes."""
    with open(path, "rb") as fl:
        header_lines = []
        while True:
            line = fl.readline().decode().strip()
            header_lines.append(line)
            if line == "end_header":
                break
        nv = nf = 0
        for line in header_lines:
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
        vertices = np.frombuffer(fl.read(nv * 24), dtype="<f8").reshape(nv, 3)
        face_data = np.frombuffer(fl.read(nf * 13), dtype=np.uint8).reshape(nf, 13)
    faces = face_data[:, 1:].copy().view("<i4").reshape(nf, 3).astype(np.int64)
    return Mesh(vertices=vertices.astype(np.float32), faces=faces)
