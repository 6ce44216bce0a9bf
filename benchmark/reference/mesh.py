"""What a written mesh is held to: upstream's binary STL read back, the gap
of its vertices to the design's zero set, and its volume against the
design's own.

Upstream writes an 80-byte header, a little-endian u32 triangle count and
50-byte records of a zero normal and three vertices stored as (x, z, y)
(cms/main/Headers/utils.hpp:41-76).  The design's volume is counted on a
jittered lattice of the design's field: one point a cell, placed uniformly
in its cell from a generator seeded by the caller, so a face that lies on a
lattice plane costs no bias.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .geometry import Design


def read_stl(path: str) -> np.ndarray:
    """float32[F, 3, 3]: each triangle's vertices as (x, y, z)."""
    with open(path, "rb") as f:
        f.read(80)
        (n,) = struct.unpack("<I", f.read(4))
        raw = np.frombuffer(f.read(50 * n), dtype=np.uint8)
    if raw.size != 50 * n:
        raise ValueError(f"{path}: {n} triangles announced, {raw.size // 50} present")
    xzy = raw.reshape(n, 50)[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
    return np.ascontiguousarray(xzy[:, :, [0, 2, 1]])


def volume(triangles: np.ndarray) -> float:
    """|signed volume| of a triangle soup by the divergence theorem."""
    t = triangles.astype(np.float64)
    return abs(float(np.einsum("ij,ij->i", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum()) / 6.0)


def field_at(design: Design, points: np.ndarray, device, block: int = 1 << 20) -> np.ndarray:
    """float32[N]: the design's field at the points, in float32."""
    out = []
    for start in range(0, points.shape[0], block):
        p = torch.as_tensor(points[start:start + block], dtype=torch.float32).to(device)
        out.append(design.field(p).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def design_volume(design: Design, lo, hi, cells: int, seed: int, device,
                  dtype=torch.float32, block: int = 1 << 20) -> float:
    """The design's volume inside the box [lo, hi] (world units), counted
    on a jittered lattice of ``cells`` cells an axis, the field computed in
    ``dtype``."""
    lo = np.asarray(lo, np.float64)
    step = (np.asarray(hi, np.float64) - lo) / cells
    gen = torch.Generator(device=device).manual_seed(seed)
    total = cells ** 3
    inside = 0
    axis = torch.arange(cells, device=device, dtype=torch.float64)
    for start in range(0, total, block):
        idx = torch.arange(start, min(total, start + block), device=device)
        ijk = torch.stack([idx // (cells * cells), (idx // cells) % cells, idx % cells], -1)
        jitter = torch.rand(ijk.shape, generator=gen, device=device, dtype=torch.float64)
        p = torch.as_tensor(lo, device=device) + (axis[ijk] + jitter) * torch.as_tensor(
            step, device=device)
        inside += int((design.field(p.to(dtype)) < 0).sum())
    return inside * float(np.prod(step))


def project_bf16(design: Design, points: np.ndarray, steps: int, device) -> np.ndarray:
    """The control: the points taken onto the design's zero set by
    ``steps`` Newton steps ``p - f(p) grad f / |grad f|^2``, every value in
    bfloat16."""
    p = torch.as_tensor(points, dtype=torch.float32).to(device, torch.bfloat16)
    for _ in range(steps):
        q = p.detach().requires_grad_()
        f = design.field(q)
        (g,) = torch.autograd.grad(f.sum(), q)
        g = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)  # a root's kink at 0
        with torch.no_grad():
            p = p - (f / (g * g).sum(-1).clamp_min(1e-3))[:, None] * g
    return p.float().cpu().numpy()
