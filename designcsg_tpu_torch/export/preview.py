"""Mesh preview rasterizer — screenshot-style renders of exported meshes.

The reference publishes *export* screenshots taken in an external mesh
viewer (its README.md:15-16) but ships no way to look at an exported mesh
itself.  This module (a copy of export/preview.py of the JAX package) closes
that loop: a dependency-free numpy rasterizer good enough to eyeball a
refined export (``cli preview``).

Implementation is a point-splat z-buffer rather than a scanline rasterizer:
triangles are sampled proportionally to area with random barycentrics,
samples project orthographically and paint nearest-last into the raster.
O(samples) numpy with no per-triangle Python loop — a 300k-triangle mesh
renders in well under a second, which a polygon-exact rasterizer in numpy
cannot do.  Splatting leaves sub-pixel speckle; the parity gates blur before
correlating (as they already do for the viewport), and ``fill_background``
closes residual pinholes for clean visual output.
"""

from __future__ import annotations

import numpy as np

from ..ops.marching_cubes import Mesh


def _camera_basis(view_dir, up):
    fwd = np.asarray(view_dir, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    return right, true_up, fwd


def rasterize_mesh(
    mesh: Mesh,
    view_dir=(0.55, -0.35, 0.76),
    up=(0.0, 1.0, 0.0),
    size: int = 256,
    samples: int = 4_000_000,
    light_dir=(-0.4, 0.8, -0.45),
    base: float = 0.42,
    diffuse: float = 0.25,
    background: float = 0.95,
    margin: float = 0.06,
    perspective: float | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Render ``mesh`` to a ``u8[size, size]`` grayscale image.

    Orthographic projection along ``view_dir`` (the reference screenshots
    are weak-perspective viewer shots; the parity gate crops and rescales,
    so orthographic is the right normalization-free choice).  Shading is
    Lambertian off ``light_dir`` with two-sided normals (marching-cubes
    orientation is irrelevant to the preview) over a light background."""
    tri = mesh.triangle_soup().astype(np.float64)  # [F, 3, 3]
    if tri.shape[0] == 0:
        return np.full((size, size), int(background * 255), np.uint8)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=1)
    keep = area2 > 0
    tri, e1, e2, n, area2 = tri[keep], e1[keep], e2[keep], n[keep], area2[keep]
    n = n / area2[:, None]

    rng = np.random.default_rng(seed)
    # per-triangle sample counts proportional to area, at least 1
    counts = np.maximum(
        1, np.round(samples * area2 / area2.sum()).astype(np.int64)
    )
    idx = np.repeat(np.arange(tri.shape[0]), counts)
    u = rng.random(idx.shape[0])
    v = rng.random(idx.shape[0])
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    pts = tri[idx, 0] + u[:, None] * e1[idx] + v[:, None] * e2[idx]
    nrm = n[idx]

    right, true_up, fwd = _camera_basis(view_dir, up)
    x = pts @ right
    y = pts @ true_up
    depth = pts @ fwd
    if perspective is not None:
        # Weak perspective: camera at ``perspective`` object-diameters
        # behind the content's near plane along view_dir.
        d0 = depth.min()
        diam = (depth.max() - d0) + 1e-9
        zcam = depth - d0 + perspective * diam
        scale = (perspective + 0.5) * diam / zcam
        xc, yc = (x.min() + x.max()) / 2.0, (y.min() + y.max()) / 2.0
        x = xc + (x - xc) * scale
        y = yc + (y - yc) * scale

    # fit content into the raster with a margin; y flips to image rows
    x0, x1 = x.min(), x.max()
    y0, y1 = y.min(), y.max()
    span = max(x1 - x0, y1 - y0) / (1.0 - 2.0 * margin)
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    ix = ((x - cx) / span + 0.5) * (size - 1)
    iy = ((cy - y) / span + 0.5) * (size - 1)
    ix = np.clip(np.round(ix).astype(np.int64), 0, size - 1)
    iy = np.clip(np.round(iy).astype(np.int64), 0, size - 1)

    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)
    shade = base + diffuse * np.abs(nrm @ light)

    # nearest-last painting: sort far-to-near, later writes win
    order = np.argsort(-depth, kind="stable")
    img = np.full((size, size), background, np.float64)
    img[iy[order], ix[order]] = shade[order]
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def fill_background_pinholes(img: np.ndarray, background_thresh: int = 235):
    """Median-of-neighbors fill for isolated background-colored pixels
    inside content (point-splat speckle) — purely cosmetic; the parity
    gates blur instead."""
    out = img.copy()
    core = img[1:-1, 1:-1]
    neigh = np.stack(
        [
            img[:-2, 1:-1],
            img[2:, 1:-1],
            img[1:-1, :-2],
            img[1:-1, 2:],
        ]
    )
    hole = (core >= background_thresh) & (
        (neigh < background_thresh).sum(axis=0) >= 3
    )
    out[1:-1, 1:-1] = np.where(hole, np.median(neigh, axis=0), core)
    return out
