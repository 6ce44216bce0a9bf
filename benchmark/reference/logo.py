"""Logo, frozen from upstream DesignCSG ``Designs/Logo.py``: the letters C,
S and G on three faces of a cube, each a brush that reads its outline and
its inside mask from the arbitrary data.

A letter is a list of quadratic Bezier segments ``(a, b, c)`` in the
letter's square [-1, 1]^2 and a 65x65 lattice of inside bits over that
square, row 0 at y = 1.  At a local point ``v`` the brush works on
``(x, y, z) = 2v``: ``d`` is the distance from ``(x, y)`` to the 64
samples ``(1-t)((1-t)a + tb) + t((1-t)b + tc)``, ``t = j/64``, of every
segment; the sign comes from the bit of the lattice cell
``col = int(64 (x+1)/2)``, ``row = 64 - int(64 (y+1)/2)`` (Logo.py:263-275):
``-d`` where that cell is inside, else ``d - 0.075``; the result is
clipped to the letter's plate, ``max(signed, max(|x|, |y|, |z|) - 1.25,
|z - 1.25| - 0.125)`` (Logo.py:314).  The three letters sit in the frames
``(x, y, -z)``, ``(z, y, x)`` and ``(z, -x, y)`` (as matrix columns) at the
origin, under the root of scale 5, and are joined.

Here ``d`` is written directly, ``sqrt(min_j (x - sx_j)^2 + (y - sy_j)^2)``,
in blocks of samples so that a block of 2^20 points fits, and in the
points' dtype: no matrix product, so no TF32 question arises on the card.

Departures from upstream:

- The font.  Upstream reads CourierPrime-Bold.ttf; the outlines and masks
  here are DejaVu Sans Mono Bold's, read as data from the glyph file the
  repository commits (segments f64[n, 6] and the unpacked bits), the same
  data the program is built from.
- Upstream packs each mask 16 bits to a float and unpacks the cell's bit
  in the brush; here the bits are read unpacked.
- Upstream computes ``d`` in OpenCL; this is the same formula in PyTorch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .geometry import Design, Leaf

GLYPHS = (Path(__file__).resolve().parents[2] / "designcsg_tpu_torch" / "designs" / "data"
          / "logo_glyphs.npz")
LETTERS = "CSG"
SUBSEGMENTS = 64
THICKNESS = 0.075
PLATE_HALF, PLATE_Z, PLATE_HALF_DEPTH = 1.25, 1.25, 0.125
# Samples a block: a block of 2^20 points then takes 1 GiB a temporary.
SAMPLE_BLOCK = 256

# FP32 operations of one point-sample pair: two differences, two squares,
# a sum and a minimum.
FLOPS_PER_PAIR = 6
#: Point-sample pairs of one field evaluation: every sample of every letter,
#: (18 + 28 + 22) segments of 64 samples.
SAMPLES_PER_EVALUATION = 4352

_X, _Y, _Z = np.eye(3)
# Each letter's frame: its local axes, as the columns of its matrix.
FRAMES = {"C": (_X, _Y, -_Z), "S": (_Z, _Y, _X), "G": (_Z, -_X, _Y)}


def _matrix(columns) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.stack(columns, axis=1)
    return m


def _samples(segments: np.ndarray) -> torch.Tensor:
    """f32[n * 64, 2]: the letter's Bezier samples, in float32 from the
    float32 control points, segment after segment."""
    p = torch.as_tensor(np.asarray(segments, np.float32))
    a, b, c = p[:, None, 0:2], p[:, None, 2:4], p[:, None, 4:6]
    t = (torch.arange(SUBSEGMENTS, dtype=torch.float32) / SUBSEGMENTS)[None, :, None]
    return ((1 - t) * ((1 - t) * a + t * b) + t * ((1 - t) * b + t * c)).reshape(-1, 2)


class Letter:
    """One letter's brush ``letter(v f[..., 3]) -> f[...]``."""

    def __init__(self, segments: np.ndarray, bits: np.ndarray, resolution: int):
        self.samples = _samples(segments)
        self.bits = torch.as_tensor(np.asarray(bits) == 1)
        self.resolution = int(resolution)
        self._on = {}

    def _data(self, like: torch.Tensor):
        key = (like.dtype, like.device)
        if key not in self._on:
            self._on[key] = (self.samples.to(like.device, like.dtype), self.bits.to(like.device))
        return self._on[key]

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        samples, bits = self._data(v)
        shape = v.shape[:-1]
        v = 2.0 * v.reshape(-1, 3)
        x, y, z = v[:, 0], v[:, 1], v[:, 2]
        d2 = None
        for start in range(0, samples.shape[0], SAMPLE_BLOCK):
            s = samples[start:start + SAMPLE_BLOCK]
            dx = x[:, None] - s[None, :, 0]
            dy = y[:, None] - s[None, :, 1]
            block = (dx * dx + dy * dy).amin(dim=1)
            d2 = block if d2 is None else torch.minimum(d2, block)
        d = torch.sqrt(d2)
        r = self.resolution
        col = (r * (x + 1.0) / 2.0).to(torch.int32)
        row = r - (r * (y + 1.0) / 2.0).to(torch.int32)
        in_range = (col >= 0) & (col <= r) & (row >= 0) & (row <= r)
        cell = (row.clamp(0, r) * (r + 1) + col.clamp(0, r)).long()
        signed = torch.where(in_range & bits[cell], -d, d - THICKNESS)
        box = torch.maximum(torch.abs(x) - PLATE_HALF,
                             torch.maximum(torch.abs(y) - PLATE_HALF, torch.abs(z) - PLATE_HALF))
        slab = torch.abs(z - PLATE_Z) - PLATE_HALF_DEPTH
        return torch.maximum(torch.maximum(signed, box), slab).reshape(shape)


def letters():
    """``{letter: Letter}`` from the glyph file."""
    with np.load(GLYPHS) as z:
        r = int(z["letter_resolution"])
        return {ch: Letter(z[f"segments_{ch}"], z[f"bits_{ch}"], r) for ch in LETTERS}


def design(orient=None) -> Design:
    brushes = letters()
    return Design([Leaf(brushes[ch], _matrix(FRAMES[ch])) for ch in LETTERS], orient)
