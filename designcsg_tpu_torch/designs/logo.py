"""Logo — extruded TrueType letters ("CSG") on three cube faces.

The reference's arbitrary-data showcase (designs/logo.py of the JAX package):
glyph outlines as quadratic Bezier segments and per-letter inside/outside
bitmasks, packed 16 bits per float, live in the arbitrary-data array, and the
letter brush reads everything from ``ctx.ad`` — so the outlines are
differentiable parameters.

Two fields per letter:

* the exact brush (``fn``): the distance to 64 samples on every segment
  (1,152-1,792 per letter), as the affine min
  ``x^2 + y^2 + min_j(-2 s_j.p + |s_j|^2)`` chunked over the samples, signed
  by the bitmask and clipped to the letter's plate;
* the baked twin (``twin``, the field of every kernel): a weighted rank-32
  factorization of the same letter field on a 128x128 grid, within 0.02 of
  the exact brush near the surface (``twin_approx``).  The kernels and the
  twin sample it in its expanded form, four dense planes per letter
  (:func:`letter_planes`): csrc/table.cuh ``plane_sample`` on the card,
  ops/table.py ``plane_sample`` in PyTorch.

The glyph data is committed (data/logo_glyphs.npz, extracted from
matplotlib's DejaVuSansMono-Bold.ttf), so building Logo needs neither
fontTools nor matplotlib; another font or letter set is read with fontTools.
The factor tables and their planes are baked from it at build time in
float64 numpy and cached in memory, once per process.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import api
from ..api import Transform
from ..observability import span
from ..ops.cuda.tape import f32_literal
from ..ops.cull import (
    f32,
    fadd,
    fmax,
    fmin,
    fsub,
    iv_abs,
    iv_add,
    iv_const,
    iv_max,
    iv_mul_scalar,
    iv_sqrt,
    iv_square,
    iv_sub,
)
from ..ops.table import PLANES, plane_sample

LETTER_RESOLUTION = 64
SUBSEGMENTS = 64
THICKNESS = 0.075

# The baked twin: a weighted rank-BAKE_RANK factorization of the letter field
# on a BAKE_RES^2 grid of [-BAKE_L, BAKE_L]^2 (letter units).
BAKE_RES = 128
BAKE_RANK = 32
BAKE_L = 1.4
TWIN_APPROX = 0.02

#: The committed glyph data: per letter the segments f64[n, 6] and the
#: bitmask [(R+1)^2], the font's sha256 and LETTER_RESOLUTION.
GLYPH_DATA = Path(__file__).resolve().parent / "data" / "logo_glyphs.npz"

# Affine-min chunk (samples per matmul) and the padding samples' offset.
CHUNK = 256
BIG = 3.0e37

_GLYPHS: dict = {}
_TABLES: dict = {}
_PLANES: dict = {}


def _default_font() -> str:
    """matplotlib's DejaVuSansMono-Bold.ttf, the font of the committed data."""
    import matplotlib

    return os.path.join(
        os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
    )


def _glyph_segments_and_mask_uncached(font, letter: str):
    """Quadratic segments (rescaled to [-1,1]^2) + (R+1)^2 inside bitmask.

    TrueType outlines are quadratic B-splines with implied on-curve midpoints
    between consecutive off-curve points; lines become degenerate quadratics
    with B = midpoint(A, C) — the same decomposition the reference's
    InterceptorPen performs (Logo.py:109-177)."""
    from fontTools.pens.pointInsidePen import PointInsidePen
    from fontTools.pens.recordingPen import RecordingPen

    cmap = font.getBestCmap()
    glyph_set = font.getGlyphSet()
    glyph = glyph_set[cmap[ord(letter)]]

    pen = RecordingPen()
    glyph.draw(pen)

    # Bounds for rescaling to [-1, 1]^2 (Logo.py:48-65).
    points = []
    for op, args in pen.value:
        for pt in args:
            if pt is not None:
                points.append(pt)
    pts = np.asarray(points, dtype=np.float64)
    mn, mx = pts.min(axis=0), pts.max(axis=0)

    def rescale(p):
        return (
            -1.0 + 2.0 * (p[0] - mn[0]) / (mx[0] - mn[0]),
            -1.0 + 2.0 * (p[1] - mn[1]) / (mx[1] - mn[1]),
        )

    def inv_rescale(p):
        return (
            mn[0] + (mx[0] - mn[0]) * (p[0] + 1.0) / 2.0,
            mn[1] + (mx[1] - mn[1]) * (p[1] + 1.0) / 2.0,
        )

    segments = []
    current = (0.0, 0.0)
    path_start = current

    def add_line(a, c):
        b = ((a[0] + c[0]) / 2.0, (a[1] + c[1]) / 2.0)
        segments.append((a, b, c))

    for op, args in pen.value:
        if op == "moveTo":
            current = rescale(args[0])
            path_start = current
        elif op == "lineTo":
            nxt = rescale(args[0])
            add_line(current, nxt)
            current = nxt
        elif op == "qCurveTo":
            pts_q = list(args)
            if pts_q[-1] is None:
                raise ValueError("all-off-curve qCurveTo not supported")
            if len(pts_q) == 1:  # degenerate: behaves as a line
                nxt = rescale(pts_q[0])
                add_line(current, nxt)
                current = nxt
            else:
                # on-curve start, off-curve points with implied on-curve
                # midpoints between consecutive off-points, explicit end.
                start_on = current
                for i in range(len(pts_q) - 1):
                    off = rescale(pts_q[i])
                    if i < len(pts_q) - 2:
                        nxt_off = rescale(pts_q[i + 1])
                        on = ((off[0] + nxt_off[0]) / 2.0, (off[1] + nxt_off[1]) / 2.0)
                    else:
                        on = rescale(pts_q[-1])
                    segments.append((start_on, off, on))
                    start_on = on
                current = rescale(pts_q[-1])
        elif op == "curveTo":
            # cubic (CFF fonts): approximated by three lines through the
            # control points
            c1, c2, end = (rescale(p) for p in args[-3:])
            add_line(current, c1)
            add_line(c1, c2)
            add_line(c2, end)
            current = end
        elif op == "closePath":
            if current != path_start:
                add_line(current, path_start)
            current = path_start

    # Inside/outside lattice (Logo.py:332-343): border forced outside.
    r = LETTER_RESOLUTION
    bits = np.zeros(((r + 1) * (r + 1),), dtype=np.int64)
    idx = 0
    for row in range(r + 1):
        for col in range(r + 1):
            y = 1.0 - 2.0 * row / r
            x = -1.0 + 2.0 * col / r
            if row in (0, r) or col in (0, r):
                inside = 0
            else:
                pen_in = PointInsidePen(glyph_set, inv_rescale((x, y)))
                glyph.draw(pen_in)
                inside = 1 if pen_in.getResult() else 0
            bits[idx] = inside
            idx += 1
    return segments, bits


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """16 bits per float, MSB first (Logo.py:86-99)."""
    out = []
    for start in range(0, len(bits), 16):
        chunk = bits[start : start + 16]
        value = 0
        for bit in chunk:
            value = value * 2 + int(bit)
        value <<= 16 - len(chunk)
        out.append(float(value))
    return np.asarray(out, dtype=np.float32)


def _segments_from_array(rows: np.ndarray):
    return [((r[0], r[1]), (r[2], r[3]), (r[4], r[5])) for r in np.asarray(rows, np.float64).tolist()]


def extract_glyphs(font_path: Optional[str] = None, letters: str = "CSG") -> dict:
    """``{letter: (segments, bits)}`` read from a TrueType font with
    fontTools (matplotlib's DejaVuSansMono-Bold.ttf by default)."""
    try:
        from fontTools.ttLib import TTFont
    except ImportError as exc:
        raise ImportError(
            "reading glyph outlines from a font needs fontTools (pip install fonttools); "
            "the default letters 'CSG' come from the committed glyph data and need no font"
        ) from exc
    font = TTFont(font_path or _default_font())
    return {letter: _glyph_segments_and_mask_uncached(font, letter) for letter in letters}


def write_glyph_data(path=GLYPH_DATA, font_path: Optional[str] = None, letters: str = "CSG") -> None:
    """Regenerate the committed glyph data from a font (needs fontTools)."""
    font_path = font_path or _default_font()
    glyphs = extract_glyphs(font_path, letters)
    with open(font_path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    arrays = dict(
        font=np.asarray(os.path.basename(font_path)),
        font_sha256=np.asarray(digest),
        letter_resolution=np.asarray(LETTER_RESOLUTION),
    )
    for letter, (segments, bits) in glyphs.items():
        arrays[f"segments_{letter}"] = np.asarray(segments, np.float64).reshape(-1, 6)
        arrays[f"bits_{letter}"] = np.asarray(bits, np.uint8)
    np.savez_compressed(path, **arrays)


def load_glyphs(font_path: Optional[str] = None, letters: str = "CSG") -> dict:
    """``{letter: (segments, bits)}``: from the committed glyph data when no
    font is given, else read from ``font_path`` with fontTools."""
    key = (font_path, letters)
    if key not in _GLYPHS:
        if font_path is None:
            with np.load(GLYPH_DATA) as z:
                if int(z["letter_resolution"]) != LETTER_RESOLUTION:
                    raise ValueError(f"{GLYPH_DATA} was written for another LETTER_RESOLUTION")
                missing = [ch for ch in letters if f"segments_{ch}" not in z.files]
                if missing:
                    raise KeyError(
                        f"letters {missing} are not in {GLYPH_DATA.name}; pass font_path= "
                        "to read them from a font (needs fontTools)"
                    )
                _GLYPHS[key] = {
                    ch: (_segments_from_array(z[f"segments_{ch}"]), z[f"bits_{ch}"].astype(np.int64))
                    for ch in letters
                }
        else:
            _GLYPHS[key] = extract_glyphs(font_path, letters)
    return _GLYPHS[key]


# ---------------------------------------------------------------------------
# The bake (designs/logo.py:249-375 of the JAX package), in float64 numpy.
# ---------------------------------------------------------------------------


def _curve_samples_np(segments) -> np.ndarray:
    """The brush's Bezier sample points, in numpy (same t grid and
    decomposition as the torch brush)."""
    t = (np.arange(SUBSEGMENTS, dtype=np.float64) / SUBSEGMENTS)[:, None]
    pts = []
    for (a, b, c) in segments:
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        c = np.asarray(c, np.float64)
        pts.append((1 - t) * ((1 - t) * a + t * b) + t * ((1 - t) * b + t * c))
    return np.concatenate(pts, axis=0)


def _bake_field(samples: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """The continuous letter field ``sigma*d - thickness`` on the bake grid:
    ``d`` the distance to the Bezier samples, ``sigma`` the sign from the
    bitmask with the brush's lattice snapping (Logo.py:263-275).  It equals
    the brush everywhere the march can see and, unlike the brush, is
    continuous and 1-Lipschitz, so it is the field to approximate."""
    n, L, r = BAKE_RES, BAKE_L, LETTER_RESOLUTION
    xs = np.linspace(-L, L, n)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    P = np.stack([X.ravel(), Y.ravel()], -1)
    d2min = np.full(P.shape[0], np.inf)
    for s0 in range(0, samples.shape[0], 512):
        chunk = samples[s0 : s0 + 512]
        d2 = ((P[:, None, :] - chunk[None, :, :]) ** 2).sum(-1)
        d2min = np.minimum(d2min, d2.min(axis=1))
    d = np.sqrt(d2min).reshape(n, n)
    bits2 = bits.reshape(r + 1, r + 1)
    qc = (r * (X + 1.0) / 2.0).astype(np.int64)  # trunc-toward-zero, as the brush
    qr = r - (r * (Y + 1.0) / 2.0).astype(np.int64)
    in_range = (qc >= 0) & (qc <= r) & (qr >= 0) & (qr <= r)
    inside = in_range & (bits2[np.clip(qr, 0, r), np.clip(qc, 0, r)] == 1)
    return np.where(inside, -d, d) - THICKNESS  # rows = y, cols = x


def _weighted_lowrank(B: np.ndarray, K: int):
    """Rank-K factorization ``B ~= Uy @ Vx`` by weighted alternating least
    squares, accurate near the zero set, with two guards re-weighted in: no
    phantom surface where B is clearly positive, and an overshoot of at most
    ~0.04 above B (no tunnelling through features >= 0.15 thick)."""
    near = np.abs(B) < 0.15
    W = np.where(near, 1.0, 0.08)
    U0, S0, Vt0 = np.linalg.svd(B)
    Uy = U0[:, :K] * S0[:K]
    Vx = Vt0[:K].copy()
    eye = 1e-8 * np.eye(K)
    for _ in range(4):
        for _ in range(8):
            for i in range(B.shape[0]):
                A = Vx * W[i][None, :]
                Uy[i] = np.linalg.solve(A @ A.T + eye, A @ (B[i] * W[i]))
            for j in range(B.shape[1]):
                w = W[:, j]
                A = Uy.T * w[None, :]
                Vx[:, j] = np.linalg.solve(A @ A.T + eye, A @ (B[:, j] * w))
        approx = Uy @ Vx
        bad = (B > 0.1) & (approx < 0.06)
        bad |= (approx - B) > 0.04
        if not bad.any():
            break
        W[bad] = np.maximum(W[bad] * 8.0, 1.0)
    return Uy, Vx


def _bake_letter_tables(segments, bits) -> np.ndarray:
    """Packed f32[4K, 128] factor tables for ops/table.py and
    csrc/table.cuh: x-factor values UA and forward-difference slopes US,
    then y-factor values VA and slopes VS.  Cached in memory by glyph
    content."""
    samples = _curve_samples_np(segments)
    key = hashlib.sha256(
        b"".join(
            [
                samples.tobytes(),
                np.asarray(bits, np.int64).tobytes(),
                np.float64([BAKE_RES, BAKE_RANK, BAKE_L, THICKNESS]).tobytes(),
            ]
        )
    ).hexdigest()
    if key in _TABLES:
        return _TABLES[key]
    B = _bake_field(samples, np.asarray(bits))
    Uy, Vx = _weighted_lowrank(B, BAKE_RANK)
    UA = Vx.astype(np.float32)  # x factors, (K, 128)
    VA = Uy.T.astype(np.float32)  # y factors, (K, 128)
    US = np.zeros_like(UA)
    US[:, :-1] = UA[:, 1:] - UA[:, :-1]
    VS = np.zeros_like(VA)
    VS[:, :-1] = VA[:, 1:] - VA[:, :-1]
    table = np.concatenate([UA, US, VA, VS], axis=0)
    _TABLES[key] = table
    return table


def letter_planes(table: np.ndarray) -> np.ndarray:
    """The rank table's expanded form, f32[128, 128, 4]: at row ``r`` (y
    cell) and column ``c`` (x cell) the four sums over k of

        AA = UA_k[c] VA_k[r],  AS = UA_k[c] VS_k[r],
        SA = US_k[c] VA_k[r],  SS = US_k[c] VS_k[r],

    so that ``sum_k (UA_k + fx US_k)(VA_k + fy VS_k) = (AA + fy AS) + fx (SA
    + fy SS)`` exactly.  The products are summed in float64 from the f32
    table and rounded once to f32, which puts the planes closer to the rank
    form's float64 value than its own f32 sum.  Rows are y and columns x, so
    rays or points that step along a letter's x read neighbouring 16-byte
    cells.  Cached in memory by table content."""
    key = hashlib.sha256(np.ascontiguousarray(table, np.float32).tobytes()).hexdigest()
    if key not in _PLANES:
        k = table.shape[0] // 4
        ua, us, va, vs = (np.asarray(table[i * k : (i + 1) * k], np.float64) for i in range(4))
        planes = np.stack([va.T @ ua, vs.T @ ua, va.T @ us, vs.T @ us], axis=-1)
        _PLANES[key] = planes.astype(np.float32)
    return _PLANES[key]


# ---------------------------------------------------------------------------
# The letter brush: the exact torch field, its baked twin and the CUDA body.
# ---------------------------------------------------------------------------


def _plate_clip(x, y, z, signed):
    """Clip a letter field to its plate: a box and a thin z slab (Logo.py:314)."""
    box = torch.maximum(torch.abs(x) - 1.25, torch.maximum(torch.abs(y) - 1.25, torch.abs(z) - 1.25))
    slab = torch.abs(z - 1.25) - 0.125
    return torch.maximum(torch.maximum(signed, box), slab)


def plate_proxy(v, ctx):
    """An exact lower bound of the letter brush and of its twin: both are
    ``max(signed, box, slab)`` >= ``max(box, slab)`` (designs/logo.py:550-562
    of the JAX package).  The proxy march steps through open space on it
    and never evaluates the Bezier samples there (ops/raymarch.py)."""
    v = 2.0 * v
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    box = torch.maximum(torch.abs(x) - 1.25, torch.maximum(torch.abs(y) - 1.25, torch.abs(z) - 1.25))
    return torch.maximum(box, torch.abs(z - 1.25) - 0.125)


def _make_letter_brush(curve_start: int, n_curves: int, mask_start: int):
    """The exact brush, reading curve data and bitmask from ``ctx.ad``
    (designs/logo.py:473-549 of the JAX package); differentiable in ``ad``.
    It carries :func:`plate_proxy` as ``__proxy_fn__``, as the JAX brush
    does."""
    r = LETTER_RESOLUTION
    n_samples = n_curves * SUBSEGMENTS
    offs = curve_start + 11 * np.arange(n_curves)
    t_host = torch.from_numpy((np.arange(SUBSEGMENTS, dtype=np.float32) / SUBSEGMENTS)[None, :, None])
    per_device = {}

    def letter_fn(v, ctx):
        # A host span only: its value, the call's point-sample pairs, comes
        # from the shape.
        with span("brush.letter", v.shape[:-1].numel() * n_samples):
            return letter_field(v, ctx)

    def letter_field(v, ctx):
        ad = ctx.ad
        if ad.device not in per_device:
            per_device[ad.device] = (torch.as_tensor(offs, device=ad.device), t_host.to(ad.device))
        o, t = per_device[ad.device]
        v = 2.0 * v
        x, y, z = v[..., 0], v[..., 1], v[..., 2]

        # Curve samples [C*S, 2] from the arbitrary data (differentiable).
        a = torch.stack([ad[o], ad[o + 1]], dim=-1)[:, None, :]
        b = torch.stack([ad[o + 3], ad[o + 4]], dim=-1)[:, None, :]
        c = torch.stack([ad[o + 6], ad[o + 7]], dim=-1)[:, None, :]
        samples = ((1 - t) * ((1 - t) * a + t * b) + t * ((1 - t) * b + t * c)).reshape(-1, 2)
        thickness = ad[curve_start + 9]

        # min_j |p - s_j|^2 = (x^2 + y^2) + min_j(-2 s_j.p + |s_j|^2): the
        # min of affine functions of p, a matmul per chunk of samples with a
        # running min; padding samples sit at +BIG.
        sx, sy = samples[:, 0], samples[:, 1]
        pad = (-sx.shape[0]) % CHUNK
        aff = torch.stack(
            [
                torch.cat([-2.0 * sx, sx.new_zeros(pad)]),
                torch.cat([-2.0 * sy, sy.new_zeros(pad)]),
                torch.cat([sx * sx + sy * sy, sx.new_full((pad,), BIG)]),
            ]
        )
        p = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        m = torch.full_like(x, BIG)
        for s0 in range(0, aff.shape[1], CHUNK):
            m = torch.minimum(m, torch.matmul(p, aff[:, s0 : s0 + CHUNK]).min(dim=-1).values)
        # sqrt(max(d2, 0)) with no epsilon, the JAX package's values bit for
        # bit.  Where d2 <= 0 (a point on a sample, up to rounding: the
        # letters' side walls) the JAX gradient is NaN (ROADMAP F2); here the
        # square root's argument is swapped out there, so the gradient is 0
        # and a fit on the exact field stays finite.
        d2 = x * x + y * y + m
        pos = d2 > 0.0
        d = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)

        # Sign from the packed bitmask (Logo.py:263-275).
        col = (r * (x + 1.0) / 2.0).to(torch.int32)
        row = r - (r * (y + 1.0) / 2.0).to(torch.int32)
        in_range = (col >= 0) & (col <= r) & (row >= 0) & (row <= r)
        bit_position = torch.clamp(row * (r + 1) + col, 0, (r + 1) * (r + 1) - 1)
        word = ad[mask_start + torch.div(bit_position, 16, rounding_mode="floor").long()]
        bit = torch.bitwise_right_shift(word.to(torch.int32), 15 - bit_position % 16) & 1
        signed = torch.where(in_range & (bit == 1), -d, d - thickness)
        return _plate_clip(x, y, z, signed)

    letter_fn.__proxy_fn__ = plate_proxy
    return letter_fn


_GRID_SCALE = (BAKE_RES - 1) / (2.0 * BAKE_L)


def _make_letter_twin(planes_name: str):
    """The baked twin (designs/logo.py:378-421 of the JAX package): the
    rank-32 table, in its planes form, sampled at the grid coordinates of
    ``(2a, 2b)``, bounded below beyond the bake domain by the distance to
    it, and clipped to the plate as the brush is."""

    def twin(v, ctx):
        v = 2.0 * v
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        gx = (x + BAKE_L) * _GRID_SCALE
        gy = (y + BAKE_L) * _GRID_SCALE
        bs = plane_sample(ctx.extras[planes_name], gx, gy)
        # Beyond the bake domain the clamped sample is stale; the distance to
        # the domain's rectangle bounds the field from below.  The epsilon
        # keeps sqrt differentiable where both are 0 (fit_field="twin").
        ox = torch.clamp(torch.abs(x) - BAKE_L, min=0.0)
        oy = torch.clamp(torch.abs(y) - BAKE_L, min=0.0)
        bs = torch.maximum(bs, torch.sqrt(ox * ox + oy * oy + 1e-30) - THICKNESS)
        return _plate_clip(x, y, z, bs)

    return twin


def letter_cuda(planes_name: str) -> str:
    """The CUDA body of the twin: csrc/table.cuh's ``plane_sample`` (K6) on
    the letter's planes at ``ex + EX_<planes_name>``, in the torch twin's
    order of operations."""
    L, gs, T = f32_literal(BAKE_L), f32_literal(_GRID_SCALE), f32_literal(THICKNESS)
    q, e = f32_literal(1.25), f32_literal(0.125)
    return "\n    ".join(
        [
            "const float x = 2.0f * a, y = 2.0f * b, z = 2.0f * c;",
            f"float bs = plane_sample(ex + EX_{planes_name}, (x + {L}) * {gs}, (y + {L}) * {gs});",
            f"const float ox = fmaxf(fabsf(x) - {L}, 0.0f), oy = fmaxf(fabsf(y) - {L}, 0.0f);",
            f"bs = fmaxf(bs, sqrtf(ox * ox + oy * oy + 1e-30f) - {T});",
            f"const float box = fmaxf(fabsf(x) - {q}, fmaxf(fabsf(y) - {q}, fabsf(z) - {q}));",
            f"return fmaxf(fmaxf(bs, box), fabsf(z - {q}) - {e});",
        ]
    )


# FP32 operations of one letter evaluation around K6: 2a, 2b, 2c (3); the
# grid coordinates (4); the bound beyond the bake domain (6 + 7); the box
# (8), the slab (3) and two maxima (2).
_LETTER_CLIP_FLOPS = 3 + 4 + 13 + 8 + 3 + 2
# The rank form's sampler: clip, floor, fractions (8); 3 mul+add per term.
RANK_SAMPLE_FLOPS = 8 + 6 * BAKE_RANK
# The letter's cost as the JAX package's rank form counts it.  The cull's
# cost-aware grouping reads it (``cuda_flops``), so Logo's groups stay the
# JAX package's.
LETTER_FLOPS = _LETTER_CLIP_FLOPS + RANK_SAMPLE_FLOPS
# What letter_cuda's body runs: csrc/table.cuh plane_sample's clip, floor and
# fractions (8) and (AA + fy*AS) + fx*(SA + fy*SS) (6); the kernels' bound
# counts this.
PLANE_SAMPLE_FLOPS = 8 + 6
LETTER_PLANE_FLOPS = _LETTER_CLIP_FLOPS + PLANE_SAMPLE_FLOPS
# Table bytes per letter evaluation: one 16-byte cell of the planes.
LETTER_TABLE_BYTES = 4 * PLANES


# The interval twin of the cull bounds the letter by max(box, slab) below and
# by its distance to N_ANCHORS curve samples above (designs/logo.py:424-470 of
# the JAX package).  That upper bound holds for the exact brush; the baked
# field every kernel evaluates lies above it by up to the bake's error, so the
# port widens it by TWIN_APPROX (ROADMAP.md section 3, F4).
N_ANCHORS = 12
INTERVAL_WIDEN = TWIN_APPROX


def letter_anchors(segments) -> np.ndarray:
    """f32[12, 2]: every (n // 12)-th Bezier sample of the letter, the
    anchors of its interval twin's upper bound."""
    samples = _curve_samples_np(segments)
    step = max(1, samples.shape[0] // N_ANCHORS)
    return np.asarray(samples[::step][:N_ANCHORS], np.float32)


def _letter_interval(anchors: np.ndarray, widen: float = INTERVAL_WIDEN):
    """``(interval, interval_cuda)`` of a letter: the lower bound is the plate
    clip ``max(box, slab)`` (the brush is ``max(signed, box, slab)``); the
    upper bound is ``max(min_a |p2 - a| - THICKNESS, 0) + widen`` over the
    anchors, clamped at 0 because inside the glyph the brush is ``-d``, and
    widened for the baked field.  ``interval.anchors`` keeps the anchors for
    a targeted fuzz."""
    anchors = [(f32(ax), f32(ay)) for ax, ay in np.asarray(anchors, np.float32)]
    widen = f32(widen)

    def interval(ia, ib, ic, ctx):
        x2, y2, z2 = (iv_mul_scalar(iv, 2.0) for iv in (ia, ib, ic))
        box = iv_sub(iv_max(iv_abs(x2), iv_max(iv_abs(y2), iv_abs(z2))), iv_const(1.25))
        slab = iv_sub(iv_abs(iv_sub(z2, iv_const(1.25))), iv_const(0.125))
        clip = iv_max(box, slab)
        d_hi = None
        for ax, ay in anchors:
            dx, dy = iv_sub(x2, iv_const(ax)), iv_sub(y2, iv_const(ay))
            hi = iv_sqrt(iv_add(iv_square(dx), iv_square(dy)))[1]
            d_hi = hi if d_hi is None else fmin(d_hi, hi)
        signed_hi = fadd(fmax(fsub(d_hi, THICKNESS), 0.0), widen)
        return (clip[0], fmax(signed_hi, clip[1]))

    def anchor_hi(ax, ay):
        return (f"iv_sqrt(iv_add(iv_square(iv_sub(x2, iv_const({f32_literal(ax)}))), "
                f"iv_square(iv_sub(y2, iv_const({f32_literal(ay)}))))).hi")

    q, e = f32_literal(1.25), f32_literal(0.125)
    lines = [
        "const Iv x2 = iv_mul_scalar(a, 2.0f), y2 = iv_mul_scalar(b, 2.0f), z2 = iv_mul_scalar(c, 2.0f);",
        f"const Iv clip = iv_max(iv_sub(iv_max(iv_abs(x2), iv_max(iv_abs(y2), iv_abs(z2))), iv_const({q})),",
        f"                       iv_sub(iv_abs(iv_sub(z2, iv_const({q}))), iv_const({e})));",
        f"float d_hi = {anchor_hi(*anchors[0])};",
    ]
    lines += [f"d_hi = fminf(d_hi, {anchor_hi(ax, ay)});" for ax, ay in anchors[1:]]
    lines += [
        f"const float signed_hi = add_rn(fmaxf(sub_rn(d_hi, {f32_literal(THICKNESS)}), 0.0f), "
        f"{f32_literal(widen)});",
        "return Iv{clip.lo, fmaxf(signed_hi, clip.hi)};",
    ]
    interval.anchors = np.asarray(anchors, np.float32)
    return interval, "\n    ".join(lines)


def _letter_component(c, letter: str, segments, bits, transform, index: int):
    curvedata = []
    for (a, b, cc) in segments:
        curvedata.extend([a[0], a[1], 0.0, b[0], b[1], 0.0, cc[0], cc[1], 0.0])
        curvedata.append(THICKNESS)
        curvedata.append(0.0)  # axesTag AXES_XY
    mask_start = c.add_arbitrary_data(f"LETTER_OFFS_{letter}", _pack_bits(bits))
    c.add_arbitrary_data(f"NUMCURVES_{letter}", [float(len(segments))])
    curve_start = c.add_arbitrary_data(f"CURVEDATA_{letter}", curvedata)
    table_name = f"logo_{index}_{letter}"
    planes_name = f"{table_name}_planes"
    table = _bake_letter_tables(segments, bits)
    interval, interval_cuda = _letter_interval(letter_anchors(segments))
    brush = c.define_brush(
        _make_letter_brush(curve_start, len(segments), mask_start),
        name=f"letter_{letter}",
        cuda=letter_cuda(planes_name),
        cuda_flops=LETTER_FLOPS,
        twin=_make_letter_twin(planes_name),
        twin_approx=TWIN_APPROX,
        extras={table_name: table},
        derived_extras={planes_name: letter_planes(table)},
        interval=interval,
        interval_cuda=interval_cuda,
    )
    return api.Component(brush, transform=transform, compiler=c)


def build(compiler=None, font_path: Optional[str] = None, letters: str = "CSG"):
    """Build Logo: one letter per cube face (designs/logo.py:615-634 of the
    JAX package).  The glyphs come from the committed data unless
    ``font_path`` names a font (read with fontTools)."""
    glyphs = load_glyphs(font_path, letters)
    c = api.new_design() if compiler is None else compiler
    eks = np.array([1.0, 0.0, 0.0])
    why = np.array([0.0, 1.0, 0.0])
    zee = np.array([0.0, 0.0, 1.0])
    frames = [
        Transform.axes(eks, why, -zee),
        Transform.axes(zee, why, eks),
        Transform.axes(zee, -eks, why),
    ]
    components = [
        _letter_component(c, letter, *glyphs[letter], frame, i)
        for i, (letter, frame) in enumerate(zip(letters, frames))
    ]
    api.drawUnion(*components, compiler=c)
    return c.commit()
