"""Sampling of a baked rank-factored 2D field: the plain versions of K6.

Counterpart of the JAX package's ops/pallas/table.py ``packed_rank_sample``,
which samples, inside its Pallas kernels, a field stored as ``K`` pairs of
1D factor tables,

    b(x, y) ~= sum_k u_k(x) * v_k(y),

each factor linearly interpolated between its 128 entries (Logo's letters,
designs/logo.py).  That rank form exists for the TPU, whose kernels can
gather only within one vector register.  On Hopper a dense 2D gather is one
load, so the port's kernels sample the same function in its expanded form:
per cell four planes ``AA, AS, SA, SS`` (the products of the value and slope
tables, designs/logo.py ``letter_planes``) and

    b = (AA + fy*AS) + fx*(SA + fy*SS)

at the cell ``[r0, c0]``: csrc/table.cuh ``plane_sample``, inlined into every
kernel whose scene has such a brush.  :func:`plane_sample` is its plain
version, which the CPU runs and every kernel is held against;
:func:`packed_rank_sample` stays as the rank form's plain version, against
which the planes are held (and it against the JAX package's sampler).
"""

from __future__ import annotations

import torch

#: Columns of each factor table.
TABLE_WIDTH = 128
#: Grid coordinates are clipped to [0, GRID_MAX] so that the cell
#: ``[floor(g), floor(g) + 1]`` always lies in the table.
GRID_MAX = 126.999
#: Values per cell of the dense planes: AA, AS, SA, SS.
PLANES = 4


def _cells(gx: torch.Tensor, gy: torch.Tensor):
    """Clip to ``[0, GRID_MAX]``: the cell ``(c0, r0)`` (int64) and the
    fractions ``(fx, fy)``, all flattened."""
    gx = torch.clamp(gx, 0.0, GRID_MAX)
    gy = torch.clamp(gy, 0.0, GRID_MAX)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    return (x0.to(torch.int64).reshape(-1), y0.to(torch.int64).reshape(-1),
            fx.reshape(-1), fy.reshape(-1))


def packed_rank_sample(tbl: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """``sum_k (UA_k[c0] + fx*US_k[c0]) * (VA_k[r0] + fy*VS_k[r0])``.

    ``tbl`` is f32[4K, 128] packing four (K, 128) blocks: the x factors'
    values ``UA`` and forward-difference slopes ``US`` (``US[:, c] =
    UA[:, c+1] - UA[:, c]``), then the y factors' ``VA`` and ``VS``.  ``gx``
    and ``gy`` (any shape, the same) are continuous grid coordinates, clipped
    to ``[0, 126.999]``; ``c0, r0`` are their floors and ``fx, fy`` the
    fractions.  The sum runs ``acc = acc + uk*vk`` from 0 for k = 0..K-1 in
    that order, each product and sum rounded on its own: the arithmetic of
    table.py:124-135 in the JAX package and of the CUDA loop built without
    FMA contraction.  Differentiable in ``gx`` and ``gy`` (through the
    fractions: the slope term) under autograd and ``torch.func``."""
    k = tbl.shape[0] // 4
    if tbl.shape != (4 * k, TABLE_WIDTH):
        raise ValueError(f"table must be f32[4K, {TABLE_WIDTH}], got {tuple(tbl.shape)}")
    c0, r0, fx, fy = _cells(gx, gy)
    # Each block gathered at once: (K, N) factor values and slopes.
    uk = tbl[0:k][:, c0] + fx * tbl[k : 2 * k][:, c0]
    vk = tbl[2 * k : 3 * k][:, r0] + fy * tbl[3 * k : 4 * k][:, r0]
    terms = uk * vk
    acc = torch.zeros_like(fx)
    for i in range(k):
        acc = acc + terms[i]
    return acc.reshape(gx.shape)


def plane_sample(planes: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """``(AA + fy*AS) + fx*(SA + fy*SS)`` at the cell ``[r0, c0]``.

    ``planes`` is f32[128, 128, 4], rows ``r0`` (y cells) then columns ``c0``
    (x cells), each cell ``(AA, AS, SA, SS)``; the coordinates are clipped
    and split into cell and fractions as :func:`packed_rank_sample` splits
    them, and each product and sum is rounded on its own, in the order of
    csrc/table.cuh ``plane_sample``.  Differentiable in ``gx`` and ``gy``
    under autograd and ``torch.func``: along x the slope is ``SA + fy*SS``,
    the rank sum's ``sum_k US_k (VA_k + fy*VS_k)``."""
    if planes.shape != (TABLE_WIDTH, TABLE_WIDTH, PLANES):
        raise ValueError(f"planes must be f32[{TABLE_WIDTH}, {TABLE_WIDTH}, {PLANES}], "
                         f"got {tuple(planes.shape)}")
    c0, r0, fx, fy = _cells(gx, gy)
    v = planes.reshape(-1, PLANES)[r0 * TABLE_WIDTH + c0]
    b = (v[:, 0] + fy * v[:, 1]) + fx * (v[:, 2] + fy * v[:, 3])
    return b.reshape(gx.shape)
