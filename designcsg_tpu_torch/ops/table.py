"""Sampling of a baked rank-factored 2D field: the plain version of K6.

Counterpart of the JAX package's ops/pallas/table.py ``packed_rank_sample``,
which samples, inside its Pallas kernels, a field stored as ``K`` pairs of
1D factor tables,

    b(x, y) ~= sum_k u_k(x) * v_k(y),

each factor linearly interpolated between its 128 entries (Logo's letters,
designs/logo.py).  On the card the same arithmetic is csrc/table.cuh
``rank_sample``, inlined into every kernel whose scene has such a brush; this
module is its plain PyTorch version, which the CPU runs and every kernel is
held against.
"""

from __future__ import annotations

import torch

#: Columns of each factor table.
TABLE_WIDTH = 128
#: Grid coordinates are clipped to [0, GRID_MAX] so that the cell
#: ``[floor(g), floor(g) + 1]`` always lies in the table.
GRID_MAX = 126.999


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
    gx = torch.clamp(gx, 0.0, GRID_MAX)
    gy = torch.clamp(gy, 0.0, GRID_MAX)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0
    c0 = x0.to(torch.int64).reshape(-1)
    r0 = y0.to(torch.int64).reshape(-1)
    fx, fy = fx.reshape(-1), fy.reshape(-1)
    # Each block gathered at once: (K, N) factor values and slopes.
    uk = tbl[0:k][:, c0] + fx * tbl[k : 2 * k][:, c0]
    vk = tbl[2 * k : 3 * k][:, r0] + fy * tbl[3 * k : 4 * k][:, r0]
    terms = uk * vk
    acc = torch.zeros_like(fx)
    for i in range(k):
        acc = acc + terms[i]
    return acc.reshape(gx.shape)
