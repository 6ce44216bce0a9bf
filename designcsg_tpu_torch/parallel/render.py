"""Sharded rendering and point evaluation (designcsg_tpu/parallel/render.py
of the JAX package): SPMD over the ray and point axis.

Every rank of the mesh takes its block of image rows (or points), padded to
the mesh size as the JAX package pads (padding rows repeat the last real
row, padding points are zeros), runs the port's own renderer or evaluator on
it (``make_scene_renderer``'s route: the fused renderer kernel, K2, and in
the fast mode the cone prepass, K5, on the card; the plain routes on the
CPU), and ``all_gather``
assembles the blocks in rank order on every rank, the padding sliced off.
No collective runs during a march: rays are independent, and the gather is
the only communication of a frame.  Rows and points shard over all mesh
axes jointly (:func:`~.mesh.mesh_rank`), so the 1-D and the ("host", "chip")
meshes run one program.  Each ray and point gives the bits it gives in an
unsharded call: a world of one returns the unsharded frame exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..compiler import CompiledScene, SceneArrays
from ..config import RenderConfig
from ..ops.raymarch import make_scene_renderer
from .mesh import gather_rows, make_mesh, mesh_device, mesh_rank


def _block(total: int, mesh: DeviceMesh):
    """(this rank's first index, the block length ``per``): the mesh's
    blocks of ``ceil(total / n)`` cover ``total`` and overhang by the
    padding."""
    k, n = mesh_rank(mesh)
    per = -(-total // n)
    return k * per, per


def make_sharded_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None,
                          mesh: Optional[DeviceMesh] = None):
    """``render(arrays, campos, rgt, upp, fwd) -> f32[H, W, 3]`` with image
    rows sharded over the mesh, the whole frame on every rank.  Any mesh
    size works: rows pad to the mesh size, padding rows repeat the last
    real row (rendered once, copied), and the padding is sliced off after
    the gather, so a 480-row viewport renders on a 7-rank mesh too.
    ``arrays`` may be numpy banks; they go to the rank's device."""
    config = config or RenderConfig()
    mesh = mesh or make_mesh()
    device = mesh_device(mesh)
    height = config.height
    first, per = _block(height, mesh)
    # The block's frame rows, the padding clamped to the last row.
    rows = torch.clamp(torch.arange(first, first + per), max=height - 1)
    row0, n_real = int(rows[0]), int(rows[-1]) - int(rows[0]) + 1
    take = (rows - row0).to(device)
    render_rows = make_scene_renderer(scene, config, device)

    def render(arrays: SceneArrays, campos, rgt, upp, fwd):
        if not isinstance(arrays.ad, torch.Tensor) or arrays.ad.device != device:
            arrays = arrays.to_torch(device)
        block = render_rows(arrays, campos, rgt, upp, fwd, rows=(row0, n_real))
        return gather_rows(block[take], mesh)[:height]

    render.engine = render_rows.engine
    return render


def shard_pointwise(fn, mesh: Optional[DeviceMesh] = None):
    """Wrap a pointwise evaluator ``fn(points, arrays) -> values`` (or a
    tuple of value tensors, as K1's FD form returns) so that the leading
    point axis shards over the mesh: each rank evaluates its block of the
    points, padded with zero points to the mesh size, and every rank gets
    all values, the padding sliced off.  The points must lie on the rank's
    device."""
    mesh = mesh or make_mesh()

    def wrapped(points: torch.Tensor, arrays: SceneArrays):
        total = points.shape[0]
        first, per = _block(total, mesh)
        block = points[first : first + per]
        pad = per - block.shape[0]
        if pad:
            block = torch.cat([block, block.new_zeros((pad,) + tuple(points.shape[1:]))])
        out = fn(block, arrays)
        if isinstance(out, tuple):
            return tuple(gather_rows(o, mesh)[:total] for o in out)
        return gather_rows(out, mesh)[:total]

    wrapped.mesh = mesh
    return wrapped
