"""Batch point evaluator — the k2 path.

Mirrors the reference's ``Evaluator`` (Evaluator.{h,cpp}): arbitrary-length
point arrays go through an SDF point evaluation in chunks of ``chunk_size``
points, which bounds the device memory a call takes.  The evaluation is the
CUDA point kernel (ops/cuda/sdf_kernel.py, the twin field) or the exact plain
tape, by the JAX package's rule (evaluator.py:45-100 there): the kernels by
default on the card for a scene whose brushes and materials all have CUDA
bodies, the exact tape for a scene whose kernels compute an approximate twin
(Logo's baked letters), for a scene without CUDA bodies and on the CPU.

The lattice and cell-corner entry points (evaluator.py:237-557 of the JAX
package, under its names) take integer lattice indices, a host array or an
int32 tensor on the device, and make the points on the device as
``lo + cell * idx``: one float32 product, then one float32 sum, as the grid
kernel rounds its lattice.  Their values stay on the device: the corner
signs and the near-band flag are reduced there, and ``eval_surface_cells``
keeps there the cells that straddle the surface.  The point entry points
and the refine keep the reference's host arrays.  The JAX package's i16
up-link, chunk-tail buckets and asynchronous copy windows exist for its TPU
host link and are not carried over.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .compiler import CompiledScene, SceneArrays
from .observability import span, to_device, to_host
from .ops.cuda.brushes_kernel import supports_scene
from .ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from .ops.interpreter import make_normal_fn, make_primary_sdf, make_sdf_fd_normal

logger = logging.getLogger("designcsg_tpu_torch")

# 2^20 points per chunk: 16 MB of points and results on the device, and
# ~7x that for the temporaries of the plain FD normal.
DEFAULT_CHUNK = 1 << 20

# An FD normal costs 6 tape evaluations (k2.cl:149-179), an analytic one 1
# (evaluator.py:145-149 of the JAX package).
NORMAL_EVAL_COST = 6


def default_use_kernels(scene: CompiledScene, device: torch.device) -> bool:
    """The evaluator's engine rule (evaluator.py:45-67 of the JAX package):
    the kernels on the card for a scene whose kernels compute its exact
    field and whose brushes and materials all have CUDA bodies; the plain
    tape otherwise (logged when a scene lacks CUDA bodies on the card)."""
    if device.type != "cuda" or scene.twin_tolerance:
        return False
    if not supports_scene(scene):
        logger.warning("scene has brushes or materials without CUDA bodies; "
                       "evaluating the plain tape on %s", device)
        return False
    return True


class BatchEvaluator:
    """Chunked SDF / normal evaluation at arbitrary world points.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain path.  ``use_kernels`` picks the engine:
    the kernels' field (the CUDA point and grid kernels on the card, their
    plain versions on the CPU) or, when False, the exact plain tape on the
    device.  None (the default) takes the kernels on the card unless the
    scene declares an approximate twin (``CompiledScene.twin_tolerance``),
    whose default is the exact tape, as the reference's k2 is always exact,
    or uses a brush or material without a CUDA body
    (``brushes_kernel.supports_scene``), which the plain tape evaluates.

    ``gizmo`` evaluates the k1 field (the tape min-ed with the axis gizmo).
    ``normal_mode`` is "fd" (central differences) or "analytic" (autograd of
    the tape, ops/interpreter.py make_normal_fn) on the exact tape; the
    kernels' field keeps FD normals (K1's FD form), as the JAX package's
    Pallas evaluator builds FD whatever the mode (evaluator.py:106-118).

    ``sharded`` shards the point axis of every point, lattice and corner
    evaluation and of the refine over a device mesh of the world's ranks
    (parallel/render.py ``shard_pointwise`` over parallel/mesh.py
    ``make_mesh``, a world of one without a process group; evaluator.py:37,
    116-123 of the JAX package): each rank runs K1 (or its FD form, or the
    plain tape) on its block, and every rank gets all values.  ``mesh`` is
    that mesh, None unsharded; ``local_point_eval`` the unsharded point
    evaluation, for callers that shard on their own (active.py's slabs).

    ``sdf_field`` names the field the evaluations ride: "cuda-exact" or
    "cuda-baked" (the CUDA kernels on an exact or baked twin), "tape-exact"
    (the exact tape) or "tape-baked" (the kernels' plain versions on a baked
    twin); ``twin_tolerance`` is the baked field's declared tolerance, 0.0
    on an exact field.
    """

    def __init__(
        self,
        scene: CompiledScene,
        arrays: Optional[SceneArrays] = None,
        chunk_size: int = DEFAULT_CHUNK,
        device=None,
        use_kernels: Optional[bool] = None,
        gizmo: bool = False,
        normal_mode: str = "fd",
        sharded: bool = False,
    ):
        self.scene = scene
        self.device = resolve_device(device)
        self.chunk_size = int(chunk_size)
        self.gizmo = bool(gizmo)
        if use_kernels is None:
            use_kernels = default_use_kernels(scene, self.device)
        self.use_kernels = bool(use_kernels)
        baked = self.use_kernels and bool(scene.twin_tolerance)
        self.twin_tolerance = scene.twin_tolerance if baked else 0.0
        engine = "cuda" if self.use_kernels and self.device.type == "cuda" else "tape"
        self.sdf_field = f"{engine}-{'baked' if baked else 'exact'}"
        self.grid_eval = make_grid_eval(scene, gizmo=self.gizmo)
        # The exact tape on the card is plain PyTorch (the JAX package
        # evaluates it in XLA, outside any Pallas kernel).
        self.point_eval = (
            make_point_eval(scene, gizmo=self.gizmo) if self.use_kernels
            else make_primary_sdf(scene, gizmo=self.gizmo)
        )
        normal = make_normal_fn(self.point_eval, mode=normal_mode)
        # The SDF and its FD normal: on the kernels' field one launch of K1's
        # FD form per chunk (ops/cuda/sdf_kernel.py), on the tape one call at
        # the seven points that launch reads, else the composition.
        point_eval = self.local_point_eval = self.point_eval
        if self.use_kernels:
            self._sdf_normal = point_eval.fd
        elif normal_mode == "fd":
            self._sdf_normal = make_sdf_fd_normal(point_eval)
        else:
            self._sdf_normal = lambda points, arrays: (point_eval(points, arrays),
                                                       normal(points, arrays))
        self._normal = normal
        self.mesh = None
        if sharded:
            from .parallel.mesh import make_mesh
            from .parallel.render import shard_pointwise

            self.mesh = make_mesh(device=self.device)
            self.point_eval = shard_pointwise(point_eval, self.mesh)
            self._sdf_normal = shard_pointwise(self._sdf_normal, self.mesh)
            self._normal = shard_pointwise(normal, self.mesh)
        if self.use_kernels:
            self._normal = lambda points, arrays: self._sdf_normal(points, arrays)[1]
        self.set_arrays(arrays if arrays is not None else scene.arrays)
        # Every point evaluated through this evaluator is counted; an FD
        # normal counts as NORMAL_EVAL_COST tape evaluations, an analytic
        # one as 1.
        self.sdf_eval_count = 0
        self.normal_eval_cost = (
            NORMAL_EVAL_COST if self.use_kernels or normal_mode == "fd" else 1)

    def set_arrays(self, arrays: SceneArrays):
        """Swap scene parameters (the reference's setArbitraryData path,
        Evaluator.cpp:213-225, generalized to all banks)."""
        self.arrays = arrays
        self.device_arrays = SceneArrays(*(to_device(a, self.device) for a in arrays.fields()))

    def _run_chunked(self, fn, points, out_dim: int) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = pts.shape[0]
        out = np.empty((n,) if out_dim == 1 else (n, out_dim), dtype=np.float32)
        for start in range(0, n, self.chunk_size):
            chunk = to_device(pts[start : start + self.chunk_size], self.device)
            out[start : start + chunk.shape[0]] = to_host(fn(chunk, self.device_arrays))
        return out

    def eval_sdf_at_points(self, points) -> np.ndarray:
        """f32[N, 3] -> f32[N] (Evaluator.cpp:117-162 semantics)."""
        with span("evaluator.eval_sdf_at_points"):
            self.sdf_eval_count += len(points)
            return self._run_chunked(self.point_eval, points, 1)

    def eval_normal_at_points(self, points) -> np.ndarray:
        """f32[N, 3] -> f32[N, 3] (Evaluator.cpp:167-211 semantics)."""
        with span("evaluator.eval_normal_at_points"):
            self.sdf_eval_count += self.normal_eval_cost * len(points)
            return self._run_chunked(self._normal, points, 3)

    # -- lattice and cell-corner entry points ------------------------------

    def _run_lattice(self, fn, cells, offsets, lo, cellsize, per_cell=()) -> torch.Tensor:
        """``fn`` at ``lo + cellsize * (cells[n] + offsets[k])`` (K = 1
        without offsets), chunk by chunk, each chunk's values reshaped to
        ``per_cell`` a cell and left on the device: ``[N, *per_cell]``.
        Chunks of ``chunk_size`` points at most split cells, never a cell's
        offsets.  ``cells`` is a host array, whose chunks go up as int32, or
        an int32 tensor on the device, which is sliced in place."""
        if not isinstance(cells, torch.Tensor):
            cells = np.asarray(cells).reshape(-1, 3)
        k = 1 if offsets is None else len(offsets)
        lo32 = to_device(np.asarray(lo, np.float32).reshape(1, 3), self.device)
        cell32 = to_device(np.float32(cellsize), self.device)
        if offsets is not None:
            offs = to_device(np.asarray(offsets, np.float32).reshape(1, k, 3), self.device)
        per = max(1, self.chunk_size // k)
        out = []
        for start in range(0, cells.shape[0], per):
            idx = cells[start : start + per]
            if not isinstance(idx, torch.Tensor):
                idx = to_device(idx.astype(np.int32), self.device)
            f = idx.to(torch.float32)
            if offsets is not None:
                f = (f[:, None, :] + offs).reshape(-1, 3)
            values = fn(lo32 + cell32 * f, self.device_arrays)
            out.append(values.reshape((idx.shape[0],) + tuple(per_cell)))
        if not out:
            return torch.empty((0,) + tuple(per_cell), device=self.device)
        return out[0] if len(out) == 1 else torch.cat(out)

    def eval_sdf_at_lattice(self, idx, lo, cellsize) -> torch.Tensor:
        """f32[N]: SDF at ``lo + cellsize * idx`` for integer lattice
        ``idx[N, 3]``."""
        with span("evaluator.eval_sdf_at_lattice"):
            self.sdf_eval_count += len(idx)
            return self._run_lattice(self.point_eval, idx, None, lo, cellsize)

    def eval_normal_at_lattice(self, idx, lo, cellsize) -> torch.Tensor:
        """f32[N, 3]: normals at ``lo + cellsize * idx``."""
        with span("evaluator.eval_normal_at_lattice"):
            self.sdf_eval_count += self.normal_eval_cost * len(idx)
            return self._run_lattice(self._normal, idx, None, lo, cellsize, (3,))

    def eval_sdf_at_cell_corners(self, cells, lo, cellsize, offsets) -> torch.Tensor:
        """f32[N, K]: SDF at ``lo + cellsize * (cells[n] + offsets[k])``."""
        with span("evaluator.eval_sdf_at_cell_corners"):
            self.sdf_eval_count += len(offsets) * len(cells)
            return self._run_lattice(self.point_eval, cells, offsets, lo, cellsize,
                                     (len(offsets),))

    def eval_normal_at_cell_corners(self, cells, lo, cellsize, offsets) -> torch.Tensor:
        """f32[N, K, 3]: normals at the cells' ``offsets``."""
        with span("evaluator.eval_normal_at_cell_corners"):
            self.sdf_eval_count += self.normal_eval_cost * len(offsets) * len(cells)
            return self._run_lattice(self._normal, cells, offsets, lo, cellsize,
                                     (len(offsets), 3))

    def eval_corner_signs_near(self, cells, lo, cellsize, offsets, near_bound: float):
        """(signs u8[N], near bool[N]) for the K <= 8 corner offsets: bit k of
        ``signs[n]`` is set iff the SDF at ``lo + cellsize * (cells[n] +
        offsets[k])`` is < 0, and ``near[n]`` iff min_k |sdf| <= near_bound,
        compared in float32 on every path (the JAX package's host path
        compares against a float64 bound, its device path a float32 one:
        ROADMAP F3).  Marching cubes consumes exactly this (corner signs pick
        the table case, the near band drives the octree descent,
        mesh.hpp:176-183).  Each chunk's values are reduced as they come,
        so no corner value outlives its chunk."""
        k = len(offsets)
        if k > 8:
            raise ValueError(f"sign packing needs K <= 8, got {k}")

        def signs_near(points, arrays):
            v = self.point_eval(points, arrays).reshape(-1, k)
            signs = ((v < 0.0).to(torch.int32) * weights).sum(1)
            return torch.stack([signs, v.abs().amin(1) <= bound], 1).to(torch.uint8)

        with span("evaluator.eval_corner_signs_near"):
            self.sdf_eval_count += k * len(cells)
            bound = to_device(np.float32(near_bound), self.device)
            weights = to_device(np.array([1 << i for i in range(k)], np.int32), self.device)
            packed = self._run_lattice(signs_near, cells, offsets, lo, cellsize, (2,))
            return packed[:, 0].to(torch.uint8), packed[:, 1].bool()

    def eval_surface_cells(self, cells: torch.Tensor, lo, cellsize, offsets, near_bound: float):
        """:meth:`eval_corner_signs_near` for int32 ``cells[N, 3]`` on the
        device, keeping only the cells whose corner signs straddle the
        surface (some but not all of the K bits set): ``(rows i64[S],
        surface cells i32[S, 3], signs u8[S], near bool[N])``, ``rows``
        their ascending positions in ``cells``."""
        with span("evaluator.eval_surface_cells"):
            signs, near = self.eval_corner_signs_near(cells, lo, cellsize, offsets, near_bound)
            rows = torch.nonzero((signs != 0) & (signs != (1 << len(offsets)) - 1)).reshape(-1)
            return rows, cells[rows], signs[rows], near

    def refine_on_device(
        self, vertices: np.ndarray, steps: int, step_scale: float = 1.0
    ) -> np.ndarray:
        """The Newton-projection loop ``p <- p - n(p)*sdf(p)`` (the reference's
        "gradient descent", mesh.hpp:540-590), with the vertices kept on the
        device across steps: each step is one SDF evaluation and one normal
        (7 point evaluations with FD normals: on the kernels' field one
        launch of K1's FD form, on the tape one call at the seven points),
        chunk by chunk."""
        with span("evaluator.refine_on_device"):
            v = np.asarray(vertices, dtype=np.float32)
            n = v.shape[0]
            self.sdf_eval_count += int(steps) * n * (1 + self.normal_eval_cost)
            out = np.empty_like(v)
            for start in range(0, n, self.chunk_size):
                p = to_device(v[start : start + self.chunk_size], self.device)
                for _ in range(int(steps)):
                    s, nrm = self._sdf_normal(p, self.device_arrays)
                    p = p - step_scale * nrm * s[:, None]
                out[start : start + p.shape[0]] = to_host(p)
            return out
