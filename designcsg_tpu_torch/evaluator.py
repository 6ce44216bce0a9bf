"""Batch point evaluator — the k2 path.

Mirrors the reference's ``Evaluator`` (Evaluator.{h,cpp}): arbitrary-length
point arrays go through the SDF point-eval wrapper in chunks of
``chunk_size`` points, which bounds the device memory a call takes.  On the
card every evaluation is the CUDA point kernel (ops/cuda/sdf_kernel.py); with
``device="cpu"`` it is the plain PyTorch tape.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .compiler import CompiledScene, SceneArrays
from .ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from .ops.interpreter import make_normal_fn

# 2^20 points per chunk: 16 MB of points and results on the device, and
# ~7x that for the temporaries of the plain FD normal.
DEFAULT_CHUNK = 1 << 20

# An FD normal costs 6 tape evaluations (k2.cl:149-179).
NORMAL_EVAL_COST = 6


class BatchEvaluator:
    """Chunked SDF / normal evaluation at arbitrary world points.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain path.  ``sdf_field`` names the field the
    evaluations ride: "cuda-exact" (the CUDA kernels, exact tape) or
    "tape-exact" (the plain tape).
    """

    def __init__(
        self,
        scene: CompiledScene,
        arrays: Optional[SceneArrays] = None,
        chunk_size: int = DEFAULT_CHUNK,
        device=None,
    ):
        self.scene = scene
        self.device = resolve_device(device)
        self.chunk_size = int(chunk_size)
        self.use_kernels = self.device.type == "cuda"
        self.sdf_field = "cuda-exact" if self.use_kernels else "tape-exact"
        self.point_eval = make_point_eval(scene)
        self.grid_eval = make_grid_eval(scene)
        self._normal = make_normal_fn(self.point_eval)
        self.set_arrays(arrays if arrays is not None else scene.arrays)
        # Every point evaluated through this evaluator is counted; an FD
        # normal counts as NORMAL_EVAL_COST tape evaluations.
        self.sdf_eval_count = 0

    def set_arrays(self, arrays: SceneArrays):
        """Swap scene parameters (the reference's setArbitraryData path,
        Evaluator.cpp:213-225, generalized to all banks)."""
        self.arrays = arrays
        self.device_arrays = arrays.to_torch(self.device)

    def _run_chunked(self, fn, points, out_dim: int) -> np.ndarray:
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = pts.shape[0]
        out = np.empty((n,) if out_dim == 1 else (n, out_dim), dtype=np.float32)
        for start in range(0, n, self.chunk_size):
            chunk = torch.from_numpy(pts[start : start + self.chunk_size]).to(self.device)
            out[start : start + chunk.shape[0]] = fn(chunk, self.device_arrays).cpu().numpy()
        return out

    def eval_sdf_at_points(self, points) -> np.ndarray:
        """f32[N, 3] -> f32[N] (Evaluator.cpp:117-162 semantics)."""
        self.sdf_eval_count += len(points)
        return self._run_chunked(self.point_eval, points, 1)

    def eval_normal_at_points(self, points) -> np.ndarray:
        """f32[N, 3] -> f32[N, 3] (Evaluator.cpp:167-211 semantics)."""
        self.sdf_eval_count += NORMAL_EVAL_COST * len(points)
        return self._run_chunked(self._normal, points, 3)

    def refine_on_device(
        self, vertices: np.ndarray, steps: int, step_scale: float = 1.0
    ) -> np.ndarray:
        """The Newton-projection loop ``p <- p - n(p)*sdf(p)`` (the reference's
        "gradient descent", mesh.hpp:540-590), with the vertices kept on the
        device across steps: each step is one SDF evaluation and one FD
        normal (7 point evaluations), chunk by chunk."""
        v = np.asarray(vertices, dtype=np.float32)
        n = v.shape[0]
        self.sdf_eval_count += int(steps) * n * (1 + NORMAL_EVAL_COST)
        out = np.empty_like(v)
        for start in range(0, n, self.chunk_size):
            p = torch.from_numpy(v[start : start + self.chunk_size]).to(self.device)
            for _ in range(int(steps)):
                s = self.point_eval(p, self.device_arrays)
                nrm = self._normal(p, self.device_arrays)
                p = p - step_scale * nrm * s[:, None]
            out[start : start + p.shape[0]] = p.cpu().numpy()
        return out
