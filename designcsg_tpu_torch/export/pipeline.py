"""Mesh-export pipeline.

The reference's File->Export flow (DesignCSG.cpp:638-790): bounding-box
autodetect (dense 256^3 scan) -> surface extraction -> vertex projection
("gradient descent") -> STL + PLY, with a stage state machine.  Here the same
stages run as one function with a progress callback and per-slab resume
shards.

Ported so far: the ``"dense"`` strategy.  On the card the grid kernel
evaluates the autodetect scan and every extraction slab with coordinates made
on the device, and the point kernel refines the vertices; with
``device="cpu"`` the plain tape evaluates host-built points, as the JAX
package does off the TPU.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..compiler import CompiledScene, ExportConfig
from ..evaluator import BatchEvaluator
from ..ops.marching_cubes import Mesh, extract_surface
from . import writers

#: Strategies of the JAX package that this package does not have yet.
UNPORTED_STRATEGIES = ("active", "compact", "adaptive")


class ExportStage(enum.Enum):
    """Mirrors the reference's ExportProcessState (DesignCSG.cpp:603-614)."""

    NOT_RUNNING = enum.auto()
    ESTIMATING_BOUNDING_BOX = enum.auto()
    EXTRACTING_SURFACE = enum.auto()
    REFINING_VERTICES = enum.auto()
    WRITING_TRIANGLES = enum.auto()
    FINISHED = enum.auto()


@dataclasses.dataclass
class ExportReport:
    stage_seconds: dict
    bounding_box_center: np.ndarray
    bounding_box_half_diameter: float
    num_vertices: int
    num_triangles: int
    sdf_evals: int
    stl_path: Optional[str] = None
    ply_path: Optional[str] = None
    # Per-slab triangle counts (the analog of the reference's per-level
    # histogram, DesignCSG.cpp:896-924) and the SDF field the export rode.
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return sum(self.stage_seconds.values())


class SlabStore:
    """Per-slab resume shards: each completed extraction slab persists as an
    atomic ``.npz`` under ``directory`` keyed by (scene/config hash, z0); a
    re-run after a crash evaluates only the missing slabs.  The reference
    loses the whole export on any crash (DesignCSG.cpp:638-790)."""

    def __init__(self, directory: str, key: str):
        self.directory = directory
        self.key = key
        os.makedirs(directory, exist_ok=True)

    def _path(self, z0: int) -> str:
        return os.path.join(self.directory, f"slab_{self.key}_{z0:06d}.npz")

    def load(self, z0: int) -> Optional[dict]:
        path = self._path(z0)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as data:
                return {k: data[k] for k in data.files}
        except (OSError, ValueError, EOFError):
            return None  # truncated/corrupt shard from a crash mid-write

    def save(self, z0: int, **arrays) -> None:
        path = self._path(z0)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)


def _scan_lattice(half_diameter: float, resolution: int):
    """The reference's autodetect lattice: it spans +-half_diameter/2 (the
    half-diameter is treated as a diameter), offset by -cell/2; keeps points
    with sdf < cell (DesignCSG.cpp:666-712)."""
    cell = half_diameter / resolution
    lo = -cell / 2.0 - (resolution // 2) * cell
    return lo, cell


def autodetect_bounding_box_device(
    evaluator: BatchEvaluator, half_diameter: float, resolution: int = 256
) -> tuple[np.ndarray, float]:
    """Autodetect on the device: the grid kernel evaluates the scan lattice
    slab by slab and masked min/max reductions run beside it, so only 6
    floats per slab reach the host.  Same quirks as
    :func:`autodetect_bounding_box`; the min/max accumulators start at 0, so
    the box always contains the origin."""
    res = int(resolution)
    lo, cell = _scan_lattice(half_diameter, res)
    eps = cell
    slab = max(1, min(64, res))
    lo32, cell32 = float(np.float32(lo)), float(np.float32(cell))
    arrays = evaluator.device_arrays
    device = arrays.ad.device
    axis = lo32 + cell32 * torch.arange(res, dtype=torch.float32, device=device)
    big = torch.tensor(1e9, dtype=torch.float32, device=device)
    mins = np.zeros(3)
    maxs = np.zeros(3)
    for z0 in range(0, res, slab):
        sz = min(slab, res - z0)
        vals = evaluator.grid_eval(arrays, [lo32] * 3, cell32, float(z0), sz, res)
        zaxis = lo32 + cell32 * (torch.arange(sz, dtype=torch.float32, device=device) + float(z0))
        mask = vals < eps
        coords = (axis[None, None, :], axis[None, :, None], zaxis[:, None, None])
        m = torch.stack([torch.where(mask, c, big).amin() for c in coords])
        M = torch.stack([torch.where(mask, c, -big).amax() for c in coords])
        mins = np.minimum(mins, m.cpu().numpy().astype(np.float64))
        maxs = np.maximum(maxs, M.cpu().numpy().astype(np.float64))
    center = (mins + maxs) / 2.0
    return center, float((maxs - mins).max()) / 2.0


def autodetect_bounding_box(
    evaluator: BatchEvaluator, half_diameter: float, resolution: int = 256
) -> tuple[np.ndarray, float]:
    """Autodetect through host points: a dense scan of the configured volume
    keeps points with sdf < diameter/resolution and cubifies their AABB
    (DesignCSG.cpp:666-712), with the quirks of :func:`_scan_lattice`."""
    cell = half_diameter / resolution
    idx = np.arange(-resolution // 2, resolution // 2, dtype=np.float64)
    coords = -cell / 2.0 + idx * cell
    eps = cell  # BB_EPSILON (DesignCSG.cpp:670)

    mins = np.zeros(3)
    maxs = np.zeros(3)
    slab = max(1, (1 << 22) // (resolution * resolution))
    for z0 in range(0, resolution, slab):
        g = np.meshgrid(coords, coords, coords[z0 : z0 + slab], indexing="ij")
        pts = np.stack([g[0].ravel(), g[1].ravel(), g[2].ravel()], axis=-1)
        interior = pts[evaluator.eval_sdf_at_points(pts) < eps]
        if interior.size:
            mins = np.minimum(mins, interior.min(axis=0))
            maxs = np.maximum(maxs, interior.max(axis=0))
    center = (mins + maxs) / 2.0
    return center, float((maxs - mins).max()) / 2.0


def _resolve_strategy(strategy: str, config: ExportConfig, resolution: int, slab: int) -> str:
    if strategy == "auto":
        # The reference's export is always the adaptive octree
        # (DesignCSG.cpp:717-758): a coherent octree range means adaptive,
        # else the uniform fast path (pipeline.py:283-294 of the JAX package).
        if (
            config.minimum_octree_level < config.maximum_octree_level
            and config.maximum_octree_level <= config.grid_level
        ):
            strategy = "adaptive"
        else:
            strategy = "active" if resolution % slab == 0 else "dense"
    if strategy in UNPORTED_STRATEGIES:
        raise NotImplementedError(
            f"export strategy {strategy!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 8); pass strategy='dense'"
        )
    if strategy != "dense":
        raise ValueError(f"unknown export strategy {strategy!r}")
    return strategy


def export_mesh(
    scene: CompiledScene,
    export_config: Optional[ExportConfig] = None,
    stl_path: Optional[str] = None,
    ply_path: Optional[str] = None,
    evaluator: Optional[BatchEvaluator] = None,
    progress: Optional[Callable[[str, float], None]] = None,
    resume_dir: Optional[str] = None,
    autodetect: bool = True,
    autodetect_resolution: int = 256,
    slab_cells: int = 32,
    strategy: str = "auto",
    device=None,
) -> tuple[Mesh, ExportReport]:
    """Run the full export: autodetect -> extract -> refine -> write.

    ``strategy="auto"`` resolves as in the JAX package; only ``"dense"`` is
    ported, and any other strategy raises (nothing switches silently).
    ``resume_dir`` persists each extraction slab (:class:`SlabStore`) and the
    pre-refinement mesh, keyed by the scene and configuration.
    The evaluator's device (default ``cuda``) decides the dataflow.
    """
    config = export_config or scene.export_config or ExportConfig()
    resolution = 1 << config.grid_level
    slab = min(slab_cells, resolution)
    strategy = _resolve_strategy(strategy, config, resolution, slab)
    evaluator = evaluator or BatchEvaluator(scene, device=device)
    stage_seconds: dict = {}
    stats: dict = {"sdf_field": evaluator.sdf_field}
    evals = 0

    def _tick(stage, frac):
        if progress is not None:
            progress(stage, frac)

    t0 = time.time()
    if autodetect:
        _tick(ExportStage.ESTIMATING_BOUNDING_BOX.name, 0.0)
        detect = (
            autodetect_bounding_box_device if evaluator.use_kernels else autodetect_bounding_box
        )
        center, half = detect(evaluator, config.bounding_box_half_diameter, autodetect_resolution)
        evals += autodetect_resolution**3
    else:
        center, half = np.zeros(3), config.bounding_box_half_diameter
    stage_seconds["bounding_box"] = time.time() - t0

    t0 = time.time()
    _tick(ExportStage.EXTRACTING_SURFACE.name, 0.0)
    cache_path = None
    slab_store = None
    mesh = None
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
        key = hashlib.sha256()
        key.update(scene.arrays.content_digest())
        key.update(np.asarray(center).tobytes())
        key.update(np.float64(half).tobytes())
        key.update(np.int64(resolution).tobytes())
        key.update(strategy.encode())
        key.update(np.int64(slab).tobytes())
        digest = key.hexdigest()[:16]
        cache_path = os.path.join(resume_dir, f"extract_{digest}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as data:
                mesh = Mesh(vertices=data["vertices"], faces=data["faces"])
        else:
            slab_store = SlabStore(resume_dir, digest)

    if mesh is None:
        corner_provider = None
        if evaluator.use_kernels:
            # The grid kernel makes the lattice coordinates on the device;
            # only corner values come back to the host.
            lo = np.asarray(np.asarray(center, np.float64) - half, np.float32)
            cell = np.float32(2.0 * half / resolution)

            def corner_provider(z0, sz):
                vals = evaluator.grid_eval(
                    evaluator.device_arrays, lo, cell, np.float32(z0), sz + 1, resolution + 1
                )
                return vals.cpu().numpy()

        mesh = extract_surface(
            evaluator.eval_sdf_at_points,
            center,
            half,
            resolution,
            midpoint=False,
            slab_cells=slab_cells,
            progress=lambda s, f: _tick(ExportStage.EXTRACTING_SURFACE.name, f),
            corner_provider=corner_provider,
            slab_store=slab_store,
            stats=stats,
        )
        # Every corner plane is evaluated once per slab pass:
        # (res+1)^2 corners x (res + res/slab) planes.
        evals += (resolution + 1) ** 2 * (resolution + -(-resolution // slab))
        if cache_path is not None:
            np.savez(cache_path, vertices=mesh.vertices, faces=mesh.faces)
    stage_seconds["extract"] = time.time() - t0

    t0 = time.time()
    _tick(ExportStage.REFINING_VERTICES.name, 0.0)
    evals_before = evaluator.sdf_eval_count
    refined = evaluator.refine_on_device(mesh.vertices, steps=config.gradient_descent_steps)
    _tick(ExportStage.REFINING_VERTICES.name, 1.0)
    mesh = Mesh(vertices=refined, faces=mesh.faces)
    evals += evaluator.sdf_eval_count - evals_before
    stage_seconds["refine"] = time.time() - t0

    t0 = time.time()
    _tick(ExportStage.WRITING_TRIANGLES.name, 0.0)
    if stl_path is not None:
        writers.write_stl(stl_path, mesh)
    if ply_path is not None:
        writers.write_ply(ply_path, mesh)
    stage_seconds["write"] = time.time() - t0
    _tick(ExportStage.FINISHED.name, 1.0)

    report = ExportReport(
        stage_seconds=stage_seconds,
        bounding_box_center=center,
        bounding_box_half_diameter=half,
        num_vertices=mesh.num_vertices,
        num_triangles=mesh.num_faces,
        sdf_evals=evals,
        stl_path=stl_path,
        ply_path=ply_path,
        stats=stats,
    )
    return mesh, report
