"""Mesh-export pipeline.

The reference's File->Export flow (DesignCSG.cpp:638-790): bounding-box
autodetect (dense 256^3 scan) -> surface extraction -> vertex projection
("gradient descent") -> STL + PLY, with a stage state machine.  Here the same
stages run as one function with a progress callback and per-slab resume
shards.

Strategies, as in the JAX package: ``"dense"`` (ops/marching_cubes.py:
every corner slab to the host), ``"active"`` (export/active.py: only the
blocks the surface crosses), ``"compact"`` (export/compact.py: cell cases and
edge parameters compacted on the device) and ``"adaptive"``
(export/adaptive.py: the reference's octree refinement as a level sweep).
``"auto"`` resolves exactly as the JAX package's (pipeline.py:283-294 there).

Every stage follows the evaluator's field (``BatchEvaluator.use_kernels``):
on the kernels' field the grid kernel (or, on the CPU, its plain version)
evaluates the autodetect scan and every extraction slab with coordinates made
on the device, and the point kernel refines the vertices; on the exact tape
(the CPU's default, and Logo's on the card) the plain tape evaluates the
points, as the JAX package does off the TPU.  The report's
``stats["sdf_field"]`` names the field, ``stats["twin_tolerance"]`` a baked
field's tolerance, and ``stats["native"]`` whether the native mesh ops
(native/meshops.cpp) or their numpy fallbacks assembled the mesh.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import native
from ..compiler import CompiledScene, ExportConfig
from ..evaluator import BatchEvaluator
from ..observability import StageTimer, span, to_device, to_host
from ..ops.marching_cubes import Mesh, extract_surface
from . import writers

STRATEGIES = ("dense", "active", "compact", "adaptive")


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


class SharedSlabStore:
    """The resume shards of a sharded export: the mesh's first rank alone
    reads and writes them and broadcasts what it read, so the ranks never
    race on a file and all resume the same slabs (and so join the same
    collectives)."""

    def __init__(self, directory: str, key: str, device_mesh):
        from ..parallel.mesh import mesh_rank

        self.device_mesh = device_mesh
        self.store = SlabStore(directory, key) if mesh_rank(device_mesh)[0] == 0 else None

    def load(self, z0: int) -> Optional[dict]:
        from ..parallel.mesh import broadcast_from_first

        found = self.store.load(z0) if self.store is not None else None
        return broadcast_from_first(found, self.device_mesh)

    def save(self, z0: int, **arrays) -> None:
        if self.store is not None:
            self.store.save(z0, **arrays)


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
    with span("evaluator.autodetect_bounding_box_device"):
        axis = lo32 + cell32 * torch.arange(res, dtype=torch.float32, device=device)
        big = to_device(np.float32(1e9), device)
        mins = np.zeros(3)
        maxs = np.zeros(3)
        for z0 in range(0, res, slab):
            sz = min(slab, res - z0)
            vals = evaluator.grid_eval(arrays, [lo32] * 3, cell32, float(z0), sz, res)
            zaxis = lo32 + cell32 * (torch.arange(sz, dtype=torch.float32, device=device)
                                     + float(z0))
            mask = vals < eps
            coords = (axis[None, None, :], axis[None, :, None], zaxis[:, None, None])
            m = torch.stack([torch.where(mask, c, big).amin() for c in coords])
            M = torch.stack([torch.where(mask, c, -big).amax() for c in coords])
            mins = np.minimum(mins, to_host(m).astype(np.float64))
            maxs = np.maximum(maxs, to_host(M).astype(np.float64))
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


def resolve_strategy(strategy: str, config: ExportConfig, resolution: int, slab: int) -> str:
    """``"auto"`` as the JAX package resolves it: the reference's export is
    always the adaptive octree (DesignCSG.cpp:717-758), so a coherent octree
    range (min < max <= grid level) means adaptive, else the uniform fast
    path: active when the slab divides the resolution, dense otherwise."""
    if strategy == "auto":
        if (
            config.minimum_octree_level < config.maximum_octree_level
            and config.maximum_octree_level <= config.grid_level
        ):
            strategy = "adaptive"
        else:
            strategy = "active" if resolution % slab == 0 else "dense"
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown export strategy {strategy!r}; choose auto or one of {STRATEGIES}")
    return strategy


def _extract_dense(evaluator, center, half, resolution, slab_cells, progress, slab_store, stats):
    """The dense strategy: every corner slab to the host.  On the kernels'
    field the grid kernel makes the lattice coordinates on the device and
    only corner values come back; on the exact tape the host builds the
    points."""
    corner_provider = None
    if evaluator.use_kernels:
        lo = np.asarray(np.asarray(center, np.float64) - half, np.float32)
        cell = np.float32(2.0 * half / resolution)

        def corner_provider(z0, sz):
            vals = evaluator.grid_eval(
                evaluator.device_arrays, lo, cell, np.float32(z0), sz + 1, resolution + 1
            )
            return to_host(vals)

    return extract_surface(evaluator.eval_sdf_at_points, center, half, resolution, midpoint=False,
                           slab_cells=slab_cells, progress=progress,
                           corner_provider=corner_provider, slab_store=slab_store, stats=stats)


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
    sharded: bool = False,
) -> tuple[Mesh, ExportReport]:
    """Run the full export: autodetect -> extract -> refine -> write.

    ``strategy`` is ``"dense"``, ``"active"``, ``"compact"``, ``"adaptive"``
    (consuming the octree levels, ``complex_surface_threshold`` and
    ``grid_level``; its lattice is then 2^maximum_octree_level, like the
    reference's leaves) or ``"auto"``, which resolves as in the JAX package
    (:func:`resolve_strategy`).  ``resume_dir`` persists each extraction
    slab (an octree level for adaptive; :class:`SlabStore`) and the
    pre-refinement mesh, keyed by the scene and configuration.  The
    evaluator's device (default ``cuda``) decides the dataflow.

    ``sharded`` runs the export over a device mesh of the world's ranks
    (parallel/mesh.py ``make_mesh``; a world of one without a process
    group): the evaluator's point evaluations shard their points
    (``BatchEvaluator(sharded=True)``), and ``active`` and ``compact`` shard
    each slab's z-rows.  Every rank computes the same mesh; only rank 0
    reads and writes ``resume_dir`` (broadcasting what it read) and writes
    the files.

    The export is an ``export.mesh`` span (observability.py) whose
    children are its stages (``export.bounding_box``, ``export.extract``,
    ``export.refine``, ``export.write``); the report's ``stage_seconds``
    holds their seconds.
    """
    with span("export.mesh"):
        config = export_config or scene.export_config or ExportConfig()
        resolution = 1 << config.grid_level
        slab = min(slab_cells, resolution)
        strategy = resolve_strategy(strategy, config, resolution, slab)
        evaluator = evaluator or BatchEvaluator(scene, device=device, sharded=sharded)
        device_mesh, first = None, True
        if sharded:
            from ..parallel.mesh import make_mesh, mesh_rank

            device_mesh = evaluator.mesh or make_mesh(device=evaluator.device)
            first = mesh_rank(device_mesh)[0] == 0
        timer = StageTimer()
        stats: dict = {"sdf_field": evaluator.sdf_field, "strategy": strategy,
                       "native": native.available()}
        if evaluator.twin_tolerance:
            stats["twin_tolerance"] = evaluator.twin_tolerance
        evals = 0

        def _tick(stage, frac):
            if progress is not None:
                progress(stage, frac)

        # A monitor (observability.ExportMonitor) reads the live telemetry.
        if hasattr(progress, "attach_stats"):
            progress.attach_stats(stats)

        with timer.stage("export.bounding_box"):
            if autodetect:
                _tick(ExportStage.ESTIMATING_BOUNDING_BOX.name, 0.0)
                detect = (autodetect_bounding_box_device if evaluator.use_kernels
                          else autodetect_bounding_box)
                center, half = detect(evaluator, config.bounding_box_half_diameter,
                                      autodetect_resolution)
                evals += autodetect_resolution**3
            else:
                center, half = np.zeros(3), config.bounding_box_half_diameter

        with timer.stage("export.extract"):
            _tick(ExportStage.EXTRACTING_SURFACE.name, 0.0)
            mesh, extract_evals = _extract(scene, config, evaluator, center, half, resolution,
                                           slab, slab_cells, strategy, resume_dir, device_mesh,
                                           first, _tick, stats)
            evals += extract_evals

        with timer.stage("export.refine"):
            _tick(ExportStage.REFINING_VERTICES.name, 0.0)
            evals_before = evaluator.sdf_eval_count
            refined = evaluator.refine_on_device(mesh.vertices,
                                                 steps=config.gradient_descent_steps)
            _tick(ExportStage.REFINING_VERTICES.name, 1.0)
            mesh = Mesh(vertices=refined, faces=mesh.faces)
            evals += evaluator.sdf_eval_count - evals_before

        with timer.stage("export.write"):
            _tick(ExportStage.WRITING_TRIANGLES.name, 0.0)
            if stl_path is not None and first:
                writers.write_stl(stl_path, mesh)
            if ply_path is not None and first:
                writers.write_ply(ply_path, mesh)
        _tick(ExportStage.FINISHED.name, 1.0)

        report = ExportReport(
            stage_seconds=timer.stages,
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


def _extract(scene, config, evaluator, center, half, resolution, slab, slab_cells, strategy,
             resume_dir, device_mesh, first, tick, stats):
    """The extract stage: the mesh before refinement, from the resume
    files where they hold it, and the field evaluations it ran."""
    evals = 0
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
        # Adaptive's lattice depends on the octree knobs.
        key.update(np.int64(config.minimum_octree_level).tobytes())
        key.update(np.int64(config.maximum_octree_level).tobytes())
        key.update(np.float64(config.complex_surface_threshold).tobytes())
        digest = key.hexdigest()[:16]
        cache_path = os.path.join(resume_dir, f"extract_{digest}.npz")
        # A sharded export's first rank alone reads and writes the resume
        # files, and every rank resumes from what it found.
        cached = None
        if first and os.path.exists(cache_path):
            with np.load(cache_path) as data:
                cached = (data["vertices"], data["faces"])
        if device_mesh is not None:
            from ..parallel.mesh import broadcast_from_first

            cached = broadcast_from_first(cached, device_mesh)
        if cached is not None:
            mesh = Mesh(vertices=cached[0], faces=cached[1])
        elif device_mesh is not None:
            slab_store = SharedSlabStore(resume_dir, digest, device_mesh)
        else:
            slab_store = SlabStore(resume_dir, digest)
        if not first:
            cache_path = None

    if mesh is None:
        extract_progress = lambda s, f: tick(ExportStage.EXTRACTING_SURFACE.name, f)  # noqa: E731
        evals_before = evaluator.sdf_eval_count
        if strategy == "adaptive":
            from .adaptive import extract_surface_adaptive

            mesh = extract_surface_adaptive(evaluator, center, half, config,
                                            progress=extract_progress, stats=stats,
                                            slab_store=slab_store)
            # Adaptive evaluates far fewer points than the dense formula
            # below: the report counts what the evaluator ran.
            evals += evaluator.sdf_eval_count - evals_before
        elif strategy in ("active", "compact"):
            from .active import extract_surface_active
            from .compact import extract_surface_compact

            extract = extract_surface_active if strategy == "active" else extract_surface_compact
            mesh = extract(evaluator, center, half, resolution, midpoint=False, slab_cells=slab,
                           progress=extract_progress, slab_store=slab_store, stats=stats,
                           device_mesh=device_mesh)
        else:
            mesh = _extract_dense(evaluator, center, half, resolution, slab_cells,
                                  extract_progress, slab_store, stats)
        if strategy != "adaptive":
            # The uniform strategies evaluate every corner plane once per
            # slab pass: (res+1)^2 corners x (res + res/slab) planes.
            evals += (resolution + 1) ** 2 * (resolution + -(-resolution // slab))
        if cache_path is not None:
            np.savez(cache_path, vertices=mesh.vertices, faces=mesh.faces)
    return mesh, evals
