"""The port's benchmark: the cells of the JAX package's root ``bench.py``,
in its order and at its sizes, through the port's entry points.

    python -m designcsg_tpu_torch.cli bench
    python -m designcsg_tpu_torch.bench [--device cpu]

Each cell prints bench.py's label on stderr (the same words, so that the two
logs read line by line against each other), and the last line of stdout is
one JSON object with bench.py's keys: the headline ``metric`` (Design1's
640x480 viewport in rays/s, in the faster of the over-relaxed and the
hierarchical + over-relaxed modes, the mode in its name), ``value``,
``unit``, ``vs_baseline`` (against 640x480 at 30 FPS), ``baseline_note``
and ``exact_k1_rays_per_s``.

Timing is the host clock, as in bench.py, so the Python of a frame or a
fit step counts as a user feels it.  Each cell makes one warm call (it
builds or loads the kernels' units and fills the banks; its seconds are
returned apart), then ``TRIALS`` trials, each ``reps`` calls back to back
between two synchronizations of the device; it reports the best trial's
seconds divided by ``reps``.
(bench.py chains its frames inside one jitted loop and fetches a scalar,
because its TPU link could not be trusted to block.)  A scene that does
not render on the card's kernels takes the plain route, timed as bench.py
times its non-kernel route: the best of ``reps`` single frames.

No cell catches its own failure: on the card every cell runs the port's
kernels, so a cell that fails raises and the command exits non-zero.

Each cell is one function taking the scene, its configuration and its
repetitions; :func:`main` calls them at bench.py's sizes.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from . import resolve_device
from .camera import Camera
from .compiler import ExportConfig
from .config import RenderConfig

TRIALS = 3
FRAME_REPS = 20
# (design, fit_field, steps a trial), bench.py:294-301.
FIT_CELLS = (("design1", "exact", 10), ("logo", "exact", 5), ("logo", "twin", 10))
# The dense grid: 8 slabs of 64 x 512 x 512 over [-4, 4]^3 (bench.py:346-366).
GRID_SIZE, GRID_SLABS, GRID_HALF = 512, 8, 4.0

OVERRELAX = RenderConfig(march_overrelax=1.6)
HIERARCHICAL = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
EXACT = RenderConfig()
# Design1's export: 512^3 active, 50 refine steps (bench.py:202-206).
D1_EXPORT = ExportConfig(bounding_box_half_diameter=10.0, grid_level=9, gradient_descent_steps=50)
# Logo's export: plates at world radius ~3.1, the adaptive octree 5 -> 7 at
# grid level 7, 50 refine steps (bench.py:256-262).
LOGO_EXPORT = ExportConfig(bounding_box_half_diameter=3.5, grid_level=7, minimum_octree_level=5,
                           maximum_octree_level=7, gradient_descent_steps=50)

BASELINE_RAYS_PER_S = 640 * 480 * 30.0  # the reference's viewport at 30 FPS
BASELINE_NOTE = (
    "reference publishes no numbers; vs_baseline ASSUMES its "
    "640x480 viewport free-runs at 30 FPS (9.2 Mrays/s) on "
    "the recommended GTX/RTX-class GPU (BASELINE.md)"
)


def fit_config(field: str) -> RenderConfig:
    """The fit cells' render config (bench.py:303-308): 640x480 geometric
    loss, no gizmo, the gradient reattached on ``field``."""
    return RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False,
                        fit_field=field)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timing(NamedTuple):
    seconds: float  # a call: the best trial's seconds over its calls
    warm_seconds: float  # the warm call, alone (builds, loads, first use)
    first: Any  # the warm call's value
    best: Any  # the best trial's last value


def time_calls(call, reps: int, device: torch.device, reset=None, trials=None) -> Timing:
    """One warm call, then ``trials`` (default ``TRIALS``) trials of ``reps``
    calls back to back between two synchronizations, each trial and the
    warm call after ``reset()``."""
    if reset:
        reset()
    sync(device)
    t0 = time.perf_counter()
    first = call()
    sync(device)
    warm = time.perf_counter() - t0
    best, best_value = math.inf, first
    for _ in range(TRIALS if trials is None else trials):
        if reset:
            reset()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            value = call()
        sync(device)
        seconds = time.perf_counter() - t0
        if seconds < best:
            best, best_value = seconds, value
    return Timing(best / reps, warm, first, best_value)


def render_cell(scene, config: RenderConfig, reps: int, device, camera=None) -> dict:
    """One viewport frame through ``make_scene_renderer``: ``seconds`` a
    frame, ``rays_per_s``, the route's ``engine`` and the warm ``frame``.
    The kernels' route is timed back to back; the plain route by the best
    of ``reps`` single frames (bench.py:142-160)."""
    from .ops.raymarch import make_scene_renderer

    device = resolve_device(device)
    render = make_scene_renderer(scene, config, device)
    arrays = scene.arrays.to_torch(device)
    cam = (camera or Camera.initial()).as_arrays()
    call = lambda: render(arrays, *cam)  # noqa: E731
    if render.engine == "cuda":
        timing = time_calls(call, reps, device)
    else:
        timing = time_calls(call, 1, device, trials=reps)
    return dict(seconds=timing.seconds, warm_seconds=timing.warm_seconds,
                rays_per_s=config.width * config.height / timing.seconds,
                engine=render.engine, frame=timing.first)


def export_cell(scene, config, reps: int, device, **kwargs) -> dict:
    """One ``export_mesh`` (to an STL in a temporary directory) with
    ``kwargs`` (strategy, evaluator, autodetect): ``seconds`` an export,
    and the ``mesh`` and ``report`` of the best trial's last export."""
    from .export.pipeline import export_mesh

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        call = lambda: export_mesh(scene, config, stl_path=os.path.join(tmp, "mesh.stl"),  # noqa: E731
                                   device=device, **kwargs)
        timing = time_calls(call, reps, device)
    mesh, report = timing.best
    return dict(seconds=timing.seconds, warm_seconds=timing.warm_seconds, mesh=mesh, report=report)


def fit_cell(scene, config: RenderConfig, reps: int, device) -> dict:
    """Fit steps (forward, backward and Adam at 1e-2) from bench.py's start,
    every position but the first moved by 0.05 in x, against the design's
    own target: ``seconds`` a step; the first step's ``loss`` and position
    ``grad``.  Each trial starts again from the start."""
    from .parallel.fit import adam, make_fit_harness

    device = resolve_device(device)
    cam = Camera.initial().as_arrays()
    harness = make_fit_harness(scene, config, optimizer=adam(1e-2), use_mesh=False, device=device)
    target = harness.render_target(scene.arrays, *cam)
    start = np.asarray(scene.arrays.position).copy()
    start[1:, 0] += 0.05
    state = []

    def reset():
        state[:] = [harness.init({"position": start})]

    def step():
        state[0], loss = harness.step_fn(state[0], target, *cam)
        return loss, state[0].params["position"].grad

    timing = time_calls(step, reps, device, reset)
    loss, grad = timing.first
    return dict(seconds=timing.seconds, warm_seconds=timing.warm_seconds, loss=float(loss),
                grad=grad.detach().cpu().numpy())


def grid_cell(scene, size: int, slabs: int, device) -> dict:
    """The dense SDF lattice of ``size``^3 points over [-4, 4]^3 in
    ``slabs`` slabs of the grid kernel: ``seconds`` for the whole lattice
    (a trial is one sweep of its slabs), ``evals_per_s``, and the warm
    call's slab (the first)."""
    from .ops.cuda.sdf_kernel import make_grid_eval

    device = resolve_device(device)
    grid_eval = make_grid_eval(scene)
    arrays = scene.arrays.to_torch(device)
    lo = np.full(3, -GRID_HALF, np.float32)
    cell = np.float32(2 * GRID_HALF / size)
    depth = size // slabs
    z = []

    def reset():
        z[:] = [0]

    def call():
        z0, z[0] = z[0], (z[0] + 1) % slabs
        return grid_eval(arrays, lo, cell, float(z0 * depth), depth, size)

    timing = time_calls(call, slabs, device, reset)
    seconds = timing.seconds * slabs
    return dict(seconds=seconds, warm_seconds=timing.warm_seconds, evals_per_s=size ** 3 / seconds,
                slab=timing.first)


def payload(rays_per_s: float, march_mode: str, exact_rays_per_s: float) -> dict:
    """bench.py's JSON line (bench.py:368-385)."""
    return {
        "metric": f"design1_sphere_trace_rays_per_s_chip[{march_mode}]",
        "value": round(rays_per_s),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 2),
        "baseline_note": BASELINE_NOTE,
        "exact_k1_rays_per_s": round(exact_rays_per_s),
    }


def describe(device: torch.device) -> str:
    """The device line: the card's name and, from nvidia-smi, its name and
    power limit."""
    if device.type != "cuda":
        return str(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return f"{torch.cuda.get_device_name(device)} ({smi[index]})"


def _frame_line(label: str, cell: dict) -> None:
    log(f"{label}: {cell['seconds']*1e3:.3f} ms/frame -> {cell['rays_per_s']/1e6:.1f} Mrays/s")


def main(device="cuda") -> dict:
    """Run every cell at bench.py's sizes on ``device``; print the labels on
    stderr and the JSON line on stdout.  Returns ``{"payload": ...,
    "seconds": {cell: seconds a call}, "warm_seconds": {cell: its warm
    call's seconds}, "triangles": {export: count}}``."""
    from .designs import get_design
    from .evaluator import BatchEvaluator

    device = resolve_device(device)
    log("devices:", describe(device))
    scenes = {name: get_design(name) for name in ("design1", "design2", "logo")}
    seconds, warm, triangles = {}, {}, {}

    def keep(name, cell):
        seconds[name], warm[name] = cell["seconds"], cell["warm_seconds"]

    # The headline: whichever of the two hit-preserving fast modes is faster.
    fast = render_cell(scenes["design1"], OVERRELAX, FRAME_REPS, device)
    _frame_line("march (overrelax 1.6)", fast)
    hier = render_cell(scenes["design1"], HIERARCHICAL, FRAME_REPS, device)
    _frame_line("march (hierarchical + overrelax)", hier)
    march_mode, best = "overrelax1.6", fast
    if hier["rays_per_s"] > fast["rays_per_s"]:
        march_mode, best = "hierarchical+overrelax1.6", hier
    exact = render_cell(scenes["design1"], EXACT, FRAME_REPS, device)
    _frame_line("march (exact k1 semantics)", exact)
    keep("design1_overrelax", fast)
    keep("design1_hierarchical", hier)
    keep("design1_exact", exact)

    cell = render_cell(scenes["design2"], HIERARCHICAL, FRAME_REPS, device)
    _frame_line("design2 (hierarchical + overrelax)", cell)
    keep("design2_hierarchical", cell)
    for name in ("design2", "logo"):
        cell = render_cell(scenes[name], EXACT, FRAME_REPS, device)
        log(f"{name} viewport (exact k1, {cell['engine']}): {cell['seconds']*1e3:.3f} ms/frame"
            f" -> {cell['rays_per_s']/1e6:.2f} Mrays/s")
        keep(f"{name}_exact", cell)
    cell = render_cell(scenes["logo"], HIERARCHICAL, FRAME_REPS, device)
    _frame_line("logo (hierarchical + overrelax)", cell)
    keep("logo_hierarchical", cell)

    cell = export_cell(scenes["design1"], D1_EXPORT, 1, device, strategy="active")
    report = cell["report"]
    n = 1 << D1_EXPORT.grid_level
    log(f"design1 export {n}^3 (active, {D1_EXPORT.gradient_descent_steps} refine): "
        f"{cell['seconds']:.1f} s, {report.num_triangles} tris "
        f"(stages: { {k: round(v, 2) for k, v in report.stage_seconds.items()} })")
    keep("design1_export_active", cell)
    triangles["design1_export_active"] = report.num_triangles

    cell = export_cell(scenes["design2"], None, 1, device, strategy="adaptive")
    report = cell["report"]
    log(f"design2 adaptive export (own config, octree 6->8 grid 2^9):"
        f" {cell['seconds']:.1f} s, {report.num_triangles} tris, levels "
        f"{report.stats.get('level_triangles')}, open loops "
        f"{report.stats.get('open_loops', 0)}, "
        f"{report.sdf_evals/1e6:.1f}M sdf evals")
    keep("design2_export_adaptive", cell)
    triangles["design2_export_adaptive"] = report.num_triangles

    for kernels in (True, False):
        evaluator = BatchEvaluator(scenes["logo"], device=device, use_kernels=kernels)
        cell = export_cell(scenes["logo"], LOGO_EXPORT, 1, device, evaluator=evaluator,
                           autodetect=False)
        report = cell["report"]
        field = report.stats["sdf_field"]
        log(f"logo export (adaptive 5->7 grid 2^7, sdf_field={field}): "
            f"{cell['seconds']:.1f} s, {report.num_triangles} tris, "
            f"{report.sdf_evals/1e6:.1f}M sdf evals")
        keep(f"logo_export_{field}", cell)
        triangles[f"logo_export_{field}"] = report.num_triangles

    for name, field, reps in FIT_CELLS:
        config = fit_config(field)
        cell = fit_cell(scenes[name], config, reps, device)
        log(f"{name} fit step [{field}] ({config.width}x{config.height} geometric, "
            f"fwd+bwd+adam): {cell['seconds']*1e3:.1f} ms/step -> "
            f"{config.width*config.height/cell['seconds']/1e6:.2f} Mrays/s effective")
        keep(f"{name}_fit_{field}", cell)

    cell = grid_cell(scenes["design1"], GRID_SIZE, GRID_SLABS, device)
    log(f"grid {GRID_SIZE}^3: {cell['seconds']*1e3:.1f} ms -> {cell['evals_per_s']/1e6:.0f} Mevals/s")
    keep("grid", cell)

    out = payload(best["rays_per_s"], march_mode, exact["rays_per_s"])
    print(json.dumps(out), flush=True)
    return dict(payload=out, seconds=seconds, warm_seconds=warm, triangles=triangles)


if __name__ == "__main__":
    from .cli import main as cli_main

    cli_main(["bench", *sys.argv[1:]])
