#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (designcsg_tpu_torch) on one card.

    python3 chip_smoke.py

Builds Design1's three CUDA kernels (point eval, grid eval, fused renderer)
from the sources in this checkout, holds each against its plain PyTorch
version at the main path's shapes, drives the main path once through the
user entry points (render the 640x480 viewport, evaluate points, export the
dense 256^3 mesh to STL/PLY) with launch counts read around it, times every
kernel and its plain version with CUDA events (and the renderer built with
and without FMA contraction against each other), and prints:

* the ``-Xptxas -v`` report of the build;
* a ``{"kernels": [...]}`` JSON line (launches on the main path, error against
  the plain version, times, the card's lower bound).  ``ms`` is the mean time
  per call by CUDA events over back-to-back calls (launch overhead included),
  ``device_ms`` the kernel's own time from torch.profiler;
* the card's name and power limit, as nvidia-smi reports them;
* last, ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the CUDA toolkit (nvcc); it imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import writers
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_renderer
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.cuda.tape import march_kernel_source, sdf_kernel_source
from designcsg_tpu_torch.ops.raymarch import camera_rows, make_march, project, ray_directions
from designcsg_tpu_torch.ops.raymarch import render_scene, to_u8

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "design1_160x120.npy")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations (a fused multiply-add counts 2).  Each brush carries the
# count of its CUDA body (Brush.cuda_flops); a brush that ignores its
# coordinates costs nothing, nor does its frame transform (the compiler drops it).
FRAME_OPS = 3 + 15  # 3 subtractions + a 3x3 matrix-vector product (9 mul, 6 add)
GIZMO_OPS = 3 + 3 * 9 + 2  # 3 divisions, 3 cylinders, 2 mins

SOURCES = {
    "point_eval": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                   "designcsg_tpu/ops/pallas/sdf_kernel.py:76"),
    "grid_eval": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                  "designcsg_tpu/ops/pallas/sdf_kernel.py:185"),
    "renderer": ("designcsg_tpu_torch/csrc/march_kernel.cu",
                 "designcsg_tpu/ops/pallas/march_kernel.py:339"),
}


def tape_ops(scene) -> int:
    """FP32 operations of one evaluation of the scene tape."""
    ops = 0
    for opcode, left, _, _ in scene.arrays.tape:
        if opcode == 0:  # IMPORT
            brush = scene.brush_flops[int(left)]
            if brush is None:
                raise ValueError(f"brush {scene.brush_names[int(left)]!r} has no cuda_flops")
            ops += brush + (FRAME_OPS if brush else 0)
        elif opcode in (2, 3, 4):  # MIN, MAX, NEGATE
            ops += 1
    return ops


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, kernel: str, iters: int = 10):
    """Mean device time per call of the CUDA kernels named ``kernel`` under
    ``fn()``, from torch.profiler's CUDA activity; None when the profiler
    records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(
        getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        for e in prof.key_averages()
        if kernel in e.key
    )
    return total / iters / 1e3 if total > 0 else None


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("2. build Design1's kernels (nvcc, sm_90a)")
    scene = get_design("design1")
    config = RenderConfig()
    t0 = time.time()
    logs = kbuild.build({
        "sdf": sdf_kernel_source(scene),
        "march": march_kernel_source(scene, config),
        "march_fma": march_kernel_source(scene, config),  # timing phase only
    })
    print(f"  built in {time.time() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  -- ptxas report, {name}:")
        for line in log.strip().splitlines():
            print(f"     {line}")
    arrays = scene.arrays.to_torch(dev)
    results = {}

    phase("3. point eval kernel vs plain, 2^20 points")
    point_eval = make_point_eval(scene)
    half = scene.export_config.bounding_box_half_diameter / 2.0
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-half, half, (1 << 20, 3)).astype(np.float32)).to(dev)
    got = point_eval(pts, arrays)
    ref = point_eval.plain(pts, arrays)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    results["point_eval"] = dict(max_abs_err=float(err.max()))
    check(bool((err <= 1e-5 + 1e-6 * ref.abs()).all()),
          f"point eval max|d| = {float(err.max()):.3g} within 1e-5 + 1e-6|ref|")

    phase("4. grid eval kernel vs plain, one 33x257x257 slab")
    grid_eval = make_grid_eval(scene)
    glo, gcell, gz0 = np.full(3, -3.5, np.float32), np.float32(7.0 / 256), 112.0
    got = grid_eval(arrays, glo, gcell, gz0, 33, 257)
    ref = grid_eval.plain(arrays, glo, gcell, gz0, 33, 257)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (33, 257, 257), "grid eval shape (33, 257, 257)")
    err = (got - ref).abs()
    results["grid_eval"] = dict(max_abs_err=float(err.max()))
    check(bool((err <= 1e-5 + 1e-6 * ref.abs()).all()),
          f"grid eval max|d| = {float(err.max()):.3g} within 1e-5 + 1e-6|ref|")

    phase("5. renderer kernel vs plain, 640x480; u8 at 160x120 vs golden")
    cam = Camera.initial().as_arrays()
    renderer = make_cuda_renderer(scene, config)
    got = renderer(arrays, *cam)
    render_ref = renderer.plain(arrays, *cam)
    torch.cuda.synchronize()
    err = (got - render_ref).abs()
    results["renderer"] = dict(max_abs_err=float(err.max()))
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (480, 640, 3),
          "render finite, shape (480, 640, 3)")
    check(float(err.max()) < 1e-3, f"render max|d| = {float(err.max()):.3g} < 1e-3")
    frac = float((err > 1e-4).float().mean())
    check(frac < 0.01, f"render share of |d| > 1e-4 = {frac:.4%} < 1%")
    small = to_u8(render_scene(scene, config=RenderConfig(width=160, height=120)))
    diff = np.abs(small.cpu().numpy().astype(int) - np.load(GOLDEN).astype(int))
    frac = float((diff.max(axis=-1) > 2).mean())
    check(frac < 0.002, f"160x120 u8 pixels off the golden by > 2 levels: {frac:.4%} < 0.2%")

    phase("6. small dense export on the card vs the plain CPU path")
    small_cfg = dataclasses.replace(scene.export_config, grid_level=5, gradient_descent_steps=5)
    kw = dict(export_config=small_cfg, autodetect_resolution=32, strategy="dense")
    m_dev, r_dev = export_mesh(scene, device="cuda", **kw)
    m_cpu, r_cpu = export_mesh(scene, device="cpu", **kw)
    check(np.abs(r_dev.bounding_box_center - r_cpu.bounding_box_center).max() < 1e-5
          and abs(r_dev.bounding_box_half_diameter - r_cpu.bounding_box_half_diameter) < 1e-5,
          "bounding box agrees with the CPU path within 1e-5")
    check(m_dev.num_faces == m_cpu.num_faces and m_dev.num_faces > 0,
          f"triangle count {m_dev.num_faces} equals the CPU path's")
    vd = np.sort(m_dev.triangle_soup().reshape(-1, 9), axis=0)
    vc = np.sort(m_cpu.triangle_soup().reshape(-1, 9), axis=0)
    check(np.abs(vd - vc).max() < 1e-3, f"refined triangles agree, max|d| = {np.abs(vd - vc).max():.3g}")

    phase("7. main path: render, point eval, dense 256^3 export (launches counted)")
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    image = render_scene(scene)
    evaluator = BatchEvaluator(scene)
    probe = evaluator.eval_sdf_at_points(np.zeros((1, 3), np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        stl, ply = os.path.join(tmp, "design1.stl"), os.path.join(tmp, "design1.ply")
        mesh, report = export_mesh(
            scene, stl_path=stl, ply_path=ply, evaluator=evaluator, strategy="dense"
        )
        back = writers.read_stl(stl)
        ply_back = writers.read_ply(ply)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = dict(kbuild.LAUNCHES)
    print(f"  main path {main_s:.2f} s; launches {launches}")
    check(bool(torch.isfinite(image).all()) and tuple(image.shape) == (480, 640, 3),
          "viewport finite, (480, 640, 3)")
    check(probe[0] < 0, f"sdf at the origin {probe[0]:.4f} < 0 (inside Design1)")
    check(back.num_faces == report.num_triangles > 0 and ply_back.num_faces == back.num_faces,
          f"STL/PLY read back: {back.num_faces} triangles")
    check(bool(np.isfinite(mesh.vertices).all()) and mesh.signed_volume() > 0,
          f"mesh finite, volume {mesh.signed_volume():.3f} > 0")
    for name in SOURCES:
        check(launches.get(name, 0) > 0, f"{name} launched {launches.get(name, 0)} times")
    print(f"  export stage_seconds {json.dumps(report.stage_seconds)}; "
          f"{report.num_vertices} vertices, {report.num_triangles} triangles, "
          f"box center {report.bounding_box_center.tolist()}, half {report.bounding_box_half_diameter}")

    phase("8. timing (CUDA events, after warm-up)")
    ops = tape_ops(scene)
    n_pts = pts.shape[0]
    results["point_eval"].update(
        ms=cuda_ms(lambda: point_eval(pts, arrays), 100),
        device_ms=device_ms(lambda: point_eval(pts, arrays), "point_eval_kernel"),
        plain_ms=cuda_ms(lambda: point_eval.plain(pts, arrays), 3),
    )
    results["point_eval"].update(zip(("bound_ms", "bound_by"), bound_ms(16 * n_pts, ops * n_pts)))
    n_grid = 33 * 257 * 257
    results["grid_eval"].update(
        ms=cuda_ms(lambda: grid_eval(arrays, glo, gcell, gz0, 33, 257), 100),
        device_ms=device_ms(lambda: grid_eval(arrays, glo, gcell, gz0, 33, 257), "grid_eval_kernel"),
        plain_ms=cuda_ms(lambda: grid_eval.plain(arrays, glo, gcell, gz0, 33, 257), 3),
    )
    results["grid_eval"].update(zip(("bound_ms", "bound_by"), bound_ms(4 * n_grid, ops * n_grid)))
    results["renderer"].update(
        ms=cuda_ms(lambda: renderer(arrays, *cam), 20),
        device_ms=device_ms(lambda: renderer(arrays, *cam), "render_kernel"),
        plain_ms=cuda_ms(lambda: renderer.plain(arrays, *cam), 2),
    )
    # The renderer's work: the march steps this image takes, 6 normal evals
    # per shaded pixel, each a tape + gizmo evaluation.
    rows = torch.as_tensor(camera_rows(*cam), device=dev)
    r_proj = project(ray_directions(config, dev), *rows[1:])
    d, steps = make_march(scene, config)(rows[0], r_proj, arrays, return_steps=True)
    evals = int(steps.sum()) + 6 * int((d > 0).sum())
    n_px = config.width * config.height
    results["renderer"].update(zip(("bound_ms", "bound_by"),
                                   bound_ms(12 * n_px, evals * (ops + GIZMO_OPS))))
    print(f"  tape {ops} FP32 ops/point; render {evals} tape evals "
          f"({evals / n_px:.1f}/pixel); Mrays/s {n_px / results['renderer']['ms'] / 1e3:.2f}")
    # The renderer ships built with -fmad=false; the same source with nvcc's
    # default FMA contraction is timed beside it (alternating, A B A B) and
    # its error against the plain version reported, not checked.
    renderer_fma = make_cuda_renderer(scene, config, fmad=True)
    err = (renderer_fma(arrays, *cam) - render_ref).abs()
    ab = {"fmad_false": [], "fma": []}
    for _ in range(2):
        for key, fn in (("fmad_false", renderer), ("fma", renderer_fma)):
            ab[key].append(device_ms(lambda: fn(arrays, *cam), "render_kernel", iters=20))
    print(f"  renderer -fmad=false vs FMA contraction, device ms (A B A B): "
          f"{json.dumps(ab)}; FMA build max|d| vs plain {float(err.max()):.3g}, "
          f"share of |d| > 1e-4 {float((err > 1e-4).float().mean()):.4%}")

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=launches[name], library_ms=None, **results[name])
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
