#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (designcsg_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels of Design1 and Design2 (point eval, grid eval, the
fused renderer exact and fast, the cone prepass, the fit's ray march) from the
sources in this checkout, all nvcc runs at once, and holds each against its
plain PyTorch version at the main paths' shapes.  Then it drives five main
paths through the user entry points, with launch counts set to 0 before each
and read after:

* Design1's viewport, a k2 query and the dense 256^3 export to STL/PLY;
* Design1's fast viewport: ``cli render design1 --fast`` (cone prepass +
  over-relaxed renderer from its t0 plane) and the over-relaxed renderer
  alone (``RenderConfig(march_overrelax=1.6)``);
* Design2: the same two fast renders, its exact viewport, a k2 query and the
  export's bounding-box scan on the card;
* D: Design1's differentiable fit at 640x480 (bench.py's fit configuration):
  ``make_fit_harness``, ``render_target`` and 10 Adam steps, 11 ray-march
  launches; one step is held against the same step with the plain march;
* D': ``cli fit design1`` at its defaults (64x48, 150 steps), whose printed
  position error must fall.

It times every kernel and its plain version with CUDA events (and Design1's
renderer built with and without FMA contraction against each other), and
prints:

* the ``-Xptxas -v`` report of the build;
* a ``{"kernels": [...]}`` JSON line, one entry per kernel, mode and design
  (launches on its main path, error against the plain version, times, the
  card's lower bound).  ``ms`` is the mean time per call by CUDA events over
  back-to-back calls (launch overhead included), ``device_ms`` the kernel's
  own time from torch.profiler;
* a ``fit_step`` JSON line: one fit step's time by events, split into the
  ray march, the gradient reattachment (forward and backward) and Adam, its
  peak device memory and effective Mrays/s;
* the card's name and power limit, as nvidia-smi reports them;
* last, ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the CUDA toolkit (nvcc); it imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from designcsg_tpu_torch import cli
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import writers
from designcsg_tpu_torch.export.pipeline import autodetect_bounding_box_device, export_mesh
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import (
    make_cuda_cone_march,
    make_cuda_hierarchical_renderer,
    make_cuda_ray_march,
    make_cuda_renderer,
)
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.cuda.tape import (
    cone_kernel_source,
    march_kernel_source,
    ray_march_kernel_source,
    sdf_kernel_source,
)
from designcsg_tpu_torch.ops.interpreter import dot3, gizmo_sdf, make_primary_sdf
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    make_march,
    project,
    ray_directions,
    render_scene,
    to_u8,
)
from designcsg_tpu_torch.parallel.fit import make_fit_harness

ROOT = os.path.dirname(os.path.abspath(__file__))
DESIGNS = ("design1", "design2")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations (a fused multiply-add counts 2).  Each brush carries the
# count of its CUDA body (Brush.cuda_flops); a brush that ignores its
# coordinates costs nothing, nor does its frame transform (the compiler drops it).
FRAME_OPS = 3 + 15  # 3 subtractions + a 3x3 matrix-vector product (9 mul, 6 add)
GIZMO_OPS = 3 + 3 * 9 + 2  # 3 divisions, 3 cylinders, 2 mins

EXACT = RenderConfig()
OVERRELAX = RenderConfig(march_overrelax=1.6)
HIERARCHICAL = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
HIERARCHICAL_EXACT = RenderConfig(march_hierarchical=True)
# The fit (bench.py:284-342): 640x480, exact march of 512 steps, no gizmo.
FIT = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
FIT_OVERRELAX = dataclasses.replace(FIT, march_overrelax=1.6)

MARCH_PY = "designcsg_tpu/ops/pallas/march_kernel.py"
SOURCES = {
    "point_eval": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                   "designcsg_tpu/ops/pallas/sdf_kernel.py:76"),
    "grid_eval": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                  "designcsg_tpu/ops/pallas/sdf_kernel.py:185"),
    "renderer": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:339"),
    "renderer_overrelax": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:565"),
    "renderer_t0": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:447"),
    "cone_march": ("designcsg_tpu_torch/csrc/cone_kernel.cu", f"{MARCH_PY}:202"),
    "ray_march": ("designcsg_tpu_torch/csrc/ray_march_kernel.cu", f"{MARCH_PY}:45"),
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


def busy_ms(fn, iters: int = 5):
    """Mean device time per call of every CUDA kernel under ``fn()`` (the
    device's busy time), from torch.profiler; None when it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return total / iters / 1e3 if total > 0 else None


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_render(name: str, got, ref) -> float:
    """The rule of tests/test_pallas.py:115-116,133-134 against the plain
    version; returns max|d|."""
    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
          f"{name} finite, shape {tuple(got.shape)}")
    check(float(err.max()) < 1e-3, f"{name} max|d| = {float(err.max()):.3g} < 1e-3")
    frac = float((err > 1e-4).float().mean())
    check(frac < 0.01, f"{name} share of |d| > 1e-4 = {frac:.4%} < 1%")
    return float(err.max())


def check_handoffs(name: str, got, ref, far: float) -> float:
    """Cone t_safe against its plain version: the same hit/miss handoff
    (t_safe > max_d) on >= 99% of rays, |dt| <= 1e-4 on the rest; returns
    max|dt| over rays whose handoffs agree."""
    same = (got > far) == (ref > far)
    share = float(same.float().mean())
    check(share >= 0.99, f"{name} equal handoffs on {share:.4%} of rays >= 99%")
    both = (got <= far) & (ref <= far)
    err = float((got - ref).abs()[both].max()) if bool(both.any()) else 0.0
    check(err <= 1e-4, f"{name} max|dt| = {err:.3g} <= 1e-4 where both stay in the scene")
    return float((got - ref).abs()[same].max())


def hit_rules(fast, exact, miss_color):
    """tests/test_pallas.py:266-276's numbers for a hierarchical image against
    an exact one: hit-mask disagreement, median |d| and the share above
    0.05 on pixels both hit."""
    miss = torch.tensor(miss_color, device=fast.device)
    fast_hit, exact_hit = (fast != miss).any(-1), (exact != miss).any(-1)
    diff = (fast - exact).abs().amax(-1)[fast_hit & exact_hit]
    return (float((fast_hit != exact_hit).float().mean()), float(diff.median()),
            float((diff > 0.05).float().mean()))


def check_hit_preserving(name: str, fast, exact, plain_fast, plain_exact, miss_color) -> None:
    """The hierarchical kernel against the exact kernel by
    tests/test_pallas.py:266-276's rules: hit masks differ on < 0.2% of
    pixels, median |d| < 1e-4 on pixels both hit, and < 1% of those above
    0.05 -- or, where the plain versions themselves differ more than that
    (Design2's creases, PERF.md), no more than 0.25 points above the plain
    pair's share."""
    mask, med, share = hit_rules(fast, exact, miss_color)
    plain_share = hit_rules(plain_fast, plain_exact, miss_color)[2]
    check(mask < 0.002, f"{name} hit-mask disagreement {mask:.4%} < 0.2%")
    check(med < 1e-4, f"{name} median |d| on pixels both hit = {med:.3g} < 1e-4")
    limit = max(0.01, plain_share + 0.0025)
    check(share < limit, f"{name} share of both-hit pixels above 0.05 = {share:.4%} < "
                         f"{limit:.4%} (plain versions: {plain_share:.4%})")


def check_ray_march(name: str, got, ref) -> float:
    """The fit's ray march against its plain version by the rule of
    tests/test_pallas.py:153-156: identical hit sets, d and vmin within
    1e-5.  Where crease rays break it, the count is printed and the
    renderer's full-frame rule (max|d| < 1e-3, < 1% above 1e-4) holds d and
    vmin instead.  Returns the largest |d| over d and vmin."""
    (d, vmin), (d_ref, vmin_ref) = got, ref
    check(bool(torch.isfinite(d).all() and torch.isfinite(vmin).all())
          and d.shape == d_ref.shape and vmin.shape == vmin_ref.shape,
          f"{name} finite, d {tuple(d.shape)}, vmin {tuple(vmin.shape)}")
    other = int(((d > 0) != (d_ref > 0)).sum())
    errs = {"d": (d - d_ref).abs(), "vmin": (vmin - vmin_ref).abs()}
    err = max(float(e.max()) for e in errs.values())
    if other == 0 and err <= 1e-5:
        check(True, f"{name} identical hit sets ({int((d > 0).sum())} hits), "
                    f"max|d| over d and vmin = {err:.3g} <= 1e-5")
    else:
        print(f"  {name}: {other} rays hit in one version only, max|d| {err:.3g}; "
              f"the renderer's full-frame rule instead", flush=True)
        for what, e in errs.items():
            frac = float((e > 1e-4).float().mean())
            check(float(e.max()) < 1e-3 and frac < 0.01,
                  f"{name} {what} max|d| = {float(e.max()):.3g} < 1e-3, share > 1e-4 = {frac:.4%} < 1%")
    return err


def timed_once(fn):
    """(fn(), its time in ms by CUDA events) for one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def fit_rays(config, cam, device):
    """(o_proj f32[3] on the host, r_proj f32[H, W, 3] on ``device``) as the
    fit harness forms them."""
    rows = camera_rows(*cam)
    return rows[0], project(ray_directions(config, device), *torch.as_tensor(rows[1:], device=device))


def coarse_rays(config, cam, device):
    """(o_proj f32[3] on the host, the block-centre rays f32[H/F, W/F, 3] on
    ``device``), formed as the hierarchical renderer forms them."""
    rows = camera_rows(*cam)
    frame = torch.as_tensor(rows[1:], device=device)
    return rows[0], project(torch.from_numpy(coarse_ray_uv(config)).to(device), *frame)


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

    phase("2. build both designs' kernels (nvcc, sm_90a, one process per unit)")
    scenes = {name: get_design(name) for name in DESIGNS}
    units = {}
    for name, scene in scenes.items():
        units[f"{name} sdf"] = ("sdf", sdf_kernel_source(scene))
        units[f"{name} march exact"] = ("march", march_kernel_source(scene, EXACT))
        units[f"{name} march omega=1.6"] = ("march", march_kernel_source(scene, HIERARCHICAL))
        units[f"{name} cone"] = ("cone", cone_kernel_source(scene, HIERARCHICAL))
        units[f"{name} cone omega=1"] = ("cone", cone_kernel_source(scene, HIERARCHICAL_EXACT))
        units[f"{name} ray_march"] = ("ray_march", ray_march_kernel_source(scene, FIT))
    units["design1 ray_march omega=1.6"] = (
        "ray_march", ray_march_kernel_source(scenes["design1"], FIT_OVERRELAX))
    units["design1 ray_march cli fit"] = (
        "ray_march", ray_march_kernel_source(scenes["design1"], cli.fit_config(64, 48)))
    # Timing phase only: Design1's renderer with FMA contraction.
    units["design1 march_fma"] = ("march_fma", march_kernel_source(scenes["design1"], EXACT))
    t0 = time.time()
    logs = kbuild.build(units)
    print(f"  built {len(units)} units in {time.time() - t0:.1f} s")
    for label, log in logs.items():
        print(f"  -- ptxas report, {label}:")
        for line in log.strip().splitlines():
            print(f"     {line}")

    results = {}  # (kernel, design) -> numbers
    arrays = {name: scene.arrays.to_torch(dev) for name, scene in scenes.items()}
    cam = Camera.initial().as_arrays()
    rng = np.random.default_rng(0)
    glo, gcell, gz0 = np.full(3, -3.5, np.float32), np.float32(7.0 / 256), 112.0
    kernels = {}
    for name, scene in scenes.items():
        kernels[name] = dict(
            point_eval=make_point_eval(scene),
            grid_eval=make_grid_eval(scene),
            renderer=make_cuda_renderer(scene, EXACT),
            renderer_overrelax=make_cuda_renderer(scene, OVERRELAX),
            renderer_t0=make_cuda_renderer(scene, HIERARCHICAL),
            cone_march=make_cuda_cone_march(scene, HIERARCHICAL),
            hierarchical=make_cuda_hierarchical_renderer(scene, HIERARCHICAL),
            hierarchical_exact=make_cuda_hierarchical_renderer(scene, HIERARCHICAL_EXACT),
            ray_march=make_cuda_ray_march(scene, FIT),
        )
    inputs = {}
    images = {}

    for step, (name, scene) in enumerate(scenes.items()):
        k, a = kernels[name], arrays[name]
        phase(f"{3 + step}a. {name}: point eval (2^20 points) and grid eval (33x257x257) vs plain")
        half = scene.export_config.bounding_box_half_diameter / 2.0
        pts = torch.from_numpy(rng.uniform(-half, half, (1 << 20, 3)).astype(np.float32)).to(dev)
        inputs[name] = dict(pts=pts)
        for kernel, got, ref in (
            ("point_eval", k["point_eval"](pts, a), k["point_eval"].plain(pts, a)),
            ("grid_eval", k["grid_eval"](a, glo, gcell, gz0, 33, 257),
             k["grid_eval"].plain(a, glo, gcell, gz0, 33, 257)),
        ):
            torch.cuda.synchronize()
            err = (got - ref).abs()
            results[(kernel, name)] = dict(max_abs_err=float(err.max()))
            check(bool((err <= 1e-5 + 1e-6 * ref.abs()).all()),
                  f"{name} {kernel} {tuple(got.shape)} max|d| = {float(err.max()):.3g} "
                  f"within 1e-5 + 1e-6|ref|")

        phase(f"{3 + step}b. {name}: renderers vs plain at 640x480; u8 160x120 vs golden")
        exact, exact_plain = k["renderer"](a, *cam), k["renderer"].plain(a, *cam)
        results[("renderer", name)] = dict(
            max_abs_err=check_render(f"{name} exact", exact, exact_plain))
        over = k["renderer_overrelax"](a, *cam)
        results[("renderer_overrelax", name)] = dict(max_abs_err=check_render(
            f"{name} over-relaxed", over, k["renderer_overrelax"].plain(a, *cam)))
        o_proj, rays = coarse_rays(HIERARCHICAL, cam, dev)
        t_safe = k["cone_march"](a, o_proj, rays)
        t_plain = k["cone_march"].plain(a, o_proj, rays)
        torch.cuda.synchronize()
        results[("cone_march", name)] = dict(max_abs_err=check_handoffs(
            f"{name} cone {tuple(t_safe.shape)}", t_safe, t_plain, HIERARCHICAL.max_distance))
        f = HIERARCHICAL.hierarchical_factor
        t0_plane = t_plain.repeat_interleave(f, 0).repeat_interleave(f, 1).contiguous()
        inputs[name].update(o_proj=o_proj, rays=rays, t0=t0_plane)
        results[("renderer_t0", name)] = dict(max_abs_err=check_render(
            f"{name} t0 renderer (plain cone's t0)", k["renderer_t0"](a, *cam, t0=t0_plane),
            k["renderer_t0"].plain(a, *cam, t0=t0_plane)))
        # Safety: every covered fine ray's start point is epsilon-clear, by
        # the point kernel (the k2 field) and the gizmo, i.e. the k1 field.
        t0_cuda = t_safe.repeat_interleave(f, 0).repeat_interleave(f, 1)
        frame = torch.as_tensor(camera_rows(*cam)[1:], device=dev)
        starts = torch.as_tensor(o_proj, device=dev) + t0_cuda[..., None] * project(
            ray_directions(HIERARCHICAL, dev), *frame)
        starts = starts.reshape(-1, 3).contiguous()
        field = torch.minimum(k["point_eval"](starts, a), gizmo_sdf(starts))
        inside = t0_cuda.reshape(-1) < HIERARCHICAL.max_distance
        low = float(field[inside].min())
        check(low >= HIERARCHICAL.sdf_epsilon - 1e-6,
              f"{name} cone safety: min sdf at covered start points {low:.4g} >= eps")
        hier, hier_plain = k["hierarchical"](a, *cam), k["hierarchical"].plain(a, *cam)
        check_render(f"{name} hierarchical", hier, hier_plain)
        check_hit_preserving(f"{name} hierarchical vs exact", hier, exact, hier_plain,
                             exact_plain, EXACT.miss_color)
        # Reported, not checked: how far each fast mode alone moves the image
        # from the exact one (hit-mask disagreement, median |d|, share > 0.05).
        print(f"  {name} over-relaxed vs exact {hit_rules(over, exact, EXACT.miss_color)}; "
              f"cone prepass at omega = 1 vs exact "
              f"{hit_rules(k['hierarchical_exact'](a, *cam), exact, EXACT.miss_color)}")
        images[name] = dict(hierarchical=hier, overrelax=over)

        phase(f"{3 + step}c. {name}: the fit's ray march vs plain at 640x480 (fit config)")
        o_fit, r_fit = fit_rays(FIT, cam, dev)
        rm = k["ray_march"]
        got = rm(a, o_fit, r_fit)
        # The plain version, timed once, with its step counts for the bound.
        (d_ref, vmin_ref, steps), plain_ms = timed_once(lambda: make_march(scene, FIT)(
            torch.as_tensor(o_fit, device=dev), r_fit, a, return_closest=True, return_steps=True))
        results[("ray_march", name)] = dict(
            max_abs_err=check_ray_march(f"{name} ray_march", got, (d_ref, vmin_ref)),
            plain_ms=plain_ms)
        inputs[name].update(o_fit=o_fit, r_fit=r_fit, fit_evals=int(steps.sum()))
        if name == "design1":
            over = make_cuda_ray_march(scene, FIT_OVERRELAX)
            check_ray_march(f"{name} ray_march omega=1.6", over(a, o_fit, r_fit),
                            over.plain(a, o_fit, r_fit))
        small = to_u8(render_scene(scene, config=RenderConfig(width=160, height=120)))
        golden = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_160x120.npy"))
        frac = float((np.abs(small.cpu().numpy().astype(int) - golden.astype(int)).max(-1) > 2).mean())
        check(frac < 0.002, f"{name} 160x120 u8 pixels off the golden by > 2 levels: {frac:.4%} < 0.2%")

    phase("5. small dense export of Design1 on the card vs the plain CPU path")
    scene = scenes["design1"]
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

    launches = {}  # (kernel, design) -> launches on its main path

    phase("6. main path A, Design1: render, point eval, dense 256^3 export (launches counted)")
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
    counted = dict(kbuild.LAUNCHES)
    print(f"  main path {main_s:.2f} s; launches {counted}")
    check(bool(torch.isfinite(image).all()) and tuple(image.shape) == (480, 640, 3),
          "viewport finite, (480, 640, 3)")
    check(probe[0] < 0, f"sdf at the origin {probe[0]:.4f} < 0 (inside Design1)")
    check(back.num_faces == report.num_triangles > 0 and ply_back.num_faces == back.num_faces,
          f"STL/PLY read back: {back.num_faces} triangles")
    check(bool(np.isfinite(mesh.vertices).all()) and mesh.signed_volume() > 0,
          f"mesh finite, volume {mesh.signed_volume():.3f} > 0")
    for kernel in ("point_eval", "grid_eval", "renderer"):
        check(counted.get(kernel, 0) > 0, f"{kernel} launched {counted.get(kernel, 0)} times")
        launches[(kernel, "design1")] = counted[kernel]
    print(f"  export stage_seconds {json.dumps(report.stage_seconds)}; "
          f"{report.num_vertices} vertices, {report.num_triangles} triangles, "
          f"box center {report.bounding_box_center.tolist()}, half {report.bounding_box_half_diameter}")

    for path, name in (("B", "design1"), ("C", "design2")):
        scene = scenes[name]
        extra = ", exact viewport, k2 query, bounding-box scan" if name == "design2" else ""
        phase(f"7{path}. main path {path}, {name}: `cli render {name} --fast`, "
              f"over-relaxed viewport{extra} (launches counted)")
        kbuild.LAUNCHES.clear()
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, f"{name}_fast.png")
            cli.main(["render", name, "--fast", "-o", png])
            back = cli.read_png(png)
        over = render_scene(scene, config=OVERRELAX)
        if name == "design2":
            exact = render_scene(scene)
            probe = BatchEvaluator(scene).eval_sdf_at_points(np.full((1, 3), 0.5, np.float32))
            center, half_box = autodetect_bounding_box_device(
                BatchEvaluator(scene), scene.export_config.bounding_box_half_diameter
            )
        torch.cuda.synchronize()
        main_s = time.time() - t0
        counted = dict(kbuild.LAUNCHES)
        print(f"  main path {main_s:.2f} s; launches {counted}")
        check(back.shape == (480, 640, 3), f"{name} --fast PNG read back, {back.shape}")
        same = float((back == to_u8(images[name]["hierarchical"]).cpu().numpy()).all(-1).mean())
        check(same == 1.0, f"{name} --fast PNG equals the checked hierarchical render, "
                           f"{same:.4%} of pixels")
        check(torch.equal(over, images[name]["overrelax"]),
              f"{name} over-relaxed viewport equals the checked over-relaxed render")
        check(counted.get("cone_march") == 1 and counted.get("renderer_t0") == 1,
              f"{name} --fast: one cone_march and one renderer_t0 launch per frame")
        expect = ["cone_march", "renderer_t0", "renderer_overrelax"]
        if name == "design2":
            check(bool(torch.isfinite(exact).all()), "design2 exact viewport finite")
            ref = kernels[name]["point_eval"].plain(torch.full((1, 3), 0.5, device=dev), arrays[name])
            check(abs(probe[0] - float(ref[0])) <= 1e-5,
                  f"design2 k2 query {probe[0]:.6f} equals the plain SDF {float(ref[0]):.6f}")
            check(np.isfinite(center).all() and 0 < half_box < scene.export_config.bounding_box_half_diameter,
                  f"design2 bounding box centre {center.tolist()}, half {half_box:.4f}")
            expect += ["renderer", "point_eval", "grid_eval"]
        for kernel in expect:
            check(counted.get(kernel, 0) > 0, f"{name} {kernel} launched {counted.get(kernel, 0)} times")
            launches[(kernel, name)] = counted[kernel]

    phase("7D. main path D, Design1 fit at 640x480: render_target and 10 Adam steps "
          "(launches counted)")
    scene = scenes["design1"]
    start = np.asarray(scene.arrays.position).copy()
    start[1:, 0] += 0.05  # bench.py:300-305
    harness = make_fit_harness(scene, FIT)
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    target = harness.render_target(scene.arrays, *cam)
    state = harness.init({"position": start})
    losses = []
    for _ in range(10):
        state, loss = harness.step_fn(state, target, *cam)
        losses.append(loss)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counted = dict(kbuild.LAUNCHES)
    losses = torch.stack(losses).cpu()
    grad = state.params["position"].grad
    print(f"  main path {main_s:.2f} s; launches {counted}; losses {losses.tolist()}")
    check(counted.get("ray_march") == 11, f"ray_march launched {counted.get('ray_march')} times == 11")
    launches[("ray_march", "design1")] = counted["ray_march"]
    check(bool(torch.isfinite(losses).all()), "every fit loss finite")
    check(bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0,
          f"position gradient finite and nonzero, max |g| = {float(grad.abs().max()):.4g}")
    # One step with the kernel against the same step with the plain march
    # (tests/test_pallas.py:223-226's rule), outside the counted run.
    plain_harness = make_fit_harness(scene, dataclasses.replace(FIT, use_pallas_march=False))
    steps_out = {}
    for key, h in (("kernel", harness), ("plain", plain_harness)):
        s1, loss1 = h.step_fn(h.init({"position": start}), target, *cam)
        steps_out[key] = (float(loss1), s1.params["position"].grad, s1.params["position"].detach())
    (lk, gk, pk), (lp, gp, pp) = steps_out["kernel"], steps_out["plain"]
    check(abs(lk - lp) <= 1e-5 * abs(lp), f"step loss {lk:.8g} vs plain march {lp:.8g}, rtol 1e-5")
    check(float((gk - gp).abs().max()) <= 1e-5,
          f"step gradient max|d| vs plain march = {float((gk - gp).abs().max()):.3g} <= 1e-5")
    print(f"  step parameters max|d| vs plain march {float((pk - pp).abs().max()):.3g}")

    phase("7D'. main path D', `cli fit design1` at its defaults (launches counted)")
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(printed):
        cli.main(["fit", "design1", "-o", tmp])
        wrote = os.path.exists(os.path.join(tmp, "fit.ckpt"))
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counted = dict(kbuild.LAUNCHES)
    print("  " + printed.getvalue().strip().replace("\n", "\n  "))
    print(f"  main path {main_s:.2f} s; launches {counted}")
    errs = [float(e) for e in re.findall(r"max pos err ([0-9.]+)", printed.getvalue())]
    check(wrote and len(errs) == 10, "cli fit wrote fit.ckpt and printed 10 progress lines")
    check(errs[-1] < errs[0], f"max position error fell, {errs[0]} -> {errs[-1]}")
    check(counted.get("ray_march") == 151, f"cli fit: ray_march launched {counted.get('ray_march')} "
                                           f"times == 151")

    phase("8. timing (CUDA events, after warm-up)")
    frames = {}
    for name, scene in scenes.items():
        k, a, x = kernels[name], arrays[name], inputs[name]
        ops = tape_ops(scene)
        pts, n_pts = x["pts"], x["pts"].shape[0]
        n_grid = 33 * 257 * 257
        n_px = EXACT.width * EXACT.height
        r = results
        r[("point_eval", name)].update(
            ms=cuda_ms(lambda: k["point_eval"](pts, a), 100),
            device_ms=device_ms(lambda: k["point_eval"](pts, a), "point_eval_kernel"),
            plain_ms=cuda_ms(lambda: k["point_eval"].plain(pts, a), 3),
        )
        r[("point_eval", name)].update(zip(("bound_ms", "bound_by"), bound_ms(16 * n_pts, ops * n_pts)))
        grid = (a, glo, gcell, gz0, 33, 257)
        r[("grid_eval", name)].update(
            ms=cuda_ms(lambda: k["grid_eval"](*grid), 100),
            device_ms=device_ms(lambda: k["grid_eval"](*grid), "grid_eval_kernel"),
            plain_ms=cuda_ms(lambda: k["grid_eval"].plain(*grid), 3),
        )
        r[("grid_eval", name)].update(zip(("bound_ms", "bound_by"), bound_ms(4 * n_grid, ops * n_grid)))

        # A renderer's work: the march steps this image takes (read from the
        # plain version's step counts), 6 normal evaluations per shaded
        # pixel, each a tape + gizmo evaluation; 12 B/pixel written (+4 B of
        # t0 read).  The cone's: its steps, 16 B/ray.
        rows = torch.as_tensor(camera_rows(*cam), device=dev)
        r_proj = project(ray_directions(EXACT, dev), *rows[1:])
        t0_plane = x["t0"]
        for kernel, config, call, t0 in (
            ("renderer", EXACT, lambda: k["renderer"](a, *cam), None),
            ("renderer_overrelax", OVERRELAX, lambda: k["renderer_overrelax"](a, *cam), None),
            ("renderer_t0", HIERARCHICAL, lambda: k["renderer_t0"](a, *cam, t0=t0_plane), t0_plane),
        ):
            plain = k[kernel].plain
            r[(kernel, name)].update(
                ms=cuda_ms(call, 20),
                device_ms=device_ms(call, "render_kernel"),
                plain_ms=cuda_ms(lambda: plain(a, *cam, t0=t0), 2),
            )
            d, steps = make_march(scene, config)(rows[0], r_proj, a, return_steps=True, t0=t0)
            evals = int(steps.sum()) + 6 * int((d > 0).sum())
            n_bytes = (12 + (4 if t0 is not None else 0)) * n_px
            r[(kernel, name)].update(zip(("bound_ms", "bound_by"),
                                         bound_ms(n_bytes, evals * (ops + GIZMO_OPS))))
            print(f"  {name} {kernel}: {evals} tape evals ({evals / n_px:.1f}/pixel), "
                  f"{n_px / r[(kernel, name)]['ms'] / 1e3:.2f} Mrays/s")
        o_proj, rays = x["o_proj"], x["rays"]
        cone = k["cone_march"]
        r[("cone_march", name)].update(
            ms=cuda_ms(lambda: cone(a, o_proj, rays), 50),
            device_ms=device_ms(lambda: cone(a, o_proj, rays), "cone_march_kernel"),
            plain_ms=cuda_ms(lambda: cone.plain(a, o_proj, rays), 2),
        )
        _, steps = cone.plain(a, o_proj, rays, return_steps=True)
        n_rays = rays.numel() // 3
        r[("cone_march", name)].update(zip(("bound_ms", "bound_by"), bound_ms(
            16 * n_rays, int(steps.sum()) * (ops + GIZMO_OPS))))
        print(f"  {name} cone_march: {int(steps.sum())} tape evals over {n_rays} rays "
              f"({int(steps.sum()) / n_rays:.1f}/ray)")
        # The fit's ray march: the tape evaluations of this march (no gizmo),
        # 12 B of ray read and 16 B (d, vmin) written per ray.
        rm, o_fit, r_fit = k["ray_march"], x["o_fit"], x["r_fit"]
        r[("ray_march", name)].update(
            ms=cuda_ms(lambda: rm(a, o_fit, r_fit), 20),
            device_ms=device_ms(lambda: rm(a, o_fit, r_fit), "ray_march_kernel"),
        )
        n_rays = r_fit.numel() // 3
        r[("ray_march", name)].update(zip(("bound_ms", "bound_by"), bound_ms(
            28 * n_rays, x["fit_evals"] * ops)))
        print(f"  {name} ray_march: {x['fit_evals']} tape evals over {n_rays} rays "
              f"({x['fit_evals'] / n_rays:.1f}/ray), {json.dumps(r[('ray_march', name)])}")
        hier = k["hierarchical"]
        frame_ms = cuda_ms(lambda: hier(a, *cam), 20)
        frames[name] = dict(
            exact_ms=r[("renderer", name)]["ms"],
            overrelax_ms=r[("renderer_overrelax", name)]["ms"],
            hierarchical_frame_ms=frame_ms,
            hierarchical_device_ms=(device_ms(lambda: hier(a, *cam), "render_kernel") or 0.0)
            + (device_ms(lambda: hier(a, *cam), "cone_march_kernel") or 0.0),
            hierarchical_plain_ms=cuda_ms(lambda: hier.plain(a, *cam), 2),
        )
        frames[name]["mrays_per_s"] = {
            mode: n_px / frames[name][key] / 1e3
            for mode, key in (("exact", "exact_ms"), ("overrelax", "overrelax_ms"),
                              ("hierarchical", "hierarchical_frame_ms"))
        }
        print(f"  {name} frames: {json.dumps(frames[name])}")

    # Design1's renderer ships built with -fmad=false; the same source with
    # nvcc's default FMA contraction is timed beside it (alternating, A B A
    # B) and its error against the plain version reported, not checked.
    a = arrays["design1"]
    renderer = kernels["design1"]["renderer"]
    renderer_fma = make_cuda_renderer(scenes["design1"], EXACT, fmad=True)
    err = (renderer_fma(a, *cam) - renderer.plain(a, *cam)).abs()
    ab = {"fmad_false": [], "fma": []}
    for _ in range(2):
        for key, fn in (("fmad_false", renderer), ("fma", renderer_fma)):
            ab[key].append(device_ms(lambda: fn(a, *cam), "render_kernel", iters=20))
    print(f"  design1 renderer -fmad=false vs FMA contraction, device ms (A B A B): "
          f"{json.dumps(ab)}; FMA build max|d| vs plain {float(err.max()):.3g}, "
          f"share of |d| > 1e-4 {float((err > 1e-4).float().mean()):.4%}")

    # One fit step at 640x480 (path D's), split by events: the ray march
    # alone, the loss with its backward (the march inside it subtracted: the
    # reattachment), and Adam's update alone.  Peak memory over one step.
    step_ms = cuda_ms(lambda: harness.step_fn(state, target, *cam), 10)
    loss_bwd_ms = cuda_ms(lambda: harness.loss_fn(state.params, target, *cam).backward(), 10)
    adam_ms = cuda_ms(lambda: state.opt_state.step(), 10)
    march_ms = results[("ray_march", "design1")]["ms"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    harness.step_fn(state, target, *cam)
    torch.cuda.synchronize()
    fit_step = dict(
        step_ms=step_ms, ray_march_ms=march_ms, reattach_fwd_bwd_ms=loss_bwd_ms - march_ms,
        adam_ms=adam_ms, peak_mem_bytes=torch.cuda.max_memory_allocated(),
        peak_above_resident_bytes=torch.cuda.max_memory_allocated() - base_mem,
        mrays_per_s=FIT.width * FIT.height / step_ms / 1e3,
        device_busy_ms=busy_ms(lambda: harness.step_fn(state, target, *cam)),
    )
    # The reattachment's pieces at the step's hit points, by events: one tape
    # evaluation building its graph, its backward, and the IFT slope by
    # torch.func.jvp (what the port runs) -- beside the same slope by
    # reverse mode (timed only; its largest relative difference is printed).
    sdf = make_primary_sdf(scene)
    fit_arrays = harness.param_to_arrays(state.params)
    frozen = fit_arrays.detach()
    o_fit, r_fit = inputs["design1"]["o_fit"], inputs["design1"]["r_fit"]
    d0, _ = kernels["design1"]["ray_march"](fit_arrays, o_fit, r_fit)
    p = torch.as_tensor(o_fit, device=dev) + d0[..., None] * r_fit

    def reverse_slope():
        q = p.detach().requires_grad_()
        (g,) = torch.autograd.grad(sdf(q, frozen).sum(), q)
        return dot3(g, r_fit)

    tape_ms = cuda_ms(lambda: sdf(p, fit_arrays), 10)
    fit_step.update(
        tape_with_graph_ms=tape_ms,
        tape_backward_ms=cuda_ms(lambda: sdf(p, fit_arrays).sum().backward(), 10) - tape_ms,
        jvp_slope_ms=cuda_ms(lambda: torch.func.jvp(lambda q: sdf(q, frozen), (p,), (r_fit,)), 10),
        reverse_slope_ms=cuda_ms(reverse_slope, 10),
    )
    f_d = torch.func.jvp(lambda q: sdf(q, frozen), (p,), (r_fit,))[1]
    hit = d0 > 0
    fit_step["slope_max_rel_diff"] = float(
        ((reverse_slope() - f_d).abs() / f_d.abs().clamp(min=1e-6))[hit].max())
    print(json.dumps({"fit_step": fit_step}))
    # Design2's ray march runs on no main path of this script (the fit is
    # Design1's); its numbers are printed here, not in the kernels line.
    print(json.dumps({"ray_march_design2": results[("ray_march", "design2")]}))

    line = [
        dict(name=kernel, design=name, route="cuda", source=SOURCES[kernel][0],
             replaces=SOURCES[kernel][1], launches=launches[(kernel, name)], library_ms=None,
             **results[(kernel, name)])
        for name in DESIGNS
        for kernel in SOURCES
        if (kernel, name) in launches
    ]
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
