#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (designcsg_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels of Design1, Design2 and Logo (point eval, its FD
form and grid eval, each also with the k1 gizmo; the fused renderer exact and
fast, the cone prepass, the fit's ray march; in Logo's, csrc/table.cuh
samples the letters' dense planes, K6; and the exact per-tile cull, K7, inside the
renderer, hoisted and dynamic, and inside the grid kernel) and the culled
kernels of a synthetic scene of 89 cull groups from the sources in this
checkout, all nvcc runs at once, and holds each against its plain PyTorch
version at the main paths' shapes (the culled kernels also against the
unculled ones, phase 5d, the culled grids bit for bit; the cone kernel's
t_safe bit for bit; a scene without CUDA bodies runs on the plain tape,
phase 5e; the export strategies agree at 256^3, phase 6).  Then it drives
nine main paths through the user entry points, with launch counts set to 0
before each and read after:

* A: Design1's viewport, a k2 query, k1-field queries (the gizmo kernels)
  and bench.py's 512^3 ``active`` export (50 refine steps) to STL/PLY,
  whose grid must take 20 launches of K3 and whose refine must make one
  launch of K1's FD form per chunk and step (100) and none of the single
  point kernel (the counts read around it; also on Design2's adaptive
  export and Logo's baked one, 50); this export and those of A', C and E
  must give the triangle counts they gave before K3's redesign;
* A': ``cli export design1`` at its defaults (auto: the adaptive octree
  5 -> 7 at grid level 8);
* Design1's fast viewport: ``cli render design1 --fast`` (cone prepass +
  over-relaxed renderer from its t0 plane) and the over-relaxed renderer
  alone (``RenderConfig(march_overrelax=1.6)``);
* Design2: the same two fast renders, its exact viewport, a k2 query, the
  export's bounding-box scan, k1-field queries and its adaptive export at its
  own configuration (octree 6 -> 8, grid level 9);
* D: Design1's differentiable fit at 640x480 (bench.py's fit configuration):
  ``make_fit_harness``, ``render_target`` and 10 Adam steps, 11 ray-march
  launches; one step is held against the same step with the plain march;
* D': ``cli fit design1`` at its defaults (64x48, 150 steps), whose printed
  position error must fall;
* E: Logo: ``cli render logo`` and ``cli render logo --fast`` at 640x480, the
  over-relaxed viewport, a 2^20-point k2 query on the exact tape and on the
  baked field, k1-field queries, and bench.py's Logo export (adaptive 5 -> 7
  at grid level 7, 50 refine steps) on both fields, each mesh held to the
  other field within 2x the twin's tolerance;
* F: Logo's fit at 640x480 (bench.py's configuration): ``render_target`` and
  3 Adam steps for ``fit_field`` exact and twin, 8 ray-march launches;
* G, per design: ``render_scene`` with ``march_cull="dynamic"`` and with
  ``march_cull=True``, each from the camera and hierarchical at omega = 1.6
  (the cone prepass, then the culled t0 renderer), and the culled grid over
  the 33x257x257 slab, without and with the gizmo; every frame is held to
  the checked unculled one;
* slice 10 (phase 8H), each part with the counts set to 0 before it and
  read after: the studio (``StudioSession`` on the card runs the
  new-design template and a script that builds Design1, renders a
  640x480 frame exactly, K2 once, orbits and renders again, switches to
  the fast mode, K5 and K2 from its t0 plane, and runs the monitored
  background export at grid level 6, K3 and K1's FD form); the viewer's
  ``orbit_frames``, 4 frames each bit-equal to ``render_scene`` from the
  same camera; ``cli watch`` on Design1's script with ``--max-renders 1``;
  ``profile_trace`` around one exact frame in a process of its own, whose
  Chrome trace must name K2's ``render_kernel``; the compacted renderer on Logo at 320x240 (the
  proxy prepass, then the exact tape on the survivors), held to
  ``make_renderer(field="exact")`` on the card by the JAX package's
  compacted-against-plain rule, its time and survivors beside the fused
  K2's Logo frame; analytic normals of ``BatchEvaluator(use_kernels=False,
  normal_mode="analytic")`` at 2^16 points near Design1's surface, held to
  K1's FD-form normals and to the same evaluation on the CPU; and the
  dynamic tape, bit-equal to the staged tape on Design1 and Design2 at
  2^16 points.  It prints a ``slice10`` JSON line.

It times every kernel and its plain version with CUDA events (and Design1's
renderer built with and without FMA contraction against each other), and
prints:

* the ``-Xptxas -v`` report of the build;
* a ``{"kernels": [...]}`` JSON line, one entry per kernel, mode and design
  (launches on its main path, error against the plain version, times, the
  card's lower bound; Logo's rows also name K6, which they inline, and the
  culled rows K7, with ``skipped_share``, the share of group evaluations
  the plain version skipped at the kernel's tiles, and ``unculled_ms``).  ``ms``
  is the mean time per call by CUDA events over back-to-back calls (launch
  overhead included), ``single_ms`` the median by events of single calls on
  an idle card, ``device_ms`` the mean of torch.profiler's records of the
  kernel plus its constant bank's fill where the unit has one (its
  ``bank_fill`` names the records);
* a ``k1_sass`` line: the instructions of Design1's, Design2's and Logo's
  point kernel and its FD form by opcode (``cuobjdump -sass``), with the
  shared, global and constant loads and the FP32 instructions summed;
* a ``k3_k5_units`` line: per design the registers and spills (ptxas) of
  K3's grid kernels (unculled and culled, without and with the gizmo) and of
  K5's cone kernel, their SASS split at their widest loop (one lattice
  point of the column loop; one cone step), the cone's warps a block
  (``CONE_WARPS``) and the column form's FP32 operations a point and a
  column, counted from the generated code beside the point form's; a
  ``k3_vs_k1_bit_equal_share`` line: the share of the grid kernel's values
  bit-equal to the point kernel's at the same lattice points;
* a ``k4_unit`` line: per design K4's registers and spills (ptxas), its
  resident blocks per SM and its SASS split at the march loop (before it,
  one step, after it); a ``k2_registers`` line: every renderer unit's;
* per design a ``k4_warp_lane_share`` line: the share of a K4 warp's
  lane-steps that do work, from the plain march's steps for warps of 32
  neighbouring rays (the kernel runs one thread per ray), at 640x480 and
  at ``cli fit``'s 64x48;
* a ``k1_path_batches`` line: K1 and its FD form timed on the vertex chunks
  each export's refine took, with their bounds, one refine step as seven
  launches and glue beside one FD launch, and launches x (ms - bound);
* per design a ``timing_crosscheck`` line, each kernel's time read those
  three ways and by events over 1, 4, 16 and 64 calls; for Logo a
  ``k6_table_read_model`` line: the time its table reads alone would take at
  an assumed L1 rate, a model and not a measurement; and per design a
  ``k7_chain_ops_model`` line: the FP32 operations of one K7 chain and of one
  tape evaluation of each culled kernel, and beside them what a warp issues
  for one lane chain (``lane_chain``: FP32 operations of its slot passes
  and tree, and its shuffles), counted from the generated code;
* a ``k7_dynamic_held_box`` line: per design and dynamic mode, the share of
  group evaluations the kernel skips with its held box (counted by its
  CULL_STATS build) beside the plain version's per-step share, and the
  chains each ran;
* a ``logo_close_up_k7`` line: in Logo's close-up, where the hoisted cull
  prunes (phase 5d), its skipped share and the culled and unculled
  renderers' device ms, alternated;
* a ``fit_step`` JSON line: one fit step's time by events, split into the
  ray march, the gradient reattachment (forward and backward) and Adam, its
  peak device memory and effective Mrays/s; and a ``fit_step_logo`` line,
  Logo's step time and peak memory per ``fit_field``;
* an ``export`` JSON line per export of the main paths: its strategy, field,
  stage seconds, triangles, SDF evaluations, per-level triangles and
  whether the native mesh ops ran, and the whole run's seconds;
* the card's name and power limit, as nvidia-smi reports them;
* last, ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result.
It needs a CUDA device and the CUDA toolkit (nvcc); it imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
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

from designcsg_tpu_torch import cli, native, studio, viewer
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.designs.logo import LETTER_PLANE_FLOPS, LETTER_TABLE_BYTES
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import writers
from designcsg_tpu_torch.export.pipeline import autodetect_bounding_box_device, export_mesh
from designcsg_tpu_torch.export.retopo import boundary_edges
from designcsg_tpu_torch.ops import cull
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import (
    make_cuda_cone_march,
    make_cuda_hierarchical_renderer,
    make_cuda_ray_march,
    make_cuda_renderer,
)
from designcsg_tpu_torch.ops.cuda.sdf_kernel import lattice_points, make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.cuda.tape import (
    FRAME_TERMS_OPS,
    GIZMO_FLOPS,
    column_frame_ops,
    column_hoisted,
    cone_kernel_source,
    cone_warps,
    cull_chain_ops,
    grid_cull_column,
    lane_chain_ops,
    march_kernel_source,
    ray_march_kernel_source,
    sdf_kernel_source,
)
from designcsg_tpu_torch.observability import TRACE_FILE
from designcsg_tpu_torch.ops.interpreter import (
    dot3,
    gizmo_sdf,
    make_dynamic_primary_sdf,
    make_normal_fn,
    make_primary_sdf,
)
from designcsg_tpu_torch.ops.table import packed_rank_sample, plane_sample
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    make_compacted_renderer,
    make_march,
    project,
    make_renderer,
    make_scene_renderer,
    ray_directions,
    render_scene,
    to_u8,
)
from designcsg_tpu_torch.parallel.fit import make_fit_harness

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_scenes import custom_brush_scene, many_groups_scene  # noqa: E402
DESIGNS = ("design1", "design2", "logo")
GOLDENS = ("design1", "design2")

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# An assumed L1 load rate of an SM, not a measured one: one 128 B wavefront
# per cycle (a warp's 32 four-byte loads).  Only the ``k6_table_read_model``
# line uses it, the time Logo's table reads alone would need at this rate.
L1_BYTES_PER_CLOCK = 128

# FP32 operations (a fused multiply-add counts 2).  Each brush carries the
# count of its CUDA body (Brush.cuda_flops); a tape slot costs that plus its
# frame transform, unless the brush ignores its coordinates (the compiler
# drops its transform): cull.leaf_cost, which the cull's grouping uses too.
GIZMO_OPS = GIZMO_FLOPS  # 3 divisions, 3 cylinders, 2 mins
# K1's FD form around its seven evaluations (csrc/common.cuh sdf_fd_normal):
# per axis 6 offset coordinates, a difference, 2e and a division (9); the
# norm (3 products, 2 sums, a square root) and 3 divisions.
FD_GLUE_OPS = 3 * 9 + 6 + 3

EXACT = RenderConfig()
OVERRELAX = RenderConfig(march_overrelax=1.6)
HIERARCHICAL = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
HIERARCHICAL_EXACT = RenderConfig(march_hierarchical=True)
# K7, the exact per-tile cull inside K2: hoisted and dynamic, from the camera
# (exact march) and from the cone's t0 plane (over-relaxed, path G's --fast).
CULLED = {
    "renderer_cull": (dataclasses.replace(EXACT, march_cull=True), "renderer"),
    "renderer_cull_dynamic": (dataclasses.replace(EXACT, march_cull="dynamic"), "renderer"),
    "renderer_t0_cull": (dataclasses.replace(HIERARCHICAL, march_cull=True), "renderer_t0"),
    "renderer_t0_cull_dynamic": (dataclasses.replace(HIERARCHICAL, march_cull="dynamic"),
                                 "renderer_t0"),
}
# K7 where the hoisted cull prunes: Logo close up and head on with a short
# march range (from the default camera its view-cone boxes leave no group out).
NEAR = RenderConfig(max_distance=8.0)
NEAR_CULLED = dataclasses.replace(NEAR, march_cull=True)
# The fit (bench.py:284-342): 640x480, exact march of 512 steps, no gizmo.
FIT = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
FIT_OVERRELAX = dataclasses.replace(FIT, march_overrelax=1.6)
# bench.py:256-263's Logo export: plates at world radius ~3.1, the adaptive
# octree 5 -> 7 at grid level 7, 50 refine steps.
LOGO_EXPORT = ExportConfig(bounding_box_half_diameter=3.5, grid_level=7, minimum_octree_level=5,
                           maximum_octree_level=7, gradient_descent_steps=50)
# bench.py:196-209's Design1 export: 512^3 active, 50 refine steps.
D1_EXPORT = ExportConfig(bounding_box_half_diameter=10.0, grid_level=9, gradient_descent_steps=50)
# The JAX package's recorded triangle counts of the same exports
# (BENCH_r05.json); device-independent, printed beside the card's.
JAX_TRIANGLES = {"design1_active_512": 2180120, "design2_adaptive": 231888,
                 "logo_adaptive_baked": 44170, "logo_adaptive_exact": 54878}
JAX_DESIGN2_LEVELS = {6: 6878, 7: 33273, 8: 159137}
# The triangle counts the same exports gave with the port's kernels before
# K3's redesign (68fd463's tree, ab_render_timing.py on an H100 80GB HBM3 at
# 700 W; PERF.md): the redesigned grid kernel must not move them.
EARLIER_TRIANGLES = {"design1_active_512": 2180120, "cli_export_design1": 21992,
                     "design2_adaptive": 230648, "logo_adaptive_exact": 48134,
                     "logo_adaptive_baked": 40936}

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
    # K7 inside K2 (the hoisted branch :468-495, the dynamic one :497-523) and K3.
    "renderer_cull": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:468"),
    "renderer_cull_dynamic": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:497"),
    "renderer_t0_cull": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:468"),
    "renderer_t0_cull_dynamic": ("designcsg_tpu_torch/csrc/march_kernel.cu", f"{MARCH_PY}:497"),
    "grid_eval_cull": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                       "designcsg_tpu/ops/pallas/sdf_kernel.py:236"),
    # K1 and K3 with the gizmo (sdf_kernel.py:90 and :204, :211 there).
    "point_eval_gizmo": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                         "designcsg_tpu/ops/pallas/sdf_kernel.py:76"),
    "grid_eval_gizmo": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                        "designcsg_tpu/ops/pallas/sdf_kernel.py:185"),
    "grid_eval_cull_gizmo": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                             "designcsg_tpu/ops/pallas/sdf_kernel.py:236"),
    # K1 in its FD form: the point kernel's SDF and FD normal in one launch.
    "point_eval_fd": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                      "designcsg_tpu/ops/pallas/sdf_kernel.py:76"),
    "point_eval_fd_gizmo": ("designcsg_tpu_torch/csrc/sdf_kernels.cu",
                            "designcsg_tpu/ops/pallas/sdf_kernel.py:76"),
}
# K6, inlined into every kernel of a scene with baked tables (Logo).
K6_SOURCE = ("designcsg_tpu_torch/csrc/table.cuh", "designcsg_tpu/ops/pallas/table.py:45")
# K7's chain, generated per scene over interval.cuh into every culled kernel.
K7_SOURCE = ("designcsg_tpu_torch/csrc/interval.cuh", "designcsg_tpu/ops/pallas/cull.py:453")


def leaf_ops(scene, brush: int) -> int:
    """FP32 operations of one tape slot of ``brush`` in the kernels: its
    CUDA body and its frame transform.  A letter's body samples K6's planes
    (LETTER_PLANE_FLOPS); its ``cuda_flops`` keeps the rank form's count,
    which the cull's grouping reads."""
    flops = scene.brush_flops[brush]
    if flops is None:
        raise ValueError(f"brush {scene.brush_names[brush]!r} has no cuda_flops")
    if scene.brush_names[brush].startswith("letter_"):
        return cull.leaf_cost(scene, brush) - flops + LETTER_PLANE_FLOPS
    return cull.leaf_cost(scene, brush)


def tape_ops(scene) -> int:
    """FP32 operations of one evaluation of the scene tape."""
    ops = 0
    for opcode, left, _, _ in scene.arrays.tape:
        if opcode == 0:  # IMPORT
            ops += leaf_ops(scene, int(left))
        elif opcode in (2, 3, 4):  # MIN, MAX, NEGATE
            ops += 1
    return ops


def table_bytes(scene) -> int:
    """Table bytes read by one tape evaluation (K6: a 16-byte cell of the
    planes per letter)."""
    return sum(LETTER_TABLE_BYTES for b in scene.arrays.shape_id
               if scene.brush_names[int(b)].startswith("letter_"))


def kernel_tables(scene) -> int:
    """Bytes of the tables the kernels read, each counted once: Logo's
    planes (the derived extras; the rank tables stay on the host path)."""
    return 4 * sum(t.size for _, t in scene.derived_extras)


def group_ops(scene, culler, column: bool = False) -> list:
    """FP32 operations of each cull group's slots in one tape evaluation; in
    the grid kernel's column form (``column``) a hoisted slot's frame
    transform takes 7, not 18 (tape.FRAME_ROW_OPS)."""
    slots = [int(left) for opcode, left, _, _ in scene.arrays.tape if opcode == 0]
    hoisted = column_hoisted(scene) if column else {}

    def slot_ops(k):
        if k == len(slots):
            return GIZMO_OPS
        return leaf_ops(scene, slots[k]) - (11 if k in hoisted else 0)

    return [sum(slot_ops(k) for k in members) for members in culler.groups]


def column_ops(scene) -> dict:
    """The grid kernel's FP32 operations, counted from its generated column
    form (tape.column_frame_ops): a point's (the tape with the hoisted
    slots' frame rows in place of their whole transforms), a column's (the
    hoisted terms), and the point form's a point beside them."""
    frame = column_frame_ops(scene)
    point = tape_ops(scene)
    return dict(point_form_ops=point, column_form_ops=point - frame["point_form"] + frame["column_form"],
                per_column_ops=frame["per_column"], hoisted=frame["hoisted"])


def grid_ranges(scene, nz: int, ny: int, nx: int) -> int:
    """The z ranges the unculled grid kernel cuts an (nz, ny, nx) slab into
    on this card (csrc/sdf_kernels.cu grid_eval_z_ranges, from the unit's
    occupancy): each makes its columns' terms."""
    lib = kbuild.load("sdf", sdf_kernel_source(scene))
    ranges, zper = ctypes.c_int(), ctypes.c_int()
    kbuild.check_call("grid_eval_z_ranges", lib.grid_eval_z_ranges(
        nz, ny, nx, ctypes.byref(ranges), ctypes.byref(zper)))
    return ranges.value


def culled_ops(counts, full_ops: int, gops: list, chain_ops: int) -> int:
    """FP32 operations of a culled kernel's run: every evaluation's full tape
    less the slots of the groups it skipped, and the chains."""
    skipped = sum((counts["evals"] - g) * o for g, o in zip(counts["group_evals"], gops))
    return counts["evals"] * full_ops - skipped + counts["chains"] * chain_ops


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def enqueue_ms(fn, iters: int = 20) -> float:
    """Mean host time per call to enqueue ``fn()`` back to back (no
    synchronization inside the window): where it reaches the events time,
    the host, not the card, sets the pace."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - start) / iters * 1e3
    torch.cuda.synchronize()
    return host


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


def kernel_records(fn, kernels, iters: int = 10):
    """torch.profiler's timeline of the CUDA kernels whose names contain one
    of ``kernels``, over ``iters`` back-to-back calls of ``fn()``: per name,
    the number of records, their mean, least and largest duration, the mean
    idle gap between consecutive records and the span from the first start
    to the last end (ms).  A name with no record is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for kernel in kernels:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and kernel in e.name)
        if not spans:
            continue
        durs = [(end - begin) / 1e3 for begin, end in spans]
        gaps = [(spans[i + 1][0] - spans[i][1]) / 1e3 for i in range(len(spans) - 1)]
        out[kernel] = dict(records=len(spans), mean_ms=sum(durs) / len(durs), min_ms=min(durs),
                           max_ms=max(durs), gap_ms=sum(gaps) / len(gaps) if gaps else None,
                           span_ms=(spans[-1][1] - spans[0][0]) / 1e3)
    return out


# What a launch of a unit with its object bank in constant memory runs
# before its kernel (csrc/common.cuh prepare_bank): the interleaving kernel
# and the copy to the constant symbol.  Part of every such call's device
# time.
BANK_FILL = ("interleave_bank_kernel", "Memcpy DtoD")


def call_device_ms(records: dict, kernel: str):
    """Device time of one call from ``kernel_records`` of ``kernel`` and
    BANK_FILL: the mean record of the kernel plus the mean of each bank-fill
    record the call made; None when the kernel has no record."""
    if kernel not in records:
        return None
    return records[kernel]["mean_ms"] + sum(records[f]["mean_ms"] for f in BANK_FILL if f in records)


def device_ms(fn, kernel: str, iters: int = 10):
    """Device time of one call of ``fn()`` that launches the CUDA kernel
    named ``kernel``, from torch.profiler's timeline: the mean of its
    records plus its bank fill's (``call_device_ms``); None when it
    records none."""
    return call_device_ms(kernel_records(fn, (kernel,) + BANK_FILL, iters), kernel)


def single_ms(fn, repeats: int = 10) -> float:
    """Median time by CUDA events of one call of ``fn()`` started on an idle
    card (the host's enqueue time included)."""
    fn()
    return float(np.median([timed_once(fn)[1] for _ in range(repeats)]))


def crosscheck(fn, kernel: str) -> dict:
    """Three reads of one kernel's time: by CUDA events per call over N
    back-to-back calls for several N (``by_n``; the step from 16 to 64 calls,
    ``steady_ms``, is the card's time per call once the queue is full), by
    events around single calls (``single_ms``) and by torch.profiler's
    records of the kernel and its bank fill (BANK_FILL) over 20 calls
    (``profiler``, ``kernel_records``)."""
    by_n = {n: cuda_ms(fn, n) for n in (1, 4, 16, 64)}
    return dict(by_n=by_n, steady_ms=(64 * by_n[64] - 16 * by_n[16]) / 48,
                single_ms=single_ms(fn), profiler=kernel_records(fn, (kernel,) + BANK_FILL, 20))


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


def warp_simt(steps) -> float:
    """The share of a warp's lane-steps that do work, for warps of 32
    consecutive rays in row-major order that each run as long as their
    longest ray: sum(steps) / (32 * sum over warps of max steps)."""
    flat = steps.reshape(-1).float()
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 32)]).reshape(-1, 32)
    return float(flat.sum() / (32 * flat.amax(1).sum()))


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


def export_line(label: str, report, seconds: float) -> None:
    """Print one export's numbers as an ``export`` JSON line."""
    out = dict(label=label, seconds=seconds, strategy=report.stats["strategy"],
               sdf_field=report.stats["sdf_field"], native=report.stats["native"],
               stage_seconds=report.stage_seconds, triangles=report.num_triangles,
               vertices=report.num_vertices, sdf_evals=report.sdf_evals,
               level_triangles=report.stats.get("level_triangles"),
               open_loops=report.stats.get("open_loops"))
    if label in JAX_TRIANGLES:
        out["jax_recorded_triangles"] = JAX_TRIANGLES[label]
        out["relative_difference"] = report.num_triangles / JAX_TRIANGLES[label] - 1.0
    print(json.dumps({"export": out}), flush=True)


def k1_field_queries(scene, pts, use_kernels=None):
    """What a user asks of the k1 field (the part and the viewport's gizmo):
    a point query, the normals at its first 4096 points and its bounding
    box, through ``BatchEvaluator(gizmo=True)`` (the point, FD and grid
    kernels with the gizmo).  Returns (sdf_field, the values, the box's
    largest corner): the gizmo's axes reach 5 units out along x, y and z, so
    every coordinate of that corner passes 4.9."""
    ev = BatchEvaluator(scene, gizmo=True, use_kernels=use_kernels)
    vals = ev.eval_sdf_at_points(pts)
    normals = ev.eval_normal_at_points(pts[:4096])
    if not np.allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5):
        raise AssertionError("k1-field normals are not of unit length")
    center, half = autodetect_bounding_box_device(ev, 20.0, 128)
    return ev.sdf_field, vals, np.asarray(center) + half


def counting_refine(evaluator, sink: dict):
    """Wrap ``evaluator.refine_on_device`` so that each call records into
    ``sink`` the kernel launches it made (the counts read just before and
    just after it), its vertex count and its vertices."""
    refine = evaluator.refine_on_device

    def wrapped(vertices, *args, **kwargs):
        torch.cuda.synchronize()
        before = dict(kbuild.LAUNCHES)
        t0 = time.time()
        out = refine(vertices, *args, **kwargs)
        torch.cuda.synchronize()
        sink.update(seconds=time.time() - t0, vertices=np.asarray(vertices, np.float32).copy(),
                    chunk=evaluator.chunk_size, steps=int(kwargs.get("steps", args[0] if args else 0)),
                    launches={k: v - before.get(k, 0) for k, v in kbuild.LAUNCHES.items()
                              if v != before.get(k, 0)})
        return out

    evaluator.refine_on_device = wrapped
    return evaluator


def check_triangles(label: str, n: int) -> None:
    check(n == EARLIER_TRIANGLES[label],
          f"{label}: {n} triangles, as before the grid kernel's redesign ({EARLIER_TRIANGLES[label]})")


def check_refine_launches(label: str, sink: dict, expect: int) -> None:
    """One launch of K1's FD form per chunk and step, none of the single
    point kernel, and ``expect`` of them in all (this export's chunks times
    its steps)."""
    n, chunk, steps = len(sink["vertices"]), sink["chunk"], sink["steps"]
    per = -(-n // chunk) * steps
    got = sink["launches"]
    check(got.get("point_eval_fd", 0) == per == expect and got.get("point_eval", 0) == 0,
          f"{label} refine: {n} vertices, {-(-n // chunk)} chunks x {steps} steps: "
          f"{got.get('point_eval_fd', 0)} point_eval_fd launches (== {expect}), "
          f"{got.get('point_eval', 0)} point_eval; launches {got}, {sink['seconds']:.4f} s")


def resident_blocks(registers: int, threads: int) -> int:
    """Blocks of ``threads`` threads that fit on one Hopper SM by registers
    and threads alone (64K registers, allocated 256 a warp, at most 2,048
    threads and 32 blocks): the occupancy calculator's rule, for a kernel
    whose shared memory does not bind."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 2048 // threads, 32)


def unit_registers(log: str, kernel: str):
    """(registers, spill stores in bytes) of ``kernel`` in a unit's
    ``-Xptxas -v`` report; None when the report lacks it."""
    m = re.search(r"Function properties for \S*" + kernel + r"\S*\s+\d+ bytes stack frame, (\d+) "
                  r"bytes spill stores.*?Used (\d+) registers", log, re.S)
    return (int(m.group(2)), int(m.group(1))) if m else None


SASS_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK", "MUFU")


def _sass_summary(ins) -> dict:
    """Counts of (address, opcode, operands) instructions; ``c3_operands``
    counts those that take an operand from the user constant bank
    (``c[0x3]``, where a ``__constant__`` array lives)."""
    c = {}
    for _, op, _ in ins:
        c[op] = c.get(op, 0) + 1
    return dict(total=len(ins), lds=c.get("LDS", 0), ldg=c.get("LDG", 0), ldc=c.get("LDC", 0),
                fp32=sum(v for op, v in c.items() if op in SASS_FP32),
                c3_operands=sum("c[0x3]" in rest for _, _, rest in ins),
                by_opcode=dict(sorted(c.items(), key=lambda kv: -kv[1])))


def sass_counts(so_path: str, kernels) -> dict:
    """Per kernel function of a built library, its SASS instructions by
    opcode (``cuobjdump -sass``), with the shared loads (LDS), global and
    read-only loads (LDG), constant loads (LDC) and FP32 instructions
    (FADD, FMUL, FFMA, FMNMX, FSETP, FSEL, FCHK, MUFU) summed.  ``loop``
    splits them at the backward branch of widest span (a march kernel's step
    loop): the instructions before it, inside it (one step, unrolled tape
    and all) and after it (the exit and the called slow paths of IEEE
    division and square root, CALL in the loop)."""
    cuobjdump = os.path.join(os.path.dirname(kbuild.nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so_path], capture_output=True, text=True,
                         check=True).stdout
    code, current = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = next((k for k in kernels if k in head.group(1)), None)
            if current is not None:
                code[current] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(.*)", line)
        if current is not None and ins:
            code[current].append((int(ins.group(1), 16), ins.group(2), ins.group(3).split(";")[0]))
    result = {}
    for k, ins in code.items():
        result[k] = _sass_summary(ins)
        back = []
        for addr, op, rest in ins:
            target = re.findall(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else []
            if target and int(target[-1], 16) < addr:
                back.append((addr - int(target[-1], 16), int(target[-1], 16), addr))
        if back:
            _, lo, hi = max(back)
            result[k]["loop"] = dict(
                before=_sass_summary([i for i in ins if i[0] < lo]),
                inside=_sass_summary([i for i in ins if lo <= i[0] <= hi]),
                after=_sass_summary([i for i in ins if i[0] > hi]))
    return result


def fit_rays(config, cam, device):
    """(o_proj f32[3] on the host, r_proj f32[H, W, 3] on ``device``) as the
    fit harness forms them."""
    rows = camera_rows(*cam)
    return rows[0], project(ray_directions(config, device), *torch.as_tensor(rows[1:], device=device))


def coarse_rays(config, cam, device):
    """(o_proj f32[3], the block-centre rays f32[H/F, W/F, 3]), both on
    ``device`` (the cone kernel reads the origin there), formed as the
    hierarchical renderer forms them."""
    rows = camera_rows(*cam)
    frame = torch.as_tensor(rows[1:], device=device)
    return (torch.as_tensor(rows[0], device=device),
            project(torch.from_numpy(coarse_ray_uv(config)).to(device), *frame))


# Slice 10's script of Design1 for the studio and ``cli watch``.
DESIGN1_SCRIPT = (
    "from designcsg_tpu_torch.designs import design1\n\n\n"
    "def build():\n"
    "    return design1.build()\n"
)
# One exact Design1 frame under profile_trace, the trace to argv[1].
PROFILE_FRAME = (
    "import sys\n"
    "from designcsg_tpu_torch.designs import get_design\n"
    "from designcsg_tpu_torch.observability import profile_trace\n"
    "from designcsg_tpu_torch.ops.raymarch import render_scene\n"
    "scene = get_design('design1')\n"
    "render_scene(scene)\n"
    "with profile_trace(sys.argv[1]):\n"
    "    render_scene(scene)\n"
)
# The compacted renderer's frame on Logo: cut from 640x480 for the plain
# exact-field renders' time.
COMPACT = RenderConfig(width=320, height=240)


def counted_run(fn):
    """(fn(), the kernel launches it made, its wall seconds)."""
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kbuild.LAUNCHES), time.time() - t0


def slice10_phase(scenes, arrays, kernels, smi) -> dict:
    """Phase 8H: the studio, the viewer, ``cli watch``, ``profile_trace``,
    the compacted renderer, analytic normals and the dynamic tape on the
    card (the module docstring)."""
    out = {"card": smi}
    cam = Camera.initial().as_arrays()
    phase_start = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ws = studio.Workspace(os.path.join(tmp, "ws"))
        session = studio.StudioSession(ws)
        ws.new("template")
        check(session.run_design("template") and session.engine == "cuda",
              "studio ran the new-design template on the card (engine cuda)")
        ws.write("design1", DESIGN1_SCRIPT)
        check(session.run_design("design1") and session.scene.num_objects == 11,
              "studio ran a script that builds Design1 through designcsg_tpu_torch.designs")
        check(session.engine == "cuda", f"studio engine {session.engine} == cuda")
        session.set_render_mode(exact=True)
        png, counted, secs = counted_run(session.render_png)
        out["studio_exact_frame_ms"] = 1e3 * secs
        check(cli.decode_png(png).shape == (480, 640, 3) and counted.get("renderer") == 1
              and not counted.get("cone_march"),
              f"studio exact 640x480 frame: renderer launched {counted.get('renderer')} == 1")
        first = session.render().copy()
        session.orbit(0.6, -0.3)
        frame, counted, secs = counted_run(session.render)
        check(counted.get("renderer") == 1 and np.abs(frame - first).max() > 1e-3,
              "studio orbit: the frame changed, renderer launched once")
        session.set_render_mode(exact=False)
        frame, counted, secs = counted_run(session.render)
        out["studio_fast_frame_ms"] = 1e3 * secs
        check(session.config.march_hierarchical and counted.get("cone_march") == 1
              and counted.get("renderer_t0") == 1,
              f"studio fast mode: cone_march {counted.get('cone_march')} and renderer_t0 "
              f"{counted.get('renderer_t0')} launched once each")
        stl = os.path.join(tmp, "design1.stl")
        kbuild.LAUNCHES.clear()
        check(session.start_export(stl, grid_level=6), "studio export started")
        session._export_thread.join(600)
        status = session.export_status
        counted = dict(kbuild.LAUNCHES)
        check(status["state"] == "done" and status["fraction"] == 1.0 and status["triangles"] > 0,
              f"studio export at grid level 6: {status['state']}, monitor at "
              f"{100 * status['fraction']:.1f}%, {status.get('triangles')} triangles")
        check(counted.get("grid_eval", 0) > 0 and counted.get("point_eval_fd", 0) > 0,
              f"studio export launched grid_eval {counted.get('grid_eval')} and point_eval_fd "
              f"{counted.get('point_eval_fd')} times")
        out["studio_export"] = dict(seconds=status["seconds"], stage_seconds=status["stage_seconds"],
                                    triangles=status["triangles"], launches=counted)

        scene, a = scenes["design1"], arrays["design1"]
        frames, counted, secs = counted_run(
            lambda: viewer.orbit_frames(scene, n_frames=4, config=EXACT))
        check(len(frames) == 4 and counted.get("renderer") == 4,
              f"orbit_frames: 4 frames, renderer launched {counted.get('renderer')} == 4")
        orbit_cam = Camera.initial()
        for i, f in enumerate(frames):
            ref = render_scene(scene, camera=orbit_cam, config=EXACT).cpu().numpy()
            check(np.array_equal(f, ref), f"orbit frame {i} bit-equal to render_scene from its camera")
            orbit_cam.orbit(2 * np.pi / 4, 0.0)

        script, png = os.path.join(tmp, "d1.py"), os.path.join(tmp, "watch.png")
        with open(script, "w") as f:
            f.write(DESIGN1_SCRIPT)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _, counted, secs = counted_run(
                lambda: cli.main(["watch", script, "-o", png, "--max-renders", "1"]))
        check(os.path.exists(png) and counted.get("renderer") == 1 and "engine: cuda" in printed.getvalue(),
              f"cli watch --max-renders 1 wrote a PNG, renderer launched {counted.get('renderer')} "
              f"== 1 ({printed.getvalue().strip().splitlines()[0]})")

        # In a process of its own, as a user profiles a frame: this one has
        # run profiler sessions of its own since phase 5d.
        trace_dir = os.path.join(tmp, "trace")
        subprocess.run([sys.executable, "-c", PROFILE_FRAME, trace_dir], check=True, cwd=ROOT)
        with open(os.path.join(trace_dir, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        k2 = sorted({e.get("name", "") for e in events if "render_kernel" in e.get("name", "")})
        device = sorted({e.get("name", "")[:40] for e in events if e.get("cat") == "kernel"})
        print(f"  profile_trace: {len(events)} events, device kernels {device}")
        check(bool(k2), f"profile_trace's Chrome trace names K2: {k2[:1]}")

    logo, la = scenes["logo"], arrays["logo"]
    compact = make_compacted_renderer(logo, COMPACT)
    img, counted, secs = counted_run(lambda: compact(la, *cam))
    check(not counted, f"the compacted renderer launched no kernel ({counted})")
    exact_field = make_renderer(logo, COMPACT, field="exact")
    plain = exact_field(la, *cam)
    img_c, img_p = to_u8(img).int(), to_u8(plain).int()
    hit_c, hit_p = (img_c < 250).any(-1), (img_p < 250).any(-1)
    flips = float((hit_c != hit_p).float().mean())
    off8 = float(((img_c - img_p).abs().amax(-1) > 8).float().mean())
    check(flips < 5e-3 and off8 < 0.03,
          f"Logo compacted 320x240 vs make_renderer(field='exact'): hit masks differ on "
          f"{flips:.4%} < 0.5%, {off8:.4%} < 3% of pixels off by more than 8")
    out["logo_compacted"] = dict(
        width=COMPACT.width, height=COMPACT.height, survivors=compact.survivors,
        rays=COMPACT.width * COMPACT.height, ms=cuda_ms(lambda: compact(la, *cam), 1, warmup=0),
        first_call_s=secs,
        exact_field_plain_ms=cuda_ms(lambda: exact_field(la, *cam), 1, warmup=0),
        fused_k2_logo_640x480_ms=cuda_ms(lambda: kernels["logo"]["renderer"](la, *cam), 10),
        hit_mask_flips=flips, off_by_8_share=off8)

    d1 = scenes["design1"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    half = d1.export_config.bounding_box_half_diameter / 2.0
    pts = (torch.rand(1 << 22, 3, device="cuda", generator=gen) * 2 - 1) * half
    pts = pts[kernels["design1"]["point_eval"](pts, arrays["design1"]).abs() < 0.05][: 1 << 16]
    check(pts.shape[0] == 1 << 16, "2^16 seeded points within 0.05 of Design1's surface")
    ev = BatchEvaluator(d1, use_kernels=False, normal_mode="analytic")
    (analytic, counted, secs) = counted_run(lambda: ev.eval_normal_at_points(pts.cpu().numpy()))
    check(not counted and ev.sdf_eval_count == pts.shape[0],
          "analytic normals on the card: the plain tape, one evaluation a normal")
    fd = kernels["design1"]["point_eval"].fd(pts, arrays["design1"])[1].cpu().numpy()
    err_fd = np.abs(analytic - fd).max(-1)
    cpu = BatchEvaluator(d1, device="cpu", normal_mode="analytic").eval_normal_at_points(pts.cpu().numpy())
    err_cpu = np.abs(analytic - cpu).max(-1)
    # FD's offset of 0.005 straddles a box's edge near it, where the two
    # normals part; elsewhere they agree to 2e-3.
    share_fd = float((err_fd <= 2e-3).mean())
    check(share_fd >= 0.9, f"analytic normals within 2e-3 of K1's FD form on {share_fd:.4%} >= 90% "
                           f"of points (max {err_fd.max():.3g})")
    check(float(err_cpu.max()) <= 1e-5, f"analytic normals on the card within "
                                        f"{err_cpu.max():.3g} <= 1e-5 of the CPU's")
    out["analytic_normals"] = dict(points=int(pts.shape[0]), within_2e3_of_k1_fd=share_fd,
                                   max_vs_k1_fd=float(err_fd.max()), max_vs_cpu=float(err_cpu.max()),
                                   ms=1e3 * secs)
    for name in ("design1", "design2"):
        sc, a = scenes[name], arrays[name]
        dyn, counted, secs = counted_run(lambda: make_dynamic_primary_sdf(sc)(pts, a))
        check(torch.equal(dyn, make_primary_sdf(sc)(pts, a)) and not counted,
              f"{name} dynamic tape bit-equal to the staged tape at 2^16 points on the card")
        out[f"{name}_dynamic_tape_ms"] = 1e3 * secs
    out["phase_seconds"] = time.time() - phase_start
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    run_start = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sm_clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; {sms} SMs, "
          f"max SM clock {sm_clock_hz / 1e6:.0f} MHz", flush=True)

    phase("2. build the three designs' kernels (nvcc, sm_90a, one process per unit)")
    scenes = {name: get_design(name) for name in DESIGNS}
    units = {}
    for name, scene in scenes.items():
        units[f"{name} sdf"] = ("sdf", sdf_kernel_source(scene))
        units[f"{name} march exact"] = ("march", march_kernel_source(scene, EXACT))
        units[f"{name} march omega=1.6"] = ("march", march_kernel_source(scene, HIERARCHICAL))
        units[f"{name} cone"] = ("cone", cone_kernel_source(scene, HIERARCHICAL))
        units[f"{name} cone omega=1"] = ("cone", cone_kernel_source(scene, HIERARCHICAL_EXACT))
        units[f"{name} ray_march"] = ("ray_march", ray_march_kernel_source(scene, FIT))
        for kernel, (config, _) in CULLED.items():
            units[f"{name} march {kernel}"] = ("march", march_kernel_source(scene, config))
            if kernel.endswith("dynamic"):  # with its debug counters (CULL_STATS)
                units[f"{name} march {kernel} stats"] = (
                    "march", "#define CULL_STATS 1\n" + march_kernel_source(scene, config))
    units["logo march near"] = ("march", march_kernel_source(scenes["logo"], NEAR))
    units["logo march near cull"] = ("march", march_kernel_source(scenes["logo"], NEAR_CULLED))
    for name, scene in scenes.items():
        units[f"{name} sdf gizmo"] = ("sdf", sdf_kernel_source(scene, gizmo=True))
        # K1's FD form: the same sources built without FMA contraction.
        units[f"{name} sdf_fd"] = ("sdf_fd", sdf_kernel_source(scene))
        units[f"{name} sdf_fd gizmo"] = ("sdf_fd", sdf_kernel_source(scene, gizmo=True))
    many = many_groups_scene()
    units["many sdf"] = ("sdf", sdf_kernel_source(many))
    for label, config in (("exact", EXACT), ("cull", CULLED["renderer_cull"][0]),
                          ("cull dynamic", CULLED["renderer_cull_dynamic"][0])):
        units[f"many march {label}"] = ("march", march_kernel_source(many, config))
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
    # What one K1 evaluation issues, from the built code: the point kernel
    # (one evaluation a thread) and its FD form (seven).
    sass = {}
    for name in ("design1", "design2", "logo"):
        for unit, kernel in (("sdf", "point_eval_kernel"), ("sdf_fd", "point_eval_fd_kernel")):
            so = kbuild._stem(unit, sdf_kernel_source(scenes[name])).with_suffix(".so")
            sass[f"{name} {kernel}"] = sass_counts(str(so), (kernel,)).get(kernel)
    print(json.dumps({"k1_sass": sass}))
    # K3 and K5 as built (redesigned: the grid on lattice columns with the
    # frame terms hoisted, its cull on the lane chain; the cone split across
    # warps): registers and spills, SASS split at the widest loop (K3: one
    # lattice point of a column; K5: one step), the cone's warps a block,
    # and the FP32 operations the column form does, counted from its code.
    k3_k5 = {}
    for name in DESIGNS:
        scene = scenes[name]
        row = dict(cone_warps=cone_warps(scene, HIERARCHICAL.gizmo), column_ops=column_ops(scene))
        for label, unit, source, kernel in (
            ("grid", "sdf", sdf_kernel_source(scene), "grid_eval_kernel"),
            ("grid_cull", "sdf", sdf_kernel_source(scene), "grid_eval_cull_kernel"),
            ("grid_gizmo", "sdf gizmo", sdf_kernel_source(scene, gizmo=True), "grid_eval_kernel"),
            ("grid_cull_gizmo", "sdf gizmo", sdf_kernel_source(scene, gizmo=True),
             "grid_eval_cull_kernel"),
            ("cone", "cone", cone_kernel_source(scene, HIERARCHICAL), "cone_march_kernel"),
        ):
            so = kbuild._stem(unit.split()[0], source).with_suffix(".so")
            code = sass_counts(str(so), (kernel,)).get(kernel) or {}
            row[label] = dict(registers=unit_registers(logs[f"{name} {unit}"], kernel),
                              sass_total=code.get("total"), sass_loop=code.get("loop"))
        k3_k5[name] = row
    print(json.dumps({"k3_k5_units": k3_k5}))
    # K4 and K2 as built: registers and spills (ptxas), K4's resident blocks
    # per SM (by its registers, resident_blocks) and its SASS split at the
    # march loop (before it, one step, after it).
    k4_unit = {}
    for name in DESIGNS:
        source = ray_march_kernel_source(scenes[name], FIT)
        so = kbuild._stem("ray_march", source).with_suffix(".so")
        regs = unit_registers(logs[f"{name} ray_march"], "ray_march_kernel")
        k4_unit[name] = dict(registers=regs, blocks_per_sm=resident_blocks(regs[0], 128),
                             sass=sass_counts(str(so), ("ray_march_kernel",)).get("ray_march_kernel"))
    print(json.dumps({"k4_unit": k4_unit}))
    print(json.dumps({"k2_registers": {
        label: unit_registers(log, "render_kernel") for label, log in logs.items()
        if " march" in label}}))

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
            grid_eval_cull=make_grid_eval(scene, cull=True),
            point_eval_gizmo=make_point_eval(scene, gizmo=True),
            grid_eval_gizmo=make_grid_eval(scene, gizmo=True),
            grid_eval_cull_gizmo=make_grid_eval(scene, gizmo=True, cull=True),
            **{kernel: make_cuda_renderer(scene, config) for kernel, (config, _) in CULLED.items()},
        )
        kernels[name]["point_eval_fd"] = kernels[name]["point_eval"].fd
        kernels[name]["point_eval_fd_gizmo"] = kernels[name]["point_eval_gizmo"].fd
    inputs = {}
    images = {}

    for step, (name, scene) in enumerate(scenes.items()):
        k, a = kernels[name], arrays[name]
        phase(f"{3 + step}a. {name}: point eval and its FD form (2^20 points) and grid eval "
              f"(33x257x257), each without and with the gizmo, vs plain")
        # Design1/2: half their export box; Logo: bench.py's export box.
        half = (scene.export_config.bounding_box_half_diameter / 2.0 if scene.export_config
                else LOGO_EXPORT.bounding_box_half_diameter)
        pts = torch.from_numpy(rng.uniform(-half, half, (1 << 20, 3)).astype(np.float32)).to(dev)
        inputs[name] = dict(pts=pts)
        grid = (a, glo, gcell, gz0, 33, 257)
        for kernel, got, ref in (
            ("point_eval", k["point_eval"](pts, a), k["point_eval"].plain(pts, a)),
            ("grid_eval", k["grid_eval"](*grid), k["grid_eval"].plain(*grid)),
            ("point_eval_gizmo", k["point_eval_gizmo"](pts, a), k["point_eval_gizmo"].plain(pts, a)),
            ("grid_eval_gizmo", k["grid_eval_gizmo"](*grid), k["grid_eval_gizmo"].plain(*grid)),
        ):
            torch.cuda.synchronize()
            err = (got - ref).abs()
            results[(kernel, name)] = dict(max_abs_err=float(err.max()))
            check(bool((err <= 1e-5 + 1e-6 * ref.abs()).all()),
                  f"{name} {kernel} {tuple(got.shape)} max|d| = {float(err.max()):.3g} "
                  f"within 1e-5 + 1e-6|ref|")
        # K1's FD form against its plain version (the plain SDF and the plain
        # FD glue) by the point rule, the SDF and each normal component; and
        # how many values differ at all, also from the point kernel composed
        # with the plain glue (that unit contracts FMAs, this one does not).
        for kernel, single in (("point_eval_fd", "point_eval"), ("point_eval_fd_gizmo", "point_eval_gizmo")):
            fd = k[kernel]
            (sdf, nrm), (sdf_ref, nrm_ref) = fd(pts, a), fd.plain(pts, a)
            torch.cuda.synchronize()
            errs = {}
            for what, got, ref in (("sdf", sdf, sdf_ref), ("normal", nrm, nrm_ref)):
                err = (got - ref).abs()
                errs[what] = float(err.max())
                check(bool(torch.isfinite(got).all()) and bool((err <= 1e-5 + 1e-6 * ref.abs()).all()),
                      f"{name} {kernel} {what} {tuple(got.shape)} max|d| = {errs[what]:.3g} within "
                      f"1e-5 + 1e-6|ref| of its plain version")
            via_point = make_normal_fn(k[single])(pts, a)
            results[(kernel, name)] = dict(
                max_abs_err=max(errs.values()), sdf_max_abs_err=errs["sdf"],
                normal_max_abs_err=errs["normal"],
                values_differing_from_plain=int((sdf != sdf_ref).sum() + (nrm != nrm_ref).sum()),
                normal_max_abs_vs_point_kernel_and_glue=float((nrm - via_point).abs().max()))
            print(f"  {name} {kernel}: {results[(kernel, name)]}")
        if scene.derived_extras:
            # K6: each letter's planes against the rank sum they expand,
            # both plain on the card, over the table and a cell beyond.
            _, tabs = scene.device_extras(dev)
            gx, gy = torch.from_numpy(rng.uniform(-1, 128, (2, 1 << 20)).astype(np.float32)).to(dev)
            for (tname, _), (pname, _) in zip(scene.extras, scene.derived_extras):
                err = float((plane_sample(tabs[pname], gx, gy) - packed_rank_sample(tabs[tname], gx, gy))
                            .abs().max())
                check(err <= 1e-6, f"{name} K6 {pname} vs the rank sum of {tname}: max|d| = {err:.3g} <= 1e-6")
        # The column form against K1 at the same lattice points: both run
        # the same frame terms and brush code (csrc/common.cuh frame_terms),
        # so their values agree wherever nvcc rounds the brush bodies alike.
        lattice = lattice_points(glo, gcell, gz0, 33, 257, 257, dev).reshape(-1, 3).contiguous()
        share = {}
        for grid_kernel, point_kernel in (("grid_eval", "point_eval"),
                                          ("grid_eval_gizmo", "point_eval_gizmo")):
            got, at_points = k[grid_kernel](*grid).reshape(-1), k[point_kernel](lattice, a)
            share[grid_kernel] = float((got == at_points).float().mean())
            results[(grid_kernel, name)]["bit_equal_to_k1_share"] = share[grid_kernel]
        print(json.dumps({f"{name}_k3_vs_k1_bit_equal_share": share}))
        del lattice
        # The gizmo reaches into this slab: the k1 field is below the k2 one.
        gz_grid = k["grid_eval_gizmo"](*grid)
        check(bool((gz_grid < k["grid_eval"](*grid)).any()), f"{name} the gizmo shows in the slab")
        # The culled gizmo grid (the gizmo in its own cull slot) against the
        # unculled gizmo kernel and its plain version at the kernel's tiles.
        counts = {}
        got = k["grid_eval_cull_gizmo"](*grid)
        plain, plain_ms = timed_once(lambda: k["grid_eval_cull_gizmo"].plain(*grid, counts=counts))
        check(bool(torch.equal(got, gz_grid)),
              f"{name} grid_eval_cull_gizmo bit-equal to the unculled gizmo grid kernel")
        err = (got - plain).abs()
        check(bool((err <= 1e-5 + 1e-6 * plain.abs()).all()),
              f"{name} grid_eval_cull_gizmo vs its plain version: max|d| = {float(err.max()):.3g} "
              f"within 1e-5 + 1e-6|ref|")
        results[("grid_eval_cull_gizmo", name)] = dict(
            max_abs_err=float((got - plain).abs().max()), plain_ms=plain_ms,
            skipped_share=cull.skipped_share(counts))
        inputs[name]["gizmo_cull_counts"] = counts

        golden = "; u8 160x120 vs golden" if name in GOLDENS else ""
        phase(f"{3 + step}b. {name}: renderers vs plain at 640x480{golden}")
        exact, exact_plain = k["renderer"](a, *cam), k["renderer"].plain(a, *cam)
        images[name] = dict(exact=exact)
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
            f"{name} cone {tuple(t_safe.shape)}", t_safe, t_plain, HIERARCHICAL.max_distance),
            warps=cone_warps(scene, HIERARCHICAL.gizmo))
        check(bool(torch.equal(t_safe, t_plain)),
              f"{name} cone (CONE_WARPS {results[('cone_march', name)]['warps']}) t_safe bit-equal "
              f"to the plain version's handoffs")
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
        starts = o_proj + t0_cuda[..., None] * project(
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
        images[name].update(hierarchical=hier, overrelax=over)

        phase(f"{3 + step}c. {name}: the fit's ray march vs plain at 640x480 (fit config)")
        o_fit, r_fit = fit_rays(FIT, cam, dev)
        o_fit = torch.as_tensor(o_fit, device=dev)  # on the card, as the fit holds it
        rm = k["ray_march"]
        got = rm(a, o_fit, r_fit)
        # The plain version, timed once, with its step counts for the bound.
        (d_ref, vmin_ref, steps), plain_ms = timed_once(lambda: make_march(scene, FIT)(
            o_fit, r_fit, a, return_closest=True, return_steps=True))
        results[("ray_march", name)] = dict(
            max_abs_err=check_ray_march(f"{name} ray_march", got, (d_ref, vmin_ref)),
            plain_ms=plain_ms)
        check(torch.equal(got[0], d_ref) and torch.equal(got[1], vmin_ref),
              f"{name} ray_march d and vmin bit-equal to the plain version")
        inputs[name].update(o_fit=o_fit, r_fit=r_fit, fit_evals=int(steps.sum()))
        # How busy a warp's lanes stay in K4: a warp is 32 neighbouring rays
        # of a row, and runs as long as its longest march (the plain march's
        # steps), at this size and at `cli fit`'s 64x48.
        simt = {"640x480": warp_simt(steps)}
        small = cli.fit_config(64, 48)
        o_s, r_s = fit_rays(small, cam, dev)
        simt["64x48"] = warp_simt(make_march(scene, small)(
            torch.as_tensor(o_s, device=dev), r_s, a, return_closest=True, return_steps=True)[2])
        print(json.dumps({f"{name}_k4_warp_lane_share": simt}))
        if name == "design1":
            over = make_cuda_ray_march(scene, FIT_OVERRELAX)
            check_ray_march(f"{name} ray_march omega=1.6", over(a, o_fit, r_fit),
                            over.plain(a, o_fit, r_fit))
        if name in GOLDENS:
            small = to_u8(render_scene(scene, config=RenderConfig(width=160, height=120)))
            golden = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}_160x120.npy"))
            frac = float((np.abs(small.cpu().numpy().astype(int) - golden.astype(int)).max(-1) > 2).mean())
            check(frac < 0.002, f"{name} 160x120 u8 pixels off the golden by > 2 levels: {frac:.4%} < 0.2%")

    phase("5d. K7a: the culled kernels (the interval cull inside K2 and K3) vs the unculled "
          "kernel and the plain culled version, 640x480 and the 33x257x257 slab")
    cull_counts = {}  # (kernel, design) -> the plain version's counts at the kernel's tiles
    held_box = {}
    for name, scene in scenes.items():
        k, a = kernels[name], arrays[name]
        t0_plane = inputs[name]["t0"]
        for kernel, (config, unculled) in CULLED.items():
            t0 = t0_plane if unculled == "renderer_t0" else None
            got = k[kernel](a, *cam, t0=t0)
            base = k[unculled](a, *cam, t0=t0)
            counts = {}
            plain, plain_ms = timed_once(lambda: k[kernel].plain(a, *cam, t0=t0, cull_counts=counts))
            same = bool(torch.equal(got, base))
            if same:
                check(True, f"{name} {kernel} bit-equal to the unculled {unculled} kernel")
            else:
                check_render(f"{name} {kernel} vs the unculled {unculled} kernel", got, base)
            results[(kernel, name)] = dict(
                max_abs_err=check_render(f"{name} {kernel} vs its plain version", got, plain),
                plain_ms=plain_ms, bit_equal_to_unculled=same)
            cull_counts[(kernel, name)] = counts
            if kernel.endswith("dynamic"):
                # The held box (march.cuh hold_box): the kernel built with its
                # counters skips another share of the group evaluations than
                # the plain version's per-step cull, with fewer chains; the
                # same frame and the same evaluations.
                stats_frame, c = make_cuda_renderer(scene, config, cull_stats=True)(a, *cam, t0=t0)
                groups = len(counts["group_evals"])
                check(torch.equal(stats_frame, got) and c["evals"] == counts["evals"],
                      f"{name} {kernel} built with its counters: the same frame, "
                      f"{c['evals']} evaluations as the plain version's")
                held_box[f"{name} {kernel}"] = dict(
                    kernel_skipped_share=1.0 - c["group_evals"] / (c["evals"] * groups),
                    kernel_chains=c["chains"], plain_skipped_share=cull.skipped_share(counts),
                    plain_chains=counts["chains"], evals=c["evals"])
        grid = (a, glo, gcell, gz0, 33, 257)
        got, base = k["grid_eval_cull"](*grid), k["grid_eval"](*grid)
        counts = {}
        plain, plain_ms = timed_once(lambda: k["grid_eval_cull"].plain(*grid, counts=counts))
        check(bool(torch.equal(got, base)), f"{name} grid_eval_cull bit-equal to the unculled grid_eval kernel")
        err = (got - plain).abs()
        check(bool((err <= 1e-5 + 1e-6 * plain.abs()).all()),
              f"{name} grid_eval_cull vs its plain version: max|d| = {float(err.max()):.3g} within 1e-5 + 1e-6|ref|")
        results[("grid_eval_cull", name)] = dict(max_abs_err=float((got - plain).abs().max()),
                                                 plain_ms=plain_ms)
        cull_counts[("grid_eval_cull", name)] = counts
        for kernel in list(CULLED) + ["grid_eval_cull"]:
            c = cull_counts[(kernel, name)]
            share = cull.skipped_share(c)
            results[(kernel, name)]["skipped_share"] = share
            print(f"  {name} {kernel}: skipped share {share:.4f} of {c['evals']} evaluations x "
                  f"{len(c['group_evals'])} groups, {c['chains']} chains")
    print(json.dumps({"k7_dynamic_held_box": held_box}))
    # From the default camera the hoisted boxes prune nothing; close up they
    # do, so a box too small would change this frame.
    near_cam = Camera.initial(apply_default_orbit=False).zoom(6.0).as_arrays()
    near, near_base = make_cuda_renderer(scenes["logo"], NEAR_CULLED), make_cuda_renderer(scenes["logo"], NEAR)
    got, counts = near(arrays["logo"], *near_cam), {}
    base = near_base(arrays["logo"], *near_cam)
    check(bool(torch.equal(got, base)) and float((base != 1.0).any(-1).float().mean()) > 0.2,
          "logo close up (max_distance 8): renderer_cull bit-equal to the unculled kernel, "
          "over a fifth of the pixels hit")
    check_render("logo close up renderer_cull vs its plain version", got,
                 near.plain(arrays["logo"], *near_cam, cull_counts=counts))
    share = cull.skipped_share(counts)
    check(share > 0.1, f"logo close up renderer_cull: skipped share {share:.4f} > 0.1")
    # Where it prunes, culled against unculled device ms (A B A B).
    ab = {"cull": [], "unculled": []}
    for _ in range(2):
        for key, fn in (("cull", near), ("unculled", near_base)):
            ab[key].append(device_ms(lambda: fn(arrays["logo"], *near_cam), "render_kernel", iters=20))
    print(json.dumps({"logo_close_up_k7": dict(skipped_share=share, device_ms=ab)}))
    # More cull groups than one 32-bit predicate word holds (89: three words).
    plan = cull.make_cull_plan(many, False)
    many_a = many.arrays.to_torch(dev)
    many_grid = (many_a, np.array([-6.0, -2.5, -1.0], np.float32), np.float32(0.0625), np.float32(0.0),
                 33, 80, 192)
    got, base = make_grid_eval(many, cull=True)(*many_grid), make_grid_eval(many)(*many_grid)
    check(len(plan.groups) == 89 and bool(torch.equal(got, base)) and bool((base < 0).any()),
          f"{len(plan.groups)} cull groups: the culled grid is bit-equal to the unculled grid kernel")
    many_cam = Camera.initial(apply_default_orbit=False).zoom(2.0).as_arrays()
    many_base = make_cuda_renderer(many, EXACT)(many_a, *many_cam)
    for kernel in ("renderer_cull", "renderer_cull_dynamic"):
        counts = {}
        renderer = make_cuda_renderer(many, CULLED[kernel][0])
        got = renderer(many_a, *many_cam)
        check(bool(torch.equal(got, many_base)), f"{len(plan.groups)} cull groups: {kernel} bit-equal "
                                                 f"to the unculled renderer kernel")
        check_render(f"{len(plan.groups)} cull groups: {kernel} vs its plain version", got,
                     renderer.plain(many_a, *many_cam, cull_counts=counts))
        print(f"  {len(plan.groups)} cull groups: {kernel} skipped share {cull.skipped_share(counts):.4f}")

    phase("5e. a scene whose brush has no CUDA body runs on the card through the plain tape")
    custom = custom_brush_scene()
    ev = BatchEvaluator(custom)
    probe_pts = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    vals = ev.eval_sdf_at_points(probe_pts)
    ref = make_primary_sdf(custom)(torch.from_numpy(probe_pts), custom.arrays.to_torch("cpu")).numpy()
    check(ev.sdf_field == "tape-exact" and np.abs(vals - ref).max() <= 1e-5,
          f"custom brush: evaluator field {ev.sdf_field}, max|d| vs the CPU tape "
          f"{np.abs(vals - ref).max():.3g} <= 1e-5")
    small = RenderConfig(width=160, height=120)
    render = make_scene_renderer(custom, small, dev)
    frame = render(custom.arrays.to_torch(dev), *cam)
    check(render.engine == "tape" and bool(torch.isfinite(frame).all()),
          f"custom brush: renderer engine {render.engine}, frame finite")
    check_render("custom brush frame on the card vs on the CPU", frame.cpu(),
                 make_renderer(custom, small)(custom.arrays.to_torch("cpu"), *cam))
    check(BatchEvaluator(scenes["design1"]).sdf_field == "cuda-exact"
          and make_scene_renderer(scenes["design1"], small, dev).engine == "cuda",
          "design1 still takes the kernels (cuda-exact, engine cuda)")

    phase("6. small dense export of Design1 on the card vs the plain CPU path")
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
    # The strategies at 256^3 on the card, before refinement: one triangle
    # set (compact decodes its vertices in float64, the others add in
    # float32: 1e-5 apart at most), and the dense export's extract stage
    # with the native mesh ops beside the numpy ones.
    check(native.available(), "the native mesh ops built (g++) and loaded")
    cfg256 = dataclasses.replace(scene.export_config, grid_level=8, gradient_descent_steps=0)
    soups, extract_s = {}, {}
    for strategy in ("dense", "active", "compact"):
        m, r = export_mesh(scene, cfg256, strategy=strategy)
        check(r.stats["native"] and r.stats["sdf_field"] == "cuda-exact",
              f"256^3 {strategy}: native mesh ops, field {r.stats['sdf_field']}, "
              f"{r.num_triangles} triangles, stages {json.dumps(r.stage_seconds)}")
        soups[strategy] = np.sort(m.triangle_soup().reshape(-1, 9), axis=0)
        extract_s[strategy] = r.stage_seconds["extract"]
    check(np.array_equal(soups["active"], soups["dense"]),
          f"256^3: active's triangle set equals dense's ({len(soups['dense'])} triangles)")
    err = float(np.abs(soups["compact"] - soups["active"]).max())
    check(soups["compact"].shape == soups["active"].shape and err <= 1e-5,
          f"256^3: compact's triangle set equals active's, vertices max|d| {err:.3g} <= 1e-5")
    saved = native.available
    native.available = lambda: False
    try:
        _, r_np = export_mesh(scene, cfg256, strategy="dense")
    finally:
        native.available = saved
    print(json.dumps({"extract_256_dense_seconds": dict(
        native=extract_s["dense"], numpy=r_np.stage_seconds["extract"],
        active=extract_s["active"], compact=extract_s["compact"])}))

    launches = {}  # (kernel, design) -> launches on its main path

    phase("7. main path A, Design1: render, point eval, k1-field queries, bench's 512^3 active "
          "export (launches counted)")
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    image = render_scene(scene)
    refines = {}  # export label -> its refine's launches, vertices and seconds
    evaluator = counting_refine(BatchEvaluator(scene), refines.setdefault("design1_active_512", {}))
    probe = evaluator.eval_sdf_at_points(np.zeros((1, 3), np.float32))
    k1_field, k1_vals, k1_top = k1_field_queries(scene, inputs["design1"]["pts"][:65536].cpu().numpy())
    with tempfile.TemporaryDirectory() as tmp:
        stl, ply = os.path.join(tmp, "design1.stl"), os.path.join(tmp, "design1.ply")
        t1 = time.time()
        mesh, report = export_mesh(
            scene, D1_EXPORT, stl_path=stl, ply_path=ply, evaluator=evaluator, strategy="active"
        )
        export_s = time.time() - t1
        back = writers.read_stl(stl)
        ply_back = writers.read_ply(ply)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counted = dict(kbuild.LAUNCHES)
    print(f"  main path {main_s:.2f} s; launches {counted}")
    check(bool(torch.isfinite(image).all()) and tuple(image.shape) == (480, 640, 3),
          "viewport finite, (480, 640, 3)")
    check(probe[0] < 0, f"sdf at the origin {probe[0]:.4f} < 0 (inside Design1)")
    check(k1_field == "cuda-exact" and np.isfinite(k1_vals).all() and (k1_top > 4.9).all(),
          f"k1-field queries on {k1_field}: finite, the box reaches {k1_top.tolist()}: the gizmo")
    check(back.num_faces == report.num_triangles > 0 and ply_back.num_faces == back.num_faces,
          f"STL/PLY read back: {back.num_faces} triangles")
    check(bool(np.isfinite(mesh.vertices).all()) and mesh.signed_volume() > 0,
          f"mesh finite, volume {mesh.signed_volume():.3f} > 0")
    check(report.stats["native"] and report.stats["strategy"] == "active",
          "512^3 export: active strategy, native mesh ops")
    export_line("design1_active_512", report, export_s)
    check(report.num_triangles == JAX_TRIANGLES["design1_active_512"],
          f"512^3 export: {report.num_triangles} triangles, the JAX package's "
          f"{JAX_TRIANGLES['design1_active_512']}")
    check_triangles("design1_active_512", report.num_triangles)
    check(counted.get("grid_eval") == 20, f"path A: {counted.get('grid_eval')} grid_eval launches == 20")
    # Without the FD form the refine made 7 K1 launches per chunk and step.
    check_refine_launches("design1 512^3 active", refines["design1_active_512"], 100)
    for kernel in ("point_eval", "grid_eval", "renderer", "point_eval_gizmo", "grid_eval_gizmo",
                   "point_eval_fd", "point_eval_fd_gizmo"):
        check(counted.get(kernel, 0) > 0, f"{kernel} launched {counted.get(kernel, 0)} times")
        launches[(kernel, "design1")] = counted[kernel]

    phase("7A'. main path A', `cli export design1` at its defaults (launches counted)")
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(printed):
        stl = os.path.join(tmp, "design1.stl")
        cli.main(["export", "design1", "--stl", stl])
        back = writers.read_stl(stl)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counted = dict(kbuild.LAUNCHES)
    print("  " + printed.getvalue().strip().replace("\n", "\n  "))
    print(f"  main path {main_s:.2f} s; launches {counted}")
    check("strategy: adaptive" in printed.getvalue() and "(sdf field: cuda-exact)" in printed.getvalue(),
          "cli export design1: auto resolved to the adaptive octree on the kernels' field")
    check(back.num_faces > 2000 and np.isfinite(back.vertices).all(),
          f"cli export design1: STL read back, {back.num_faces} triangles")
    check_triangles("cli_export_design1", back.num_faces)
    for kernel in ("point_eval", "grid_eval", "point_eval_fd"):
        check(counted.get(kernel, 0) > 0, f"cli export {kernel} launched {counted.get(kernel, 0)} times")

    for path, name in (("B", "design1"), ("C", "design2")):
        scene = scenes[name]
        extra = (", exact viewport, k2 query, bounding-box scan, k1-field queries, adaptive export "
                 "at its own config" if name == "design2" else "")
        phase(f"8{path}. main path {path}, {name}: `cli render {name} --fast`, "
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
            k1_field, k1_vals, k1_top = k1_field_queries(scene, inputs[name]["pts"][:65536].cpu().numpy())
            with tempfile.TemporaryDirectory() as tmp:
                t1 = time.time()
                d2_mesh, d2_report = export_mesh(
                    scene, stl_path=os.path.join(tmp, "design2.stl"), strategy="adaptive",
                    evaluator=counting_refine(BatchEvaluator(scene), refines.setdefault("design2_adaptive", {})))
                d2_s = time.time() - t1
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
            check(k1_field == "cuda-exact" and np.isfinite(k1_vals).all() and (k1_top > 4.9).all(),
                  f"design2 k1-field queries on {k1_field}: finite, the box reaches {k1_top.tolist()}")
            export_line("design2_adaptive", d2_report, d2_s)
            check_triangles("design2_adaptive", d2_report.num_triangles)
            open_edges = int(boundary_edges(d2_mesh).shape[0])
            check(d2_report.stats["strategy"] == "adaptive" and d2_report.stats["native"]
                  and d2_report.stats.get("open_loops", 0) == 0 and open_edges == 0,
                  f"design2 adaptive export: native mesh ops, zero open loops, {open_edges} boundary "
                  f"edges; levels {d2_report.stats['level_triangles']} (JAX recorded "
                  f"{JAX_DESIGN2_LEVELS}), {d2_report.sdf_evals / 1e6:.1f}M evaluations")
            # The same export on the exact plain tape (every float32 product
            # and sum rounded on its own, where the kernel contracts FMAs):
            # how far rounding alone moves the octree's decisions.
            t1 = time.time()
            _, d2_tape = export_mesh(scene, evaluator=BatchEvaluator(scene, use_kernels=False),
                                     strategy="adaptive")
            export_line("design2_adaptive_plain_tape", d2_tape, time.time() - t1)
            r2 = refines["design2_adaptive"]
            check_refine_launches("design2 adaptive", r2, -(-len(r2["vertices"]) // r2["chunk"]) * r2["steps"])
            expect += ["renderer", "point_eval", "grid_eval", "point_eval_gizmo", "grid_eval_gizmo",
                       "point_eval_fd", "point_eval_fd_gizmo"]
        for kernel in expect:
            check(counted.get(kernel, 0) > 0, f"{name} {kernel} launched {counted.get(kernel, 0)} times")
            launches[(kernel, name)] = counted[kernel]

    phase("8D. main path D, Design1 fit at 640x480: render_target and 10 Adam steps "
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

    phase("8D'. main path D', `cli fit design1` at its defaults (launches counted)")
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

    phase("8E. main path E, Logo: `cli render logo` with and without --fast, over-relaxed "
          "viewport, k2 queries, k1-field queries, the bounding-box scan and bench's adaptive "
          "export on both fields (launches counted)")
    scene, a = scenes["logo"], arrays["logo"]
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    pngs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, flags in (("exact", []), ("hierarchical", ["--fast"])):
            png = os.path.join(tmp, f"logo_{mode}.png")
            cli.main(["render", "logo", *flags, "-o", png])
            pngs[mode] = cli.read_png(png)
    over = render_scene(scene, config=OVERRELAX)
    query = inputs["logo"]["pts"].cpu().numpy()
    k2 = {}
    for field, use_kernels in (("exact", None), ("baked", True)):
        ev = BatchEvaluator(scene, use_kernels=use_kernels)
        k2[field] = (ev.sdf_field, ev.eval_sdf_at_points(query))
    k1_field, k1_vals, k1_top = k1_field_queries(scene, query[:65536], use_kernels=True)
    # `cli export logo --sdf-field baked`'s scan (Logo has no export config).
    center, half_box = autodetect_bounding_box_device(BatchEvaluator(scene, use_kernels=True),
                                                      ExportConfig().bounding_box_half_diameter)
    exports = {}
    with tempfile.TemporaryDirectory() as tmp:
        for field, use_kernels in (("exact", None), ("baked", True)):
            ev = BatchEvaluator(scene, use_kernels=use_kernels)
            if use_kernels:
                counting_refine(ev, refines.setdefault("logo_adaptive_baked", {}))
            t1 = time.time()
            mesh, report = export_mesh(scene, LOGO_EXPORT, stl_path=os.path.join(tmp, f"logo_{field}.stl"),
                                       evaluator=ev, autodetect=False)
            torch.cuda.synchronize()
            exports[field] = (mesh, report, ev, time.time() - t1)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counted = dict(kbuild.LAUNCHES)
    print(f"  main path {main_s:.2f} s; launches {counted}")
    for mode, png in pngs.items():
        same = float((png == to_u8(images["logo"][mode]).cpu().numpy()).all(-1).mean())
        check(png.shape == (480, 640, 3) and same == 1.0,
              f"logo {mode} PNG {png.shape} equals the checked {mode} render on {same:.4%} of pixels")
    check(torch.equal(over, images["logo"]["overrelax"]),
          "logo over-relaxed viewport equals the checked over-relaxed render")
    (field_e, sdf_e), (field_b, sdf_b) = k2["exact"], k2["baked"]
    check(field_e == "tape-exact" and field_b == "cuda-baked",
          f"logo k2 fields: default {field_e}, use_kernels=True {field_b}")
    check(np.isfinite(sdf_e).all() and np.isfinite(sdf_b).all() and (sdf_e < 0).sum() > 100,
          f"logo k2 queries finite on {len(query)} points, {(sdf_e < 0).sum()} inside")
    # The exact tape on the card against the same tape on the CPU (a small
    # sample), and the baked field against the exact one in the band the
    # march sees (tests/test_logo.py:115-117).
    sample = torch.from_numpy(query[:4096])
    cpu = make_primary_sdf(scene)(sample, scene.arrays.to_torch("cpu")).numpy()
    err = float(np.abs(sdf_e[:4096] - cpu).max())
    check(err <= 1e-4, f"logo exact k2 on the card vs the CPU tape, 4096 points: max|d| {err:.3g} <= 1e-4")
    band = (sdf_e > 1e-3) & (sdf_e < 0.1)
    gap = float(np.abs(sdf_b - sdf_e)[band].max())
    check(band.sum() > 200 and gap < scene.twin_tolerance,
          f"logo baked vs exact k2 on {band.sum()} points of the 1e-3..0.1 band: max|d| {gap:.4f} "
          f"< {scene.twin_tolerance}")
    check(np.isfinite(center).all() and 2.5 < half_box < 5.0,
          f"logo bounding box (baked field) centre {center.tolist()}, half {half_box:.4f}")
    check(k1_field == "cuda-baked" and np.isfinite(k1_vals).all() and (k1_top > 4.9).all(),
          f"logo k1-field queries on {k1_field}: finite, the box reaches {k1_top.tolist()}")
    (m_e, r_e, ev_e, s_e), (m_b, r_b, ev_b, s_b) = exports["exact"], exports["baked"]
    export_line("logo_adaptive_exact", r_e, s_e)
    export_line("logo_adaptive_baked", r_b, s_b)
    check_triangles("logo_adaptive_exact", r_e.num_triangles)
    check_triangles("logo_adaptive_baked", r_b.num_triangles)
    check_refine_launches("logo adaptive baked", refines["logo_adaptive_baked"], 50)
    check(r_e.stats["sdf_field"] == "tape-exact" and r_b.stats["sdf_field"] == "cuda-baked"
          and r_b.stats["twin_tolerance"] == scene.twin_tolerance and "twin_tolerance" not in r_e.stats,
          f"logo export fields: {r_e.stats['sdf_field']}, {r_b.stats['sdf_field']} "
          f"(tolerance {r_b.stats['twin_tolerance']})")
    # The fields' normals differ near the letters' edges, so the adaptive
    # octree refines them differently: the counts are compared with the JAX
    # package's per field (the export lines), not with each other.
    open_edges = [int(boundary_edges(m).shape[0]) for m in (m_e, m_b)]
    check(min(m_e.num_faces, m_b.num_faces) > 500 and r_e.stats["strategy"] == "adaptive"
          and r_b.stats["strategy"] == "adaptive" and open_edges == [0, 0]
          and r_e.stats.get("open_loops", 0) == r_b.stats.get("open_loops", 0) == 0,
          f"logo adaptive meshes: {m_e.num_faces} exact and {m_b.num_faces} baked triangles, "
          f"boundary edges {open_edges}, zero open loops")
    # tests/test_logo.py:267-275: each mesh's vertices lie on the other field's
    # zero set within 2x the twin's tolerance.
    tol = 2 * scene.twin_tolerance
    resid_b = float(np.abs(ev_e.eval_sdf_at_points(m_b.vertices)).max())
    resid_e = float(np.abs(ev_b.eval_sdf_at_points(m_e.vertices)).max())
    check(resid_b < tol and resid_e < tol,
          f"logo baked vertices on the exact zero set within {resid_b:.4f}, exact vertices on the "
          f"baked zero set within {resid_e:.4f}, both < {tol}")
    for kernel in ("renderer", "renderer_overrelax", "renderer_t0", "cone_march", "point_eval",
                   "grid_eval", "point_eval_gizmo", "grid_eval_gizmo", "point_eval_fd",
                   "point_eval_fd_gizmo"):
        check(counted.get(kernel, 0) > 0, f"logo {kernel} launched {counted.get(kernel, 0)} times")
        launches[(kernel, "logo")] = counted[kernel]

    phase("8F. main path F, Logo fit at 640x480: render_target and 3 Adam steps per fit_field "
          "(launches counted)")
    start = np.asarray(scene.arrays.position).copy()
    start[1:, 0] += 0.05  # bench.py:300-305
    kbuild.LAUNCHES.clear()
    t0 = time.time()
    fit_logo = {}
    for field in ("exact", "twin"):
        # Names of their own: path D's harness, target and state are timed below.
        h_logo = make_fit_harness(scene, dataclasses.replace(FIT, fit_field=field))
        target_logo = h_logo.render_target(scene.arrays, *cam)
        state_logo = h_logo.init({"position": start})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        losses, step_ms = [], []
        for _ in range(3):
            (state_logo, loss), ms = timed_once(
                lambda: h_logo.step_fn(state_logo, target_logo, *cam))
            losses.append(float(loss))
            step_ms.append(ms)
        moved = float(np.abs(state_logo.params["position"].detach().cpu().numpy() - start).max())
        fit_logo[field] = dict(losses=losses, step_ms=step_ms, moved=moved,
                               peak_mem_bytes=torch.cuda.max_memory_allocated(),
                               peak_above_resident_bytes=torch.cuda.max_memory_allocated() - base_mem)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counted = dict(kbuild.LAUNCHES)
    print(f"  main path {main_s:.2f} s; launches {counted}")
    for field, out in fit_logo.items():
        check(all(np.isfinite(out["losses"])) and out["moved"] > 0,
              f"logo fit [{field}]: losses {out['losses']} finite, positions moved {out['moved']:.3g}")
    check(counted.get("ray_march") == 8, f"logo fit: ray_march launched {counted.get('ray_march')} "
                                         f"times == 8 (2 targets + 6 steps)")
    launches[("ray_march", "logo")] = counted["ray_march"]
    print(json.dumps({"fit_step_logo": fit_logo}))

    for name in ("logo", "design2", "design1"):
        phase(f"8G. main path G, {name}: render_scene with march_cull 'dynamic' and True, each "
              f"from the camera and hierarchical at omega = 1.6, and the culled grid over the "
              f"33x257x257 slab (launches counted)")
        scene, a = scenes[name], arrays[name]
        kbuild.LAUNCHES.clear()
        t0 = time.time()
        frames_g = {kernel: render_scene(scene, config=CULLED[kernel][0]) for kernel in CULLED}
        grid_g = make_grid_eval(scene, cull=True)(a, glo, gcell, gz0, 33, 257)
        grid_gz = make_grid_eval(scene, gizmo=True, cull=True)(a, glo, gcell, gz0, 33, 257)
        torch.cuda.synchronize()
        main_s = time.time() - t0
        counted = dict(kbuild.LAUNCHES)
        print(f"  main path {main_s:.2f} s; launches {counted}")
        for kernel, image in frames_g.items():
            ref = images[name]["exact" if CULLED[kernel][1] == "renderer" else "hierarchical"]
            same = bool(torch.equal(image, ref))
            if same:
                check(True, f"{name} {kernel} frame bit-equal to the checked unculled frame")
            else:
                check_render(f"{name} {kernel} frame vs the checked unculled frame", image, ref)
        ref = kernels[name]["grid_eval"](a, glo, gcell, gz0, 33, 257)
        check(bool(((grid_g - ref).abs() <= 1e-5 + 1e-6 * ref.abs()).all()),
              f"{name} culled grid within 1e-5 + 1e-6|ref| of the unculled grid")
        ref = kernels[name]["grid_eval_gizmo"](a, glo, gcell, gz0, 33, 257)
        check(bool(((grid_gz - ref).abs() <= 1e-5 + 1e-6 * ref.abs()).all()),
              f"{name} culled gizmo grid within 1e-5 + 1e-6|ref| of the unculled gizmo grid")
        check(counted.get("cone_march") == 2, f"{name} cone_march launched {counted.get('cone_march')} "
                                              f"times == 2 (the two hierarchical frames)")
        for kernel in list(CULLED) + ["grid_eval_cull", "grid_eval_cull_gizmo"]:
            check(counted.get(kernel) == 1, f"{name} {kernel} launched {counted.get(kernel)} times == 1")
            launches[(kernel, name)] = counted[kernel]

    phase("8H. slice 10: the studio, the viewer, cli watch, profile_trace, the compacted "
          "renderer on Logo, analytic normals and the dynamic tape (launches counted per part)")
    print(json.dumps({"slice10": slice10_phase(scenes, arrays, kernels, smi)}))

    phase("9. timing (CUDA events, after warm-up)")
    frames = {}
    for name, scene in scenes.items():
        k, a, x = kernels[name], arrays[name], inputs[name]
        calls = {}  # kernel -> (a call, the CUDA kernel's name), for the cross-check
        ops = tape_ops(scene)
        # Logo's planes are an input of every kernel, read once.
        tables = kernel_tables(scene)
        pts, n_pts = x["pts"], x["pts"].shape[0]
        n_grid = 33 * 257 * 257
        n_px = EXACT.width * EXACT.height
        r = results
        calls["point_eval"] = (lambda: k["point_eval"](pts, a), "point_eval_kernel")
        r[("point_eval", name)].update(
            ms=cuda_ms(lambda: k["point_eval"](pts, a), 100),
            enqueue_ms=enqueue_ms(lambda: k["point_eval"](pts, a)),
            plain_ms=cuda_ms(lambda: k["point_eval"].plain(pts, a), 3),
        )
        r[("point_eval", name)].update(
            zip(("bound_ms", "bound_by"), bound_ms(16 * n_pts + tables, ops * n_pts)), tape_evals=n_pts)
        grid = (a, glo, gcell, gz0, 33, 257)
        calls["grid_eval"] = (lambda: k["grid_eval"](*grid), "grid_eval_kernel")
        r[("grid_eval", name)].update(
            ms=cuda_ms(lambda: k["grid_eval"](*grid), 100),
            enqueue_ms=enqueue_ms(lambda: k["grid_eval"](*grid)),
            plain_ms=cuda_ms(lambda: k["grid_eval"].plain(*grid), 3),
        )
        # K3's work is its column form's (column_ops): per point the tape
        # with the hoisted slots' frame rows, per column the hoisted terms,
        # once (the kernel makes them once per z range of a column).
        col = column_ops(scene)
        col_ops = col["column_form_ops"]
        terms_ops = col["per_column_ops"] * 257 * 257
        r[("grid_eval", name)].update(
            zip(("bound_ms", "bound_by"), bound_ms(4 * n_grid + tables, col_ops * n_grid + terms_ops)),
            tape_evals=n_grid, fp32_ops_per_point=col_ops, z_ranges=grid_ranges(scene, 33, 257, 257))
        # K1 and K3 with the gizmo: the tape, the gizmo (GIZMO_OPS, counted
        # from common.cuh's gizmo_sdf) and the min of the two per point.
        gops = ops + GIZMO_OPS + 1
        for kernel, kname, fn, args, n, n_bytes, n_ops in (
            ("point_eval_gizmo", "point_eval_kernel", k["point_eval_gizmo"], (pts, a), n_pts,
             16 * n_pts + tables, gops * n_pts),
            ("grid_eval_gizmo", "grid_eval_kernel", k["grid_eval_gizmo"], grid, n_grid,
             4 * n_grid + tables, (col_ops + GIZMO_OPS + 1) * n_grid + terms_ops),
        ):
            calls[kernel] = (lambda fn=fn, args=args: fn(*args), kname)
            r[(kernel, name)].update(ms=cuda_ms(calls[kernel][0], 100), enqueue_ms=enqueue_ms(calls[kernel][0]),
                                     plain_ms=cuda_ms(lambda fn=fn, args=args: fn.plain(*args), 3),
                                     tape_evals=n)
            r[(kernel, name)].update(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, n_ops)))
        # K1's FD form at the same points: seven tape evaluations and the FD
        # glue per point, 12 B read and 16 B written.
        for kernel, per_point in (("point_eval_fd", 7 * ops + FD_GLUE_OPS),
                                  ("point_eval_fd_gizmo", 7 * gops + FD_GLUE_OPS)):
            fd = k[kernel]
            calls[kernel] = (lambda fd=fd: fd(pts, a), "point_eval_fd_kernel")
            r[(kernel, name)].update(ms=cuda_ms(calls[kernel][0], 50), enqueue_ms=enqueue_ms(calls[kernel][0]),
                                     plain_ms=cuda_ms(lambda fd=fd: fd.plain(pts, a), 2),
                                     tape_evals=7 * n_pts)
            r[(kernel, name)].update(zip(("bound_ms", "bound_by"),
                                         bound_ms(28 * n_pts + tables, per_point * n_pts)))

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
            calls[kernel] = (call, "render_kernel")
            r[(kernel, name)].update(
                ms=cuda_ms(call, 20),
                enqueue_ms=enqueue_ms(call),
                plain_ms=cuda_ms(lambda: plain(a, *cam, t0=t0), 2),
            )
            d, steps = make_march(scene, config)(rows[0], r_proj, a, return_steps=True, t0=t0)
            evals = int(steps.sum()) + 6 * int((d > 0).sum())
            n_bytes = (12 + (4 if t0 is not None else 0)) * n_px + tables
            r[(kernel, name)].update(zip(("bound_ms", "bound_by"),
                                         bound_ms(n_bytes, evals * (ops + GIZMO_OPS))),
                                     tape_evals=evals)
            print(f"  {name} {kernel}: {evals} tape evals ({evals / n_px:.1f}/pixel), "
                  f"{n_px / r[(kernel, name)]['ms'] / 1e3:.2f} Mrays/s")
        o_proj, rays = x["o_proj"], x["rays"]
        cone = k["cone_march"]
        calls["cone_march"] = (lambda: cone(a, o_proj, rays), "cone_march_kernel")
        r[("cone_march", name)].update(
            ms=cuda_ms(lambda: cone(a, o_proj, rays), 50),
            enqueue_ms=enqueue_ms(lambda: cone(a, o_proj, rays)),
            plain_ms=cuda_ms(lambda: cone.plain(a, o_proj, rays), 2),
        )
        _, steps = cone.plain(a, o_proj, rays, return_steps=True)
        n_rays = rays.numel() // 3
        r[("cone_march", name)].update(zip(("bound_ms", "bound_by"), bound_ms(
            16 * n_rays + tables, int(steps.sum()) * (ops + GIZMO_OPS))),
            tape_evals=int(steps.sum()))
        print(f"  {name} cone_march: {int(steps.sum())} tape evals over {n_rays} rays "
              f"({int(steps.sum()) / n_rays:.1f}/ray)")
        # The fit's ray march: the tape evaluations of this march (no gizmo),
        # 12 B of ray read and 16 B (d, vmin) written per ray.
        rm, o_fit, r_fit = k["ray_march"], x["o_fit"], x["r_fit"]
        calls["ray_march"] = (lambda: rm(a, o_fit, r_fit), "ray_march_kernel")
        r[("ray_march", name)].update(
            ms=cuda_ms(lambda: rm(a, o_fit, r_fit), 20),
            enqueue_ms=enqueue_ms(lambda: rm(a, o_fit, r_fit)),
        )
        n_rays = r_fit.numel() // 3
        r[("ray_march", name)].update(zip(("bound_ms", "bound_by"), bound_ms(
            28 * n_rays + tables, x["fit_evals"] * ops)), tape_evals=x["fit_evals"])
        print(f"  {name} ray_march: {x['fit_evals']} tape evals over {n_rays} rays "
              f"({x['fit_evals'] / n_rays:.1f}/ray), {json.dumps(r[('ray_march', name)])}")
        # K7: the culled kernels beside the unculled ones.  Their work is the
        # unculled work less the skipped groups' slots, plus one chain per
        # tile (per tile and step in the dynamic mode), all counted by the
        # plain version at the kernel's tiles (phase 5d); the chain's FP32
        # operations are counted from the generated code and printed on a
        # line of their own, beside the tape's.
        chain_model = {}
        for kernel, (config, unculled) in CULLED.items():
            t0 = t0_plane if unculled == "renderer_t0" else None
            call = (lambda kernel=kernel, t0=t0: k[kernel](a, *cam, t0=t0))
            calls[kernel] = (call, "render_kernel")
            chain = cull_chain_ops(scene, config.gizmo)
            n_ops = culled_ops(cull_counts[(kernel, name)], ops + GIZMO_OPS,
                               group_ops(scene, k[kernel].plain.culler), chain)
            n_bytes = (12 + (4 if t0 is not None else 0)) * n_px + tables
            chain_model[kernel] = dict(chain_ops=chain, tape_ops=ops + GIZMO_OPS,
                                       lane_chain=lane_chain_ops(scene, config.gizmo))
            r[(kernel, name)].update(ms=cuda_ms(call, 20), enqueue_ms=enqueue_ms(call),
                                     unculled_ms=r[(unculled, name)]["ms"],
                                     chains=cull_counts[(kernel, name)]["chains"],
                                     tape_evals=cull_counts[(kernel, name)]["evals"])
            r[(kernel, name)].update(zip(("bound_ms", "bound_by"), bound_ms(n_bytes, n_ops)))
        # The culled grid's work: per evaluated group its z loop's form's
        # (grid_cull_column: the column form's, or the point form's), the
        # chains, and in the column form the hoisted terms of each group
        # once per lattice column whose tiles keep it (the kernel makes
        # them once per tile of a column), those of ungrouped slots once per
        # column; all counted by the plain version at the kernel's tiles.
        def culled_grid_ops(counts, culler, gizmo):
            column = grid_cull_column(scene, gizmo)
            point_ops = (col_ops if column else ops) + (GIZMO_OPS + 1 if gizmo else 0)
            n_ops = culled_ops(counts, point_ops, group_ops(scene, culler, column=column),
                               cull_chain_ops(scene, gizmo))
            if column:
                hoisted = column_hoisted(scene)
                grouped = {k for members in culler.groups for k in members}
                n_ops += FRAME_TERMS_OPS * (
                    sum(c * sum(k in hoisted for k in members)
                        for c, members in zip(counts["column_group_evals"], culler.groups))
                    + 257 * 257 * sum(k not in grouped for k in hoisted))
            return n_ops, point_ops

        for kernel, gizmo, counts, unculled in (
            ("grid_eval_cull", False, cull_counts[("grid_eval_cull", name)], "grid_eval"),
            ("grid_eval_cull_gizmo", True, x["gizmo_cull_counts"], "grid_eval_gizmo"),
        ):
            gc = k[kernel]
            calls[kernel] = (lambda gc=gc: gc(*grid), "grid_eval_cull_kernel")
            n_ops, point_ops = culled_grid_ops(counts, gc.culler, gizmo)
            chain_model[kernel] = dict(chain_ops=cull_chain_ops(scene, gizmo), tape_ops=point_ops,
                                       lane_chain=lane_chain_ops(scene, gizmo),
                                       column_form=grid_cull_column(scene, gizmo))
            r[(kernel, name)].update(
                ms=cuda_ms(calls[kernel][0], 100), enqueue_ms=enqueue_ms(calls[kernel][0]),
                unculled_ms=r[(unculled, name)]["ms"], chains=counts["chains"], tape_evals=n_grid)
            r[(kernel, name)].update(zip(("bound_ms", "bound_by"), bound_ms(4 * n_grid + tables, n_ops)))
        for kernel in list(CULLED) + ["grid_eval_cull", "grid_eval_cull_gizmo"]:
            print(f"  {name} {kernel}: {r[(kernel, name)]['ms']:.4f} ms, unculled "
                  f"{r[(kernel, name)]['unculled_ms']:.4f} ms, skipped share "
                  f"{r[(kernel, name)]['skipped_share']:.4f}")
        # Counts from the generated code, not measurements: FP32 operations
        # of one chain and of one tape evaluation of each culled kernel.
        print(json.dumps({f"{name}_k7_chain_ops_model": chain_model}))
        # Every kernel's time read three ways (events over N calls, events
        # around single calls, the profiler's records): the events time per
        # call ("ms") and the profiler's ("device_ms") disagree on some rows.
        cross = {kernel: crosscheck(fn, kname) for kernel, (fn, kname) in calls.items()}
        for kernel, c in cross.items():
            # A unit with its bank in constant memory runs its bank fill
            # (csrc/common.cuh interleave_bank_kernel and a copy) before
            # each launch; its device_ms includes it.
            r[(kernel, name)].update(single_ms=c["single_ms"],
                                     device_ms=call_device_ms(c["profiler"], calls[kernel][1]),
                                     bank_fill=[f for f in BANK_FILL if f in c["profiler"]] or None)
        print(json.dumps({f"{name}_timing_crosscheck": cross}))
        hier = k["hierarchical"]
        frame_ms = cuda_ms(lambda: hier(a, *cam), 20)
        frame_kernels = kernel_records(lambda: hier(a, *cam),
                                       ("render_kernel", "cone_march_kernel") + BANK_FILL)
        frames[name] = dict(
            exact_ms=r[("renderer", name)]["ms"],
            overrelax_ms=r[("renderer_overrelax", name)]["ms"],
            hierarchical_frame_ms=frame_ms,
            hierarchical_enqueue_ms=enqueue_ms(lambda: hier(a, *cam)),
            hierarchical_single_ms=single_ms(lambda: hier(a, *cam)),
            hierarchical_device_ms=sum(v["mean_ms"] for v in frame_kernels.values()),
            hierarchical_kernel_records=frame_kernels,
            hierarchical_plain_ms=cuda_ms(lambda: hier.plain(a, *cam), 2),
        )
        if scene.extras:
            # A model, not a measurement: the time K6's table reads alone
            # would take at the assumed L1 rate and the largest SM clock.
            per_eval = table_bytes(scene)
            rate = L1_BYTES_PER_CLOCK * sms * sm_clock_hz
            print(json.dumps({f"{name}_k6_table_read_model": dict(
                assumed_l1_bytes_per_clock_per_sm=L1_BYTES_PER_CLOCK, sms=sms,
                max_sm_clock_mhz=sm_clock_hz / 1e6, table_bytes_per_tape_eval=per_eval,
                model_ms={kernel: per_eval * r[(kernel, name)]["tape_evals"] / rate * 1e3
                          for kernel in SOURCES})}))
            # K6's reads against its FP32 work: the same 2^20 points in
            # random order (a warp's 32 table columns scattered over a
            # 512 B row) and sorted by 0.05-unit cell (neighbouring columns).
            cells = np.floor(pts.cpu().numpy() / 0.05).astype(np.int64)
            order = np.lexsort((cells[:, 0], cells[:, 1], cells[:, 2]))
            pts_sorted = pts[torch.from_numpy(order).to(dev)].contiguous()
            locality = {key: cuda_ms(lambda: k["point_eval"](p, a), 50)
                        for key, p in (("random", pts), ("sorted", pts_sorted),
                                       ("random_again", pts), ("sorted_again", pts_sorted))}
            print(json.dumps({f"{name}_point_eval_ms_by_order": locality}))
        frames[name]["mrays_per_s"] = {
            mode: n_px / frames[name][key] / 1e3
            for mode, key in (("exact", "exact_ms"), ("overrelax", "overrelax_ms"),
                              ("hierarchical", "hierarchical_frame_ms"))
        }
        print(f"  {name} frames: {json.dumps(frames[name])}")

    # K1 at the batches its main paths give it: each chunk of the vertices
    # an export's refine took (path A: 2^20 and the remainder; Design2's
    # adaptive export; Logo's baked one), in mesh order, by the FD form and
    # by single evaluations, and one refine step made of seven point
    # launches and the plain FD glue beside one FD launch.  Per row,
    # the refine's launches x (FD ms - FD bound).
    batches = {}
    for label, name in (("design1_active_512", "design1"), ("design2_adaptive", "design2"),
                        ("logo_adaptive_baked", "logo")):
        ref, a, k = refines[label], arrays[name], kernels[name]
        ops, tables = tape_ops(scenes[name]), kernel_tables(scenes[name])
        verts = torch.from_numpy(ref["vertices"]).to(dev)
        pe, fd = k["point_eval"], k["point_eval_fd"]
        normal_glue = make_normal_fn(pe)
        for start in range(0, len(verts), ref["chunk"]):
            p = verts[start:start + ref["chunk"]].contiguous()
            n = p.shape[0]
            row = dict(points=n, launches_on_path=ref["steps"])
            for kernel, fn, kname, per_point, n_bytes in (
                ("point_eval", lambda p=p: pe(p, a), "point_eval_kernel", ops, 16),
                ("point_eval_fd", lambda p=p: fd(p, a), "point_eval_fd_kernel",
                 7 * ops + FD_GLUE_OPS, 28),
            ):
                b_ms, by = bound_ms(n_bytes * n + tables, per_point * n)
                row[kernel] = dict(ms=cuda_ms(fn, 50), device_ms=device_ms(fn, kname, iters=20),
                                   bound_ms=b_ms, bound_by=by)
            row["step_ms_seven_launches"] = cuda_ms(lambda p=p: (pe(p, a), normal_glue(p, a)), 20)
            row["step_ms_fd"] = row["point_eval_fd"]["ms"]
            row["excess_ms_on_path"] = ref["steps"] * (row["point_eval_fd"]["ms"] - row["point_eval_fd"]["bound_ms"])
            batches[f"{label}[{start}:{start + n}]"] = row
    print(json.dumps({"k1_path_batches": batches}))

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
    sdf = make_primary_sdf(scenes["design1"])
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

    line = []
    for name in DESIGNS:
        # Logo's rows run K6 inside: its source and the TPU function it replaces.
        k6 = {}
        if scenes[name].extras:
            k6 = dict(inlines=K6_SOURCE[0], inlines_replaces=K6_SOURCE[1])
        # The culled rows run K7's generated chain inside.
        k7 = dict(cull_inlines=K7_SOURCE[0], cull_inlines_replaces=K7_SOURCE[1])
        # The gizmo rows also run the k1 gizmo (csrc/common.cuh gizmo_sdf).
        gizmo = dict(gizmo_inlines="designcsg_tpu_torch/csrc/common.cuh",
                     gizmo_inlines_replaces="designcsg_tpu/ops/pallas/tape.py:109")
        line += [
            dict(name=kernel, design=name, route="cuda", source=SOURCES[kernel][0],
                 replaces=SOURCES[kernel][1], launches=launches[(kernel, name)], library_ms=None,
                 **k6, **(k7 if "cull" in kernel else {}), **(gizmo if "gizmo" in kernel else {}),
                 **results[(kernel, name)])
            for kernel in SOURCES
            if (kernel, name) in launches
        ]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"chip_smoke_seconds": time.time() - run_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
