#!/usr/bin/env python3
"""A/B of the port's renderer kernels (exact, over-relaxed, from a t0
plane, and culled: hoisted and dynamic, from the camera and from the t0
plane), its grid kernel, its point kernel (K1, and its FD form where the
tree has one), its cone prepass (K5), the fit's ray march (K4) and the
export's refine between two trees of this repository, on one card, in one
run:

    python3 ab_render_timing.py PARENT_DIR [--out RESULTS.json] [--parts cone,grid]

``PARENT_DIR`` is another checkout (e.g. ``git archive <commit>`` unpacked into
an ignored directory).  The trees run in the order parent, change, change,
parent, each in a process of its own with that tree first on ``sys.path`` and
its own build directory.  Per tree and design it prints each kernel's time by
CUDA events (mean over back-to-back calls) and by torch.profiler (mean of its
records) and the ``-Xptxas -v`` registers of the kernel: the renderers at
640x480, the grid over a 33x257x257 slab, K1 at 2^20 uniform points in the
design's box, K5 on the hierarchical frame's block rays, K4 on the fit's
640x480 rays (bench.py's fit configuration); and the seconds of
``BatchEvaluator.refine_on_device`` (the kernels' field) over 2^20 + 40,000
such points and 50 steps, two chunks as in bench.py's 512^3 export, with
the launches it made.  One kernel per profiler window.  A unit whose object
bank lies in constant memory fills it before each launch (csrc/common.cuh
``prepare_bank``: ``interleave_bank_kernel`` and a device-to-device copy to
the symbol); its device ms is the kernel's mean record plus the fill's
(``bank_ms``, also printed), so both trees are timed for the same work.

K3 runs in all four forms (unculled and culled, without and with the
gizmo), K5 takes the origin where that tree's wrapper reads it without a
copy (on the card, or on the host for a tree whose kernel takes it by
value), and per design the hierarchical frame is timed by events and by
the host's enqueue; each kernel's registers and its SASS instructions (in
total and, where the kernel loops, in one pass of its widest loop: one
lattice point of K3's column, one step of K5) are printed beside its times.
Every tree also runs the exports of the smoke run's main paths (bench.py's
Design1 512^3 ``active``, ``cli export design1``, Design2's adaptive export
and Logo's on both fields) and reports their triangle counts; the grids and
cones of the first parent and change runs are saved and compared value by
value (the share of bit-equal values and max|d|).

Levers, timed beside each tree's own units in the same process: in a tree
whose cone kernel splits across warps (``CONE_WARPS``), K5 at every split
S in 0 (one thread a ray), 1, 2, 4 and 8, each checked bit-equal to the
plain version, K3's unculled grid, with and without the gizmo, without
its two-blocks-an-SM launch bound (``__launch_bounds__(SDF_THREADS, 2)``),
and its culled grid, with and without the gizmo, with the tile's chain on
the other side of ``GRID_CULL_LANES`` (the first warp's lanes, or one
thread), its z loop in the other form of ``GRID_CULL_COLUMN`` (the
column form, or the point form), and both; K4 with
``__launch_bounds__(128, 4)`` and ``(128, 8)`` (at most 128 and 64
registers), in a tree whose K4 source declares ``__launch_bounds__(RAY_THREADS)``;
in a tree with the generated ``BANK_CONSTANT``, every renderer mode and K4
with the other bank placement, the dynamic cull with other margins of its
held box (``CULL_HOLD``) and with the one-thread chain (``cull_tile``)
in place of its lane chain, and K1, K3 and K5 with the constant bank.  Compare two trees only
within one run: the card's clocks and power limit move between runs.
``--parts`` times only some of the run's parts (``PARTS_ALL``: the
renderers; K5 and the hierarchical frame; K3; K1, K4 and the refine; the
exports), each as in a whole run.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

CHILD = r'''
import dataclasses, json, re, time
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.ops.cuda.march_kernel import (make_cuda_cone_march, make_cuda_ray_march,
                                                       make_cuda_renderer)
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.cuda import march_kernel as mk, sdf_kernel as sk
from designcsg_tpu_torch.ops.cuda.tape import (cone_kernel_source, march_kernel_source,
                                               ray_march_kernel_source, sdf_kernel_source)
from designcsg_tpu_torch.ops.raymarch import camera_rows, coarse_ray_uv, project, ray_directions
from designcsg_tpu_torch import cli
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.evaluator import BatchEvaluator as _BE
from designcsg_tpu_torch.export import writers
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_hierarchical_renderer
from chip_smoke import sass_counts
import os, tempfile

dev = torch.device("cuda")
cam = Camera.initial().as_arrays()
HIER = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
MODES = (("exact", RenderConfig()), ("overrelax", RenderConfig(march_overrelax=1.6)), ("t0", HIER),
         ("hoisted", RenderConfig(march_cull=True)), ("dynamic", RenderConfig(march_cull="dynamic")),
         ("t0 hoisted", dataclasses.replace(HIER, march_cull=True)),
         ("t0 dynamic", dataclasses.replace(HIER, march_cull="dynamic")))
FIT = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
FD = "sdf_fd" in kbuild.EXTRA_FLAGS  # this tree has K1's FD form
LB = "__launch_bounds__(RAY_THREADS)"
LEVERS = "#define BANK_CONSTANT" in march_kernel_source(get_design("design2"), RenderConfig())
HOLD = "CULL_HOLD" in march_kernel_source(get_design("design2"), RenderConfig(march_cull="dynamic"))
# The dynamic cull's chain call (march.cuh march_dynamic) and the one-thread
# chain that can take its place.
LANES = "cull_tile_lanes(held.x, held.y, held.z, lane_bank, ad, ex, tile.preds, tile.substs);"
ONE_THREAD = "cull_tile(held.x, held.y, held.z, bank, ad, ex, tile.preds, tile.substs);"
SPLIT = "#define CONE_WARPS" in cone_kernel_source(get_design("design2"), HIER)
# The cone kernel reads the origin on the card (a device pointer) in a tree
# with the split; before it took three floats, copied to the host.
CONE_ORIGIN_ON_CARD = SPLIT
# The culled grid's levers: each of its generated switches flipped (the
# tile's chain on the lanes or in one thread, the z loop's column or point
# form), and both.
CULL_LEVERS = ("GRID_CULL_LANES", "GRID_CULL_COLUMN", "GRID_CULL_LANES+GRID_CULL_COLUMN")
# The unculled grid kernel's launch bound (at most 128 registers: two blocks
# of 256 an SM) and the lever without it.
GRID_LB = "__launch_bounds__(SDF_THREADS, 2)\ngrid_eval_kernel("
NO_GRID_LB = "__launch_bounds__(SDF_THREADS)\ngrid_eval_kernel("
GRID = (np.full(3, -3.5, np.float32), np.float32(7.0 / 256), 112.0, 33, 257)
SAVE = os.environ.get("AB_SAVE")  # directory for the grids and cones compared across trees
PARTS = set(os.environ["AB_PARTS"].split(","))  # which of PARTS_ALL this run times


def registers(log, kernel):
    """ptxas's register count of ``kernel`` in a unit's -Xptxas -v report."""
    m = re.search(r"entry function '[^']*" + kernel + r"[^']*'.*?Used (\d+) registers", log, re.S)
    return int(m.group(1)) if m else None


def events_ms(fn, n=50):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


BANK_FILL = ("interleave_bank_kernel", "Memcpy DtoD")


def device_ms(fn, name, n=20):
    """(the mean record of kernel ``name`` plus the mean of each bank-fill
    record, the bank fill's part, the names of every device record) over
    ``n`` calls of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def mean(key):
        d = [(e.time_range.end - e.time_range.start) / 1e3 for e in recs if key in e.name]
        return sum(d) / len(d) if d else 0.0

    kernel = mean(name)
    fill = sum(mean(f) for f in BANK_FILL)
    return (kernel + fill if kernel else None), fill, sorted({e.name for e in recs})


def timed(call, kernel, regs, n=50):
    dev_ms, bank_ms, names = device_ms(call, kernel)
    return dict(ms=events_ms(call, n), device_ms=dev_ms, bank_ms=bank_ms, records=names,
                registers=regs)


def variant(module, fn_name, transform, make, first_call):
    """A wrapper made by ``make()`` whose unit is ``transform`` of the
    tree's source (``module.fn_name``), built and loaded by ``first_call``."""
    orig = getattr(module, fn_name)
    setattr(module, fn_name, lambda *a, **k: transform(orig(*a, **k)))
    try:
        w = make()
        first_call(w)
        return w
    finally:
        setattr(module, fn_name, orig)


def toggle(src, name):
    """``src`` with the generated ``#define name 0/1`` flipped."""
    on = f"#define {name} 1" in src
    return src.replace(f"#define {name} {int(on)}", f"#define {name} {int(not on)}")


def other_bank(src):
    return toggle(src, "BANK_CONSTANT")


def sass(unit, source, kernel):
    """(SASS instructions of ``kernel`` in total, in one pass of its widest
    loop or None)."""
    c = sass_counts(str(kbuild._stem(unit, source).with_suffix(".so")), (kernel,)).get(kernel) or {}
    return c.get("total"), (c.get("loop") or {}).get("inside", {}).get("total")


def enqueue_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e3
    torch.cuda.synchronize()
    return host


def save(name, t):
    if SAVE:
        np.save(os.path.join(SAVE, name + ".npy"), t.cpu().numpy())


def exports():
    """Triangle counts of the smoke run's main-path exports."""
    out = {}
    d1, d2, logo = (get_design(n) for n in ("design1", "design2", "logo"))
    with tempfile.TemporaryDirectory() as tmp:
        _, r = export_mesh(d1, ExportConfig(bounding_box_half_diameter=10.0, grid_level=9,
                                            gradient_descent_steps=50), strategy="active")
        out["design1_active_512"] = r.num_triangles
        stl = os.path.join(tmp, "d1.stl")
        cli.main(["export", "design1", "--stl", stl])
        out["cli_export_design1"] = writers.read_stl(stl).num_faces
        _, r = export_mesh(d2, strategy="adaptive")
        out["design2_adaptive"] = r.num_triangles
        cfg = ExportConfig(bounding_box_half_diameter=3.5, grid_level=7, minimum_octree_level=5,
                           maximum_octree_level=7, gradient_descent_steps=50)
        for field, use in (("exact", None), ("baked", True)):
            _, r = export_mesh(logo, cfg, evaluator=_BE(logo, use_kernels=use), autodetect=False)
            out[f"logo_adaptive_{field}"] = r.num_triangles
    return out


def cone_and_frame(n, s, a, cone, o_cone, rays, rows):
    """K5 and its split levers, and the hierarchical frame."""
    call = lambda: cone(a, o_cone, rays)
    cone_src = cone_kernel_source(s, HIER)
    cone_logs = kbuild.build({"cone": ("cone", cone_src)})
    out[f"{n} cone"] = dict(timed(call, "cone_march_kernel", registers(cone_logs["cone"], "cone_march_kernel"), 100),
                            sass=sass("cone", cone_src, "cone_march_kernel"))
    t_cone = cone(a, o_cone, rays)
    t_plain = cone.plain(a, rows[0], rays)
    out[f"{n} cone"]["bit_equal_to_plain"] = bool(torch.equal(t_cone, t_plain))
    save(f"{n}_cone", t_cone)
    if SPLIT:
        splits = {w: cone_kernel_source(s, HIER, warps=w) for w in (0, 1, 2, 4, 8)}
        split_logs = kbuild.build({f"cone S{w}": ("cone", src) for w, src in splits.items()})
        for w, src in splits.items():
            c = variant(mk, "cone_kernel_source", lambda _, src=src: src,
                        lambda: make_cuda_cone_march(s, HIER), lambda w_: w_(a, o_cone, rays))
            out[f"{n} cone S{w}"] = dict(
                timed(lambda c=c: c(a, o_cone, rays), "cone_march_kernel",
                      registers(split_logs[f"cone S{w}"], "cone_march_kernel"), 100),
                sass=sass("cone", src, "cone_march_kernel"),
                bit_equal_to_plain=bool(torch.equal(c(a, o_cone, rays), t_plain)))
    hier = make_cuda_hierarchical_renderer(s, HIER)
    out[f"{n} hierarchical frame"] = dict(ms=events_ms(lambda: hier(a, *cam), 20),
                                          enqueue_ms=enqueue_ms(lambda: hier(a, *cam)))


def culled_source(s, gizmo):
    """The unit that carries K3's culled grid: a unit of its own in a tree
    whose point/grid unit makes no cull plan, else that unit."""
    try:
        return sdf_kernel_source(s, gizmo=gizmo, cull=True)
    except TypeError:
        return sdf_kernel_source(s, gizmo=gizmo)


def grids(n, s, a):
    """K3 in its four forms and its levers."""
    sdf_srcs = {"sdf": sdf_kernel_source(s), "sdf gizmo": sdf_kernel_source(s, gizmo=True),
                "sdf cull": culled_source(s, False), "sdf gizmo cull": culled_source(s, True)}
    grid_units = {k: ("sdf", v) for k, v in sdf_srcs.items()}
    grid_units.update({f"{k} no bound": ("sdf", v.replace(GRID_LB, NO_GRID_LB))
                       for k, v in sdf_srcs.items() if GRID_LB in v and "cull" not in k})
    for k, v in sdf_srcs.items():
        for flips in CULL_LEVERS:
            if all(f"#define {flag}" in v for flag in flips.split("+")):
                lever = v
                for flag in flips.split("+"):
                    lever = toggle(lever, flag)
                grid_units[f"{k} {flips}"] = ("sdf", lever)
    grid_logs = kbuild.build(grid_units)
    for key, gizmo, cull_ in (("grid", False, None), ("grid gizmo", True, None),
                              ("grid cull", False, True), ("grid cull gizmo", True, True)):
        g = make_grid_eval(s, gizmo=gizmo, cull=cull_)
        kname = "grid_eval_cull_kernel" if cull_ else "grid_eval_kernel"
        unit = ("sdf gizmo" if gizmo else "sdf") + (" cull" if cull_ else "")
        out[f"{n} {key}"] = dict(timed(lambda g=g: g(a, *GRID), kname, registers(grid_logs[unit], kname), 100),
                                 sass=sass("sdf", sdf_srcs[unit], kname))
        save(f"{n}_{key}", g(a, *GRID))
    for key, gizmo in (("grid", False), ("grid gizmo", True)):
        unit = "sdf gizmo no bound" if gizmo else "sdf no bound"
        if unit in grid_units:
            g = variant(sk, "sdf_kernel_source", lambda src: src.replace(GRID_LB, NO_GRID_LB),
                        lambda gizmo=gizmo: make_grid_eval(s, gizmo=gizmo), lambda w: w(a, *GRID))
            out[f"{n} {key} no launch bound"] = timed(
                lambda g=g: g(a, *GRID), "grid_eval_kernel", registers(grid_logs[unit], "grid_eval_kernel"), 100)
    for key, gizmo in (("grid cull", False), ("grid cull gizmo", True)):
        unit = "sdf gizmo cull" if gizmo else "sdf cull"
        for flips in CULL_LEVERS:
            if f"{unit} {flips}" not in grid_units:
                continue
            src = grid_units[f"{unit} {flips}"][1]
            chain = "lane" if "#define GRID_CULL_LANES 1" in src else "one-thread"
            form = "point" if "#define GRID_CULL_COLUMN 0" in src else "column"
            g = variant(sk, "sdf_kernel_source", lambda _, src=src: src,
                        lambda gizmo=gizmo: make_grid_eval(s, gizmo=gizmo, cull=True), lambda w: w(a, *GRID))
            out[f"{n} {key} {chain} chain {form} form"] = timed(
                lambda g=g: g(a, *GRID), "grid_eval_cull_kernel",
                registers(grid_logs[f"{unit} {flips}"], "grid_eval_cull_kernel"), 100)


def points(n, s, a, cone, o_cone, rays, rows):
    """K1 (and its FD form), K4, the constant-bank levers and the refine."""
    rm_src = ray_march_kernel_source(s, FIT)
    units = {"sdf": ("sdf", sdf_kernel_source(s)), "ray_march": ("ray_march", rm_src)}
    if FD:
        units["sdf_fd"] = ("sdf_fd", sdf_kernel_source(s))
    if LB in rm_src:
        units.update({f"ray_march lb{k}": ("ray_march", rm_src.replace(LB, f"__launch_bounds__(RAY_THREADS, {k})"))
                      for k in (4, 8)})
    if LEVERS:
        units["ray_march other bank"] = ("ray_march", other_bank(rm_src))
        units["sdf constant bank"] = ("sdf", other_bank(sdf_kernel_source(s)))
        units["cone constant bank"] = ("cone", other_bank(cone_kernel_source(s, HIER)))
    logs = kbuild.build(units)
    half = 3.5 if n == "logo" else s.export_config.bounding_box_half_diameter / 2.0
    rng = np.random.default_rng(0)
    host_pts = rng.uniform(-half, half, ((1 << 20) + 40000, 3)).astype(np.float32)
    pts = torch.from_numpy(host_pts[: 1 << 20]).to(dev)
    pe = make_point_eval(s)
    out[f"{n} point"] = timed(lambda: pe(pts, a), "point_eval_kernel",
                              registers(logs["sdf"], "point_eval_kernel"), 100)
    if FD:
        out[f"{n} point_fd"] = timed(lambda: pe.fd(pts, a), "point_eval_fd_kernel",
                                     registers(logs["sdf_fd"], "point_eval_fd_kernel"))
    rm = make_cuda_ray_march(s, FIT)
    r_fit = project(ray_directions(FIT, dev), *torch.as_tensor(rows[1:], device=dev))
    # The origin as each tree's K4 takes it without a copy: on the card where
    # the kernel reads it there (as the fit holds it), else on the host.
    o = torch.as_tensor(rows[0], device=dev) if LEVERS else rows[0]
    ref = rm(a, o, r_fit)
    out[f"{n} ray_march"] = timed(lambda: rm(a, o, r_fit), "ray_march_kernel",
                                  registers(logs["ray_march"], "ray_march_kernel"), 20)
    levers = [k for k in units if k.startswith("ray_march ")]
    for key in levers:
        tf = lambda src, key=key: units[key][1] if src == rm_src else src
        w = variant(mk, "ray_march_kernel_source", tf, lambda: make_cuda_ray_march(s, FIT),
                    lambda w: w(a, o, r_fit))
        got = w(a, o, r_fit)
        out[f"{n} {key}"] = dict(timed(lambda w=w: w(a, o, r_fit), "ray_march_kernel",
                                       registers(logs[key], "ray_march_kernel"), 20),
                                 bit_equal=all(torch.equal(x, y) for x, y in zip(got, ref)))
    if LEVERS:
        pc = variant(sk, "sdf_kernel_source", other_bank,
                     lambda: make_point_eval(s), lambda w: w(pts, a))
        out[f"{n} point constant bank"] = timed(lambda: pc(pts, a), "point_eval_kernel",
                                                registers(logs["sdf constant bank"], "point_eval_kernel"), 100)
        gc = variant(sk, "sdf_kernel_source", other_bank,
                     lambda: make_grid_eval(s),
                     lambda w: w(a, np.full(3, -3.5, np.float32), np.float32(7.0 / 256), 112.0, 33, 257))
        call = lambda: gc(a, *GRID)
        out[f"{n} grid constant bank"] = timed(call, "grid_eval_kernel", None, 100)
        cc = variant(mk, "cone_kernel_source", other_bank,
                     lambda: make_cuda_cone_march(s, HIER), lambda w: w(a, o_cone, rays))
        out[f"{n} cone constant bank"] = timed(lambda: cc(a, o_cone, rays), "cone_march_kernel",
                                               registers(logs["cone constant bank"], "cone_march_kernel"), 100)
    ev = BatchEvaluator(s, use_kernels=True)
    ev.refine_on_device(host_pts[:4096], steps=2)
    before = dict(kbuild.LAUNCHES)
    t = time.perf_counter()
    ev.refine_on_device(host_pts, steps=50)
    out[f"{n} refine"] = dict(seconds=time.perf_counter() - t, launches={
        k: v - before.get(k, 0) for k, v in kbuild.LAUNCHES.items() if v != before.get(k, 0)})


out = {}
for n in ("design1", "design2", "logo"):
    s = get_design(n)
    a = s.arrays.to_torch(dev)
    rows = camera_rows(*cam)
    rays = project(torch.from_numpy(coarse_ray_uv(HIER)).to(dev), *torch.as_tensor(rows[1:], device=dev))
    f = HIER.hierarchical_factor
    cone = make_cuda_cone_march(s, HIER)
    t0 = cone(a, rows[0], rays)
    t0 = t0.repeat_interleave(f, 0).repeat_interleave(f, 1).contiguous()
    o_cone = torch.as_tensor(rows[0], device=dev) if CONE_ORIGIN_ON_CARD else rows[0]
    units = {key: ("march", march_kernel_source(s, cfg)) for key, cfg in MODES}
    if LEVERS:
        units.update({f"{key} other bank": ("march", other_bank(march_kernel_source(s, cfg)))
                      for key, cfg in MODES})
    logs = kbuild.build(units) if "render" in PARTS else {}
    for key, cfg in (MODES if "render" in PARTS else ()):
        r = make_cuda_renderer(s, cfg)
        call = (lambda r=r, t=t0 if key.startswith("t0") else None: r(a, *cam, t0=t))
        out[f"{n} {key}"] = timed(call, "render_kernel", registers(logs[key], "render_kernel"), 20)
        if HOLD and key.endswith("dynamic"):
            for m in (0.25, 4.0, 16.0):
                tf = lambda src, m=m: re.sub(r"constexpr float CULL_HOLD = [^;]*;",
                                             f"constexpr float CULL_HOLD = {m}f;", src)
                r = variant(mk, "march_kernel_source", tf, lambda cfg=cfg: make_cuda_renderer(s, cfg),
                            lambda w, t=t0 if key.startswith("t0") else None: w(a, *cam, t0=t))
                call = (lambda r=r, t=t0 if key.startswith("t0") else None: r(a, *cam, t0=t))
                out[f"{n} {key} hold {m}"] = timed(call, "render_kernel", None, 20)
        if LANES in march_kernel_source(s, cfg) and key.endswith("dynamic"):
            tf = lambda src: src.replace(LANES, ONE_THREAD)
            r = variant(mk, "march_kernel_source", tf, lambda cfg=cfg: make_cuda_renderer(s, cfg),
                        lambda w, t=t0 if key.startswith("t0") else None: w(a, *cam, t0=t))
            call = (lambda r=r, t=t0 if key.startswith("t0") else None: r(a, *cam, t0=t))
            out[f"{n} {key} one-thread chain"] = timed(call, "render_kernel", None, 20)
        if LEVERS:
            r = variant(mk, "march_kernel_source", other_bank, lambda cfg=cfg: make_cuda_renderer(s, cfg),
                        lambda w, t=t0 if key.startswith("t0") else None: w(a, *cam, t0=t))
            call = (lambda r=r, t=t0 if key.startswith("t0") else None: r(a, *cam, t0=t))
            out[f"{n} {key} other bank"] = timed(call, "render_kernel",
                                                 registers(logs[f"{key} other bank"], "render_kernel"), 20)
    if "cone" in PARTS:
        cone_and_frame(n, s, a, cone, o_cone, rays, rows)
    if "grid" in PARTS:
        grids(n, s, a)
    if "point" in PARTS:
        points(n, s, a, cone, o_cone, rays, rows)
if "exports" in PARTS:
    out["exports"] = exports()
print("RESULT " + json.dumps(out))
'''

# The parts of a run: the renderers, K5 and the hierarchical frame, K3, K1
# with K4 and the refine, the exports' triangle counts.
PARTS_ALL = ("render", "cone", "grid", "point", "exports")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the other tree, run as 'parent'")
    ap.add_argument("--out", help="also write the runs to this JSON file")
    ap.add_argument("--parts", default=",".join(PARTS_ALL),
                    help="comma-separated parts to time, of " + ", ".join(PARTS_ALL) + " (default: all)")
    args = ap.parse_args()
    if not set(args.parts.split(",")) <= set(PARTS_ALL):
        ap.error(f"--parts takes {', '.join(PARTS_ALL)}")
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    saved = {label: tempfile.mkdtemp(prefix=f"ab_{label}_") for label in trees}
    for i, label in enumerate(("parent", "change", "change", "parent")):
        env = dict(os.environ, PYTHONPATH=trees[label], AB_PARTS=args.parts)
        if i < 2:  # the first run of each tree saves its grids and cones
            env["AB_SAVE"] = saved[label]
        p = subprocess.run([sys.executable, "-c", CHILD], env=env, capture_output=True, text=True,
                           cwd=trees[label])
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            print(p.stdout[-3000:], p.stderr[-3000:])
            return 1
        runs.append((label, json.loads(line[0][len("RESULT "):])))
        print(label, line[0][len("RESULT "):], flush=True)
    print("events ms / device ms [registers], or refine seconds: parent, change, change, parent")
    for key in dict.fromkeys(k for _, r in runs for k in r):
        cells = []
        if key == "exports":
            continue
        for _, r in runs:
            c = r.get(key)
            if c is None:
                cells.append("-")
            elif "enqueue_ms" in c:
                cells.append(f"{c['ms']:.4f} (enqueue {c['enqueue_ms']:.4f})")
            elif "seconds" in c:
                cells.append(f"{c['seconds']:.4f}s {c['launches']}")
            else:
                regs = f" [{c['registers']}]" if c.get("registers") else ""
                dev_ms = "none" if c["device_ms"] is None else f"{c['device_ms']:.4f}"
                fill = f" (fill {c['bank_ms']:.4f})" if c.get("bank_ms") else ""
                code = " sass {}/{}".format(*c["sass"]) if c.get("sass") else ""
                same = "" if "bit_equal_to_plain" not in c else (" =plain" if c["bit_equal_to_plain"] else " !=plain")
                cells.append(f"{c['ms']:.4f}/{dev_ms}{fill}{regs}{code}{same}")
        print(f"{key:30s} " + "  ".join(cells))
    print("export triangles: " + "  ".join(json.dumps(r.get("exports")) for _, r in runs))
    # The first parent and change runs' grids and cones, value by value.
    compare = {}
    for f in sorted(os.listdir(saved["parent"])):
        other = os.path.join(saved["change"], f)
        if os.path.exists(other):
            x, y = np.load(os.path.join(saved["parent"], f)), np.load(other)
            compare[f[:-4]] = dict(bit_equal_share=float((x == y).mean()),
                                   max_abs_diff=float(np.abs(x - y).max()))
    print("parent vs change values: " + json.dumps(compare))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "runs": runs, "parent_vs_change": compare}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
