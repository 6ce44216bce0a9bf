#!/usr/bin/env python3
"""A/B of the port's unculled renderer kernels (exact, over-relaxed, from a
t0 plane), its grid kernel, its point kernel (K1, and its FD form where the
tree has one), the fit's ray march (K4) and the export's refine between two
trees of this repository, on one card, in one run:

    python3 ab_render_timing.py PARENT_DIR [--out RESULTS.json]

``PARENT_DIR`` is another checkout (e.g. ``git archive <commit>`` unpacked into
an ignored directory).  The trees run in the order parent, change, change,
parent, each in a process of its own with that tree first on ``sys.path`` and
its own build directory.  Per tree and design it prints each kernel's time by
CUDA events (mean over back-to-back calls) and by torch.profiler (mean of its
records) and the ``-Xptxas -v`` registers of the kernel: the renderers at
640x480, the grid over a 33x257x257 slab, K1 at 2^20 uniform points in the
design's box, K4 on the fit's 640x480 rays (bench.py's fit configuration);
and the seconds of ``BatchEvaluator.refine_on_device`` (the kernels' field)
over 2^20 + 40,000 such points and 50 steps, two chunks as in bench.py's
512^3 export, with the launches it made.  Compare two trees only within one
run: the card's clocks and power limit move between runs.
"""
import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, re, time
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
from designcsg_tpu_torch.ops.cuda.tape import (march_kernel_source, ray_march_kernel_source,
                                               sdf_kernel_source)
from designcsg_tpu_torch.ops.raymarch import camera_rows, coarse_ray_uv, project, ray_directions

dev = torch.device("cuda")
cam = Camera.initial().as_arrays()
HIER = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
MODES = (("exact", RenderConfig()), ("overrelax", RenderConfig(march_overrelax=1.6)), ("t0", HIER))
FIT = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
FD = "sdf_fd" in kbuild.EXTRA_FLAGS  # this tree has K1's FD form


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


def device_ms(fn, name, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    d = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
         if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(d) / len(d) if d else None


out = {}
for n in ("design1", "design2", "logo"):
    s = get_design(n)
    logs = kbuild.build({key: ("march", march_kernel_source(s, cfg)) for key, cfg in MODES})
    a = s.arrays.to_torch(dev)
    rows = camera_rows(*cam)
    rays = project(torch.from_numpy(coarse_ray_uv(HIER)).to(dev), *torch.as_tensor(rows[1:], device=dev))
    f = HIER.hierarchical_factor
    t0 = make_cuda_cone_march(s, HIER)(a, rows[0], rays)
    t0 = t0.repeat_interleave(f, 0).repeat_interleave(f, 1).contiguous()
    for key, cfg in MODES:
        r = make_cuda_renderer(s, cfg)
        call = (lambda r=r, t=t0 if key == "t0" else None: r(a, *cam, t0=t))
        regs = re.findall(r"Used (\d+) registers", logs[key])
        out[f"{n} {key}"] = dict(ms=events_ms(call), device_ms=device_ms(call, "render_kernel"),
                                 registers=int(regs[-1]) if regs else None)
    g = make_grid_eval(s)
    call = lambda: g(a, np.full(3, -3.5, np.float32), np.float32(7.0 / 256), 112.0, 33, 257)
    out[f"{n} grid"] = dict(ms=events_ms(call, 100), device_ms=device_ms(call, "grid_eval_kernel"))
    units = {"sdf": ("sdf", sdf_kernel_source(s)), "ray_march": ("ray_march", ray_march_kernel_source(s, FIT))}
    if FD:
        units["sdf_fd"] = ("sdf_fd", sdf_kernel_source(s))
    logs = kbuild.build(units)
    half = 3.5 if n == "logo" else s.export_config.bounding_box_half_diameter / 2.0
    rng = np.random.default_rng(0)
    host_pts = rng.uniform(-half, half, ((1 << 20) + 40000, 3)).astype(np.float32)
    pts = torch.from_numpy(host_pts[: 1 << 20]).to(dev)
    pe = make_point_eval(s)
    call = lambda: pe(pts, a)
    out[f"{n} point"] = dict(ms=events_ms(call, 100), device_ms=device_ms(call, "point_eval_kernel"),
                             registers=registers(logs["sdf"], "point_eval_kernel"))
    if FD:
        call = lambda: pe.fd(pts, a)
        out[f"{n} point_fd"] = dict(ms=events_ms(call, 50), device_ms=device_ms(call, "point_eval_fd_kernel"),
                                    registers=registers(logs["sdf_fd"], "point_eval_fd_kernel"))
    rm = make_cuda_ray_march(s, FIT)
    rows = camera_rows(*cam)
    r_fit = project(ray_directions(FIT, dev), *torch.as_tensor(rows[1:], device=dev))
    call = lambda: rm(a, rows[0], r_fit)
    out[f"{n} ray_march"] = dict(ms=events_ms(call, 20), device_ms=device_ms(call, "ray_march_kernel"),
                                 registers=registers(logs["ray_march"], "ray_march_kernel"))
    ev = BatchEvaluator(s, use_kernels=True)
    ev.refine_on_device(host_pts[:4096], steps=2)
    before = dict(kbuild.LAUNCHES)
    t = time.perf_counter()
    ev.refine_on_device(host_pts, steps=50)
    out[f"{n} refine"] = dict(seconds=time.perf_counter() - t, launches={
        k: v - before.get(k, 0) for k, v in kbuild.LAUNCHES.items() if v != before.get(k, 0)})
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the other tree, run as 'parent'")
    ap.add_argument("--out", help="also write the runs to this JSON file")
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.dirname(os.path.abspath(__file__))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for label in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=trees[label])
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
        for _, r in runs:
            c = r.get(key)
            if c is None:
                cells.append("-")
            elif "seconds" in c:
                cells.append(f"{c['seconds']:.4f}s {c['launches']}")
            else:
                regs = f" [{c['registers']}]" if c.get("registers") else ""
                dev_ms = "none" if c["device_ms"] is None else f"{c['device_ms']:.4f}"
                cells.append(f"{c['ms']:.4f}/{dev_ms}{regs}")
        print(f"{key:18s} " + "  ".join(cells))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
