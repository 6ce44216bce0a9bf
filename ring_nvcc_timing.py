"""nvcc seconds of the capacity rings' kernel units, in the generator's three
forms, on a machine with the CUDA toolkit.

The rings are tests/test_capacity.py's scene (n spheres on a ring, one min an
object), built on the port's API (tests/torch_scenes.py ``ring_scene``).
Each unit (K1, K1's FD form, K2, K5 and K4 of each ring; the 1,100-ring's
culled grid) is generated

* ``looped``: as the port generates it (runs of the tape and of the shading
  over consecutive objects as loops, ``tape.TAPE_LOOP_MIN_RUN``);
* ``called``: unrolled, the tape's functions called at each call site
  (``tape.TAPE_INLINE_MAX_SLOTS`` exceeded);
* ``inlined``: unrolled and inlined at every call site;

and built by its own nvcc with the port's flags, ``--jobs`` at a time, each
cut at ``--limit`` seconds.  One JSON line per unit as it ends (seconds,
exit code, ptxas's register and spill lines), and ``--out`` gets them all.

    python3 ring_nvcc_timing.py --forms looped,called --limit 360 --out build/nvcc.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from designcsg_tpu_torch.config import RenderConfig  # noqa: E402
from designcsg_tpu_torch.ops.cuda import build as kbuild  # noqa: E402
from designcsg_tpu_torch.ops.cuda import tape  # noqa: E402
from torch_scenes import ring_scene  # noqa: E402

EXACT = RenderConfig(width=48, height=32, max_steps=32)
FAST = RenderConfig(width=240, height=160, max_steps=32, march_overrelax=1.6, march_hierarchical=True)
FIT = RenderConfig(width=48, height=32, max_steps=32, differentiable=True,
                   soft_silhouette_bandwidth=0.02, gizmo=False)
# (TAPE_LOOP_MIN_RUN, TAPE_INLINE_MAX_SLOTS) of each form.
FORMS = {"looped": (tape.TAPE_LOOP_MIN_RUN, tape.TAPE_INLINE_MAX_SLOTS),
         "called": (10**9, tape.TAPE_INLINE_MAX_SLOTS), "inlined": (10**9, 10**9)}


def units(form: str, rings) -> dict:
    """{label: (library name, source)} of the form's units."""
    tape.TAPE_LOOP_MIN_RUN, tape.TAPE_INLINE_MAX_SLOTS = FORMS[form]
    out = {}
    try:
        for n in rings:
            s = ring_scene(n)
            out[f"{form} ring{n} sdf"] = ("sdf", tape.sdf_kernel_source(s))
            out[f"{form} ring{n} sdf_fd"] = ("sdf_fd", tape.sdf_kernel_source(s))
            out[f"{form} ring{n} march"] = ("march", tape.march_kernel_source(s, EXACT))
            out[f"{form} ring{n} cone"] = ("cone", tape.cone_kernel_source(s, FAST))
            out[f"{form} ring{n} ray_march"] = ("ray_march", tape.ray_march_kernel_source(s, FIT))
        out[f"{form} ring1100 sdf cull"] = ("sdf", tape.sdf_kernel_source(ring_scene(1100), cull=True))
    finally:
        tape.TAPE_LOOP_MIN_RUN, tape.TAPE_INLINE_MAX_SLOTS = FORMS["looped"]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--forms", default="looped,called,inlined")
    parser.add_argument("--rings", default="512,1500")
    parser.add_argument("--jobs", type=int, default=8)
    parser.add_argument("--limit", type=float, default=360.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    rings = [int(n) for n in args.rings.split(",")]
    pending = []
    for form in args.forms.split(","):
        pending += list(units(form, rings).items())
    results, running, start = {}, {}, time.time()
    with tempfile.TemporaryDirectory() as work:
        while pending or running:
            while pending and len(running) < args.jobs:
                label, (name, source) = pending.pop(0)
                cu = os.path.join(work, label.replace(" ", "_") + ".cu")
                with open(cu, "w") as f:
                    f.write(source)
                cmd = [kbuild.nvcc(), *kbuild._flags(name), "-o", cu[:-3] + ".so", cu]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                running[label] = (proc, time.time())
            for label, (proc, t0) in list(running.items()):
                if proc.poll() is not None:
                    lines = proc.stdout.read().splitlines()
                    results[label] = dict(seconds=time.time() - t0, rc=proc.returncode,
                                          ptxas=[ln.strip() for ln in lines
                                                 if "registers" in ln or "spill" in ln])
                elif time.time() - t0 > args.limit:
                    proc.kill()
                    proc.wait()
                    results[label] = dict(seconds=None, rc="cut", limit=args.limit)
                else:
                    continue
                del running[label]
                print(json.dumps({label: results[label]}), flush=True)
            time.sleep(0.2)
    print(json.dumps({"total_seconds": time.time() - start, "jobs": args.jobs}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in results.values() if r["rc"] != "cut") else 1


if __name__ == "__main__":
    sys.exit(main())
