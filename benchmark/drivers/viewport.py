"""The free-running viewport while the user drags: a closed loop of one
client, each frame one call of the viewer's frame function
(``viewer._make_render_fn``'s ``run(camera)``), whose pixels reach the host
as it returns.

Set-up builds the renderer and uploads the banks once and renders the
first view twice.  The window renders the drag path's views in order,
cycling, and times each frame on the host clock.  It keeps the frames of a
sample drawn from the seed (a reservoir of ``sample`` frames), the last
frame and the slowest; the check renders each again with the plain
reference and compares pixels.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ..reference import render as ref_render
from . import cameras

# The gap of a pixel is its largest channel's distance to the reference.
NEAR, FAR = 1e-3, 0.1
# What the check must catch, besides the control (see ``substitute``).
FAULTS = ("stale", "half", "altered")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, reference):
        from designcsg_tpu_torch.config import RenderConfig
        from designcsg_tpu_torch.designs import get_design
        from designcsg_tpu_torch.viewer import _make_render_fn

        perf = time.perf_counter
        self.config, self.traffic, self.device = config, traffic, device
        self.width, self.height = config["viewport"]["width"], config["viewport"]["height"]
        self.make_reference = reference
        self.set_path(seed)
        render_config = RenderConfig(width=self.width, height=self.height, **traffic["render"])
        a = perf()
        scene = get_design(config["design"])
        b = perf()
        self.run = _make_render_fn(scene, render_config, device)
        c = perf()
        for _ in range(2):
            self.run(self.cameras[0])
        self.stages = {"design_s": b - a, "renderer_s": c - b, "warm_s": perf() - c}

    def set_path(self, seed: int):
        """The seed's drag path, as the benchmark's poses and the program's
        cameras."""
        from designcsg_tpu_torch.camera import Camera

        self.seed = seed
        self.poses = cameras.path(seed, self.traffic["path"])
        self.cameras = [Camera(*(np.array(a) for a in pose)) for pose in self.poses]

    def window(self, seconds: float, trace: bool = False) -> dict:
        from designcsg_tpu_torch.ops.cuda.build import LAUNCHES

        run, cams, n = self.run, self.cameras, len(self.cameras)
        keep = self.traffic["sample"]
        pick = random.Random(self.seed + 1)
        sample, slowest = [], (-1.0, None, None)
        times, spans = [], []
        launches = sum(LAUNCHES.values())
        perf = time.perf_counter
        start = perf()
        i = 0
        while True:
            a = perf()
            frame = run(cams[i % n])
            b = perf()
            times.append(b - a)
            if trace:
                spans.append(("benchmark.frame", int(a * 1e9), int(b * 1e9)))
            if i < keep:
                sample.append((i, frame))
            else:
                j = pick.randrange(i + 1)
                if j < keep:
                    sample[j] = (i, frame)
            if b - a > slowest[0]:
                slowest = (b - a, i, frame)
            i += 1
            if b - start >= seconds:
                break
        picked = {k: f for k, f in sample}
        picked[slowest[1]] = slowest[2]
        picked[i - 1] = frame
        self.frames = sorted(picked.items())
        return {"attempted": i, "frames": i, "window_s": b - start, "call_s": times,
                "spans": spans, "launches": sum(LAUNCHES.values()) - launches}

    def release(self):
        self.run = None

    def check(self) -> dict:
        """Each kept frame against the reference's frame of its view: the
        share of pixels whose gap exceeds NEAR and FAR, the worst frame's."""
        self.reference = self.make_reference()
        near = far = 0.0
        self.reference_evals, self.reference_hits = [], []
        for i, frame in self.frames:
            pose = self.poses[i % len(self.poses)]
            ref, evals, hits = ref_render.render(self.reference, pose, self.width, self.height,
                                                 device=self.device)
            gap = (torch.as_tensor(frame, device=self.device) - ref).abs().amax(-1)
            near = max(near, float((gap > NEAR).float().mean()))
            far = max(far, float((gap > FAR).float().mean()))
            self.reference_evals.append(evals)
            self.reference_hits.append(hits)
        return {"frames_checked": len(self.frames), "px_off_share": near, "px_far_share": far}

    def frame_flops(self) -> float:
        """FP32 operations of a frame of the window, by the reference's
        march over the kept views: its field evaluations and hit pixels."""
        per_eval = ref_render.field_flops(self.reference)
        per_hit = ref_render.shade_flops(self.reference)
        return float(np.mean([e * per_eval + h * per_hit
                              for e, h in zip(self.reference_evals, self.reference_hits)]))

    def frame_bytes(self) -> float:
        """Bytes a frame must move: its pixels written once (float32 RGB)
        and each leaf's frame read once."""
        return self.width * self.height * 3 * 4 + len(self.reference.leaves) * 12 * 4


def substitute(kind: str, reference, seed: int, device):
    """``(module, name, replacement)``: the program's
    ``make_scene_renderer`` with frames that ``kind`` makes wrong.
    ``control`` puts the reference in the program's place, its frame of the
    same view computed in bfloat16; ``stale`` returns the first frame made
    for every camera (a step that returns its state unchanged); ``half``
    leaves the lower half of the rows white; ``altered`` dims every pixel by
    1%."""
    from designcsg_tpu_torch.ops import raymarch

    original = raymarch.make_scene_renderer

    def make(scene, config, device):
        render = original(scene, config, device)
        design = reference()
        first = []

        def broken(arrays, *camera, **kw):
            if kind == "control":
                pose = tuple(np.asarray(c, np.float32) for c in camera)
                return ref_render.render(design, pose, config.width, config.height,
                                         dtype=torch.bfloat16, device=device)[0]
            img = render(arrays, *camera, **kw)
            if kind == "stale":
                first.append(img)
                return first[0]
            if kind == "half":
                img = img.clone()
                img[img.shape[0] // 2:] = 1.0
                return img
            return img * 0.99

        broken.engine = render.engine
        return broken

    return raymarch, "make_scene_renderer", make
