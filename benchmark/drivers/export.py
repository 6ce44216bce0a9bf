"""File -> Export as ``cli export <design>`` does it, back to back: each
export is ``export_mesh`` at the configuration's export settings with
``strategy`` from the traffic (``auto``: the adaptive octree for these
designs) on a fresh ``BatchEvaluator(use_kernels=True)``, and writes one
STL under the run's temporary directory (named by the seed), overwritten by
each export.

The seed picks one of the 24 rotations that map the axes onto the axes;
the whole part is placed in that pose through the program's own API, as a
rotation of the design's root, and the reference is built in the same
pose.  Set-up makes one export and removes its file; the window exports
until the first export that ends after ``seconds``.  The check reads the
file the window left back, removes it and holds it to the reference.
"""

from __future__ import annotations

import os
import random
import tempfile
import time

import numpy as np
import torch

from ..reference import geometry
from ..reference import mesh as ref_mesh

# What the check must catch, besides the control (see ``substitute``).
FAULTS = ("stale", "half", "altered")


def pose(seed: int) -> np.ndarray:
    """The seed's pose of the whole part: one of the 24 rotations that map
    the axes onto the axes."""
    return geometry.axis_rotations()[random.Random(seed).randrange(24)]


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, reference):
        from designcsg_tpu_torch import api
        from designcsg_tpu_torch.compiler import SceneCompiler
        from designcsg_tpu_torch.designs import design_module

        perf = time.perf_counter
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.make_reference = reference
        a = perf()
        compiler = api.new_design()
        root = np.eye(4)
        root[:3, :3] = pose(seed)
        compiler.root.apply_transform(root)
        self.scene = design_module(config["design"]).build(compiler=compiler)
        self.export_config = SceneCompiler().set_export_config(**config["export"])
        self.path = os.path.join(tempfile.gettempdir(), f"benchmark_{config['name']}_{seed}.stl")
        b = perf()
        self.export()
        if os.path.exists(self.path):
            os.remove(self.path)
        self.stages = {"design_s": b - a, "warm_s": perf() - b}

    def export(self):
        from designcsg_tpu_torch.evaluator import BatchEvaluator
        from designcsg_tpu_torch.export.pipeline import export_mesh

        evaluator = BatchEvaluator(self.scene, device=self.device, use_kernels=True)
        _, report = export_mesh(self.scene, self.export_config, stl_path=self.path,
                                evaluator=evaluator, strategy=self.traffic["strategy"])
        return report, evaluator.sdf_eval_count

    def window(self, seconds: float, trace: bool = False) -> dict:
        perf = time.perf_counter
        records, spans = [], []
        start = perf()
        while True:
            begin = perf()
            report, evals = self.export()
            end = perf()
            records.append({"seconds": end - begin, "stage_seconds": dict(report.stage_seconds),
                            "sdf_evals": evals, "triangles": report.num_triangles})
            if trace:
                spans.append(("benchmark.export", int(begin * 1e9), int(end * 1e9)))
            if end - start >= seconds:
                break
        return {"attempted": len(records), "exports": len(records), "window_s": end - start,
                "call_s": [r["seconds"] for r in records], "spans": spans, "records": records,
                "triangles_seen": sorted({r["triangles"] for r in records}),
                "sdf_evals_seen": sorted({r["sdf_evals"] for r in records})}

    def release(self):
        self.scene = None

    def check(self) -> dict:
        """The written file against the reference: whether the window left
        a mesh there, the largest |field| at its vertices, and its volume's
        relative gap to the design's own within the export's scan box."""
        self.reference = self.make_reference(pose(self.seed))
        if not os.path.exists(self.path):
            return {"stl_missing": 1.0}
        triangles = ref_mesh.read_stl(self.path)
        os.remove(self.path)
        if triangles.shape[0] == 0:
            return {"stl_missing": 1.0}
        vertices = np.unique(triangles.reshape(-1, 3), axis=0)
        gap = np.abs(ref_mesh.field_at(self.reference, vertices, self.device))
        half = 0.5 * geometry.ROOT_SCALE * self.config["export"]["boundingBoxHalfDiameter"]
        volume = ref_mesh.design_volume(self.reference, [-half] * 3, [half] * 3,
                                        self.traffic["volume_cells"], self.seed, self.device)
        self.triangles = triangles.shape[0]
        return {"stl_missing": 0.0, "vertex_gap_max": float(gap.max()),
                "volume_gap": abs(ref_mesh.volume(triangles) - volume) / volume}


def substitute(kind: str, reference, seed: int, device):
    """``(module, name, replacement)``: the program's ``write_stl`` with a
    mesh that ``kind`` makes wrong.  ``control`` puts the reference in the
    refine's place: each vertex taken onto the zero set of the seed's pose
    of the reference by 10 Newton steps in bfloat16
    (``reference.mesh.project_bf16``); ``stale`` writes nothing; ``half``
    writes half of the triangles; ``altered`` moves one vertex by 0.05."""
    from designcsg_tpu_torch.export import writers
    from designcsg_tpu_torch.ops.marching_cubes import Mesh

    original = writers.write_stl
    design = reference(pose(seed))

    def write(path, mesh, header_text=""):
        if kind == "stale":
            return 0
        if kind == "control":
            vertices = ref_mesh.project_bf16(design, np.asarray(mesh.vertices), 10, device)
            mesh = Mesh(vertices=vertices, faces=mesh.faces)
        elif kind == "half":
            mesh = Mesh(vertices=mesh.vertices, faces=mesh.faces[: mesh.num_faces // 2])
        else:
            vertices = np.array(mesh.vertices, copy=True)
            vertices[mesh.faces[0, 0]] += np.float32(0.05)
            mesh = Mesh(vertices=vertices, faces=mesh.faces)
        return original(path, mesh, header_text)

    return writers, "write_stl", write
