"""File -> Export as ``cli export <design>`` does it by default
(``--sdf-field auto``), back to back: ``drivers/export.py``'s cell, except
that each export builds ``BatchEvaluator(scene, device=device)`` and so
takes the evaluator's own engine rule.  That rule puts a design whose
kernels compute an approximate twin (Logo's baked letters) on the exact
plain tape, as upstream's k2 is always exact.

Each window record keeps the field the export rode
(``report.stats["sdf_field"]``).  The check adds two numbers to the
export's:

- ``field_not_exact``: 1.0 if any export of the windows rode another field
  than ``tape-exact``, so that no change slips the cell onto the twin;
- ``vertex_off_share``: the share of the written vertices whose |field| in
  the reference passes ``OFF_GAP``.  Logo's letter is ``-d`` where its
  mask's lattice cell is inside, so the field touches 0 at the samples on
  the outline; a refine that starts beside such a cell can end there, or
  stall on the cell's step, alike in the program and the reference.  Those
  few vertices set ``vertex_gap_max``; the share counts them, and a field
  computed in a lower precision leaves many more.

Two keys of the configuration, which the cell's own file leaves out, set
smaller sizes for the CPU tests: ``autodetect_resolution`` (the box scan's
lattice, default 256, what ``cli export`` scans) and ``volume_cells`` (the
check's volume lattice, default the traffic's).
"""

from __future__ import annotations

import os

import numpy as np

from ..reference import mesh as ref_mesh
from . import export
from .export import FAULTS, pose, substitute  # noqa: F401  (this kind's faults)

EXACT = "tape-exact"
# |field| in the reference past which a vertex is off the surface: a hundred
# times what the program's affine form of the distance leaves at its vertices
# on the letter walls, 0.075 from the samples (under 1e-6; the median ~1e-7).
OFF_GAP = 1e-4


class Cell(export.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device, reference):
        self.fields = []
        self.autodetect_resolution = int(config.get("autodetect_resolution", 256))
        if "volume_cells" in config:
            traffic = {**traffic, "volume_cells": config["volume_cells"]}
        super().__init__(config, traffic, seed, device, reference)
        self.fields = []  # the set-up's export is not the windows'

    def export(self):
        from designcsg_tpu_torch.evaluator import BatchEvaluator
        from designcsg_tpu_torch.export.pipeline import export_mesh

        evaluator = BatchEvaluator(self.scene, device=self.device)
        _, report = export_mesh(self.scene, self.export_config, stl_path=self.path,
                                evaluator=evaluator, strategy=self.traffic["strategy"],
                                autodetect_resolution=self.autodetect_resolution)
        self.fields.append(report.stats["sdf_field"])
        return report, evaluator.sdf_eval_count

    def window(self, seconds: float, trace: bool = False) -> dict:
        first = len(self.fields)
        out = super().window(seconds, trace)
        fields = self.fields[first:]
        for record, field in zip(out["records"], fields):
            record["sdf_field"] = field
        out["sdf_field_seen"] = sorted(set(fields))
        return out

    def check(self) -> dict:
        numbers = {"field_not_exact": float(any(f != EXACT for f in self.fields))}
        if os.path.exists(self.path):
            triangles = ref_mesh.read_stl(self.path)
            if triangles.shape[0]:
                vertices = np.unique(triangles.reshape(-1, 3), axis=0)
                gap = np.abs(ref_mesh.field_at(self.make_reference(pose(self.seed)), vertices,
                                               self.device))
                numbers["vertex_off_share"] = float((gap > OFF_GAP).mean())
        return {**super().check(), **numbers}
