"""Seconds of the host-point autodetect an export: the program's
``evaluator.autodetect_bounding_box`` spans (export/pipeline.py: the scan
lattice built on the host, sent up and read back) over the ``export.mesh``
spans in the traced window.  None where the program records no such
span."""

from benchmark import program

NAME = "evaluator.autodetect_bounding_box"


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    scans = [s for _, s in program.named(spans, NAME) if s.name == NAME] if exports else []
    if not scans:
        return None
    return 1e-9 * sum(s.ns for s in scans) / exports
