"""Seconds of the adaptive extract's retopology, an export: the program's
``extract.retopologize`` spans (``retopologize``, inside
``extract.mesh_ops``) over the ``export.mesh`` spans in the traced window.
None where the program records no such span."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    ops = [s for _, s in program.named(spans, "extract.retopologize")] if exports else []
    if not ops:
        return None
    return 1e-9 * sum(s.ns for s in ops) / exports
