"""Faces that enter the adaptive extract's mesh ops, an export: the values
of the program's ``extract.weld`` spans (the triangles the levels emitted,
before the weld drops degenerate ones) over the ``export.mesh`` spans in
the traced window.  None where the program records no such span."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    welds = [s for _, s in program.named(spans, "extract.weld")] if exports else []
    if not welds:
        return None
    return sum(s.value for s in welds) / exports
