"""Point-sample pairs of Logo's exact letter brush an export: the values
of the program's ``brush.letter`` spans (each call's points times the
letter's samples) under its ``export.mesh`` spans in the traced window,
over those exports.  None where the program records no such span."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    pairs = [s.value for i, s in program.named(spans, "brush.letter")
             if program.under(spans, i, "export.mesh")] if exports else []
    if not pairs:
        return None
    return sum(pairs) / exports
