"""Bytes sent to the card an export: the values of the program's
``copy.h2d`` spans under its ``export.mesh`` spans in the traced window,
over those exports."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    if not exports:
        return None
    return sum(s.value for i, s in program.named(spans, "copy.h2d")
               if program.under(spans, i, "export.mesh")) / exports
