"""Seconds of the adaptive extract's levels on the host, an export: the
program's ``extract.level`` spans less the ``evaluator.*`` calls inside
them (classification, edge angles, ambiguity, canonical offsets and
emission in numpy), over the ``export.mesh`` spans in the traced window."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    if not exports:
        return None
    return 1e-9 * program.self_ns(spans, "extract.level", "evaluator.") / exports
