"""Seconds of evaluator calls in the export's extract stage, an export: the
program's outermost ``evaluator.*`` spans under ``export.extract`` (each
call's uploads, kernels and read-backs), over the ``export.mesh`` spans in
the traced window."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    if not exports:
        return None
    calls = [s.ns for i, s in program.named(spans, "evaluator.")
             if program.under(spans, i, "export.extract")
             and not program.under(spans, i, "evaluator.")]
    return 1e-9 * sum(calls) / exports
