"""Seconds of the adaptive extract's mesh operations, an export: the
program's ``extract.mesh_ops`` spans (``assemble_mesh``,
``retopologize``, ``stitch_boundary_loops``) over the ``export.mesh``
spans in the traced window."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    exports = program.roots(spans, "export.mesh")
    if not exports:
        return None
    return 1e-9 * sum(s.ns for _, s in program.named(spans, "extract.mesh_ops")) / exports
