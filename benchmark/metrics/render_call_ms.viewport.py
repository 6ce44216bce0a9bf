"""The renderer call a frame, from the camera to K2 enqueued: the program's
``viewer.render`` spans over its ``viewer.frame`` spans in the traced
window."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    frames = program.roots(spans, "viewer.frame")
    if not frames:
        return None
    return 1e-6 * sum(s.ns for _, s in program.named(spans, "viewer.render")) / frames
