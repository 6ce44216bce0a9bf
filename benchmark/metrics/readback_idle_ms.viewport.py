"""The card's idle time inside the frame's read-back a frame: the traced
window's idle gaps within the program's ``copy.d2h`` spans of its
``viewer.frame`` spans (the host staging the pageable copy), over the
frames."""

from benchmark import program


def read(ctx):
    spans = program.spans(ctx)
    frames = program.roots(spans, "viewer.frame")
    if not frames:
        return None
    copies = [s for i, s in program.named(spans, "copy.d2h")
              if program.under(spans, i, "viewer.frame")]
    return 1e-6 * program.idle_ns(ctx.trace, copies) / frames
