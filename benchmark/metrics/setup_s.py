"""Seconds from the harness's first line to the first timed call: imports,
the card's start, the design's compile, the kernels' build or load, the
uploads and the warm calls."""


def read(ctx):
    return ctx.setup_s
