"""Milliseconds the card was busy an export: the union of the profiler's
kernels, copies and fills in the window over its exports."""


def read(ctx):
    if ctx.trace is None or "exports" not in ctx.window:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.window["exports"]
