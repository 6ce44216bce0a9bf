"""Device-to-host copy time a frame: the profiler's DtoH copies in the
window over its frames."""


def read(ctx):
    if ctx.trace is None or "frames" not in ctx.window:
        return None
    copies = [b - a for _, a, b in ctx.trace.device_ops("Memcpy DtoH")]
    if not copies:
        return None
    return 1e-6 * sum(copies) / ctx.window["frames"]
