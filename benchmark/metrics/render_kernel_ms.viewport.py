"""K2's mean device time a launch, from the profiler's records of the
renderer kernel (``render_kernel``) in the window."""

KERNEL = "render_kernel"


def kernel_ms(trace):
    runs = [b - a for _, a, b in trace.device_ops(KERNEL)]
    return 1e-6 * sum(runs) / len(runs) if runs else None


def read(ctx):
    if ctx.trace is None:
        return None
    return kernel_ms(ctx.trace)
