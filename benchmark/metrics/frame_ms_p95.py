"""The 95th percentile of every frame of the window, each timed on the host
clock from the call until its pixels are on the host (interpolated between
order statistics, as numpy's default)."""

import statistics


def read(ctx):
    if "frames" not in ctx.window:
        return None
    calls = ctx.window["call_s"]
    if len(calls) == 1:
        return 1e3 * calls[0]
    return 1e3 * statistics.quantiles(calls, n=100, method="inclusive")[94]
