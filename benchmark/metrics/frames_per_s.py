"""Frames whose pixels reached the host in the window, over the window's
seconds (from the first frame's call to the last frame's return)."""


def read(ctx):
    if "frames" not in ctx.window:
        return None
    return ctx.window["frames"] / ctx.window["window_s"]
