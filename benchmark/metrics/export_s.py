"""The window's seconds over the exports it completed; the window ends with
the first export that finishes after the measured seconds."""


def read(ctx):
    if "exports" not in ctx.window:
        return None
    return ctx.window["window_s"] / ctx.window["exports"]
