"""Kernel launches a frame, by the program's launch counter
(``designcsg_tpu_torch.ops.cuda.build.LAUNCHES``) over the window."""


def read(ctx):
    if "launches" not in ctx.window:
        return None
    return ctx.window["launches"] / ctx.window["frames"]
