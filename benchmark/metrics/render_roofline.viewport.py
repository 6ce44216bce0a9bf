"""K2's share of its roofline: the least time the frame's work could take on
the card (the larger of its FP32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, benchmark/peaks.py) over K2's mean device time.  The
operations are the tape's FP32 operations an evaluation (with the gizmo)
times the field evaluations of the reference's march and FD normals, plus
each hit pixel's shading, over the views the check rendered; the bytes are
the pixels written once and the banks read once."""

from benchmark.peaks import bound_s


def read(ctx):
    if ctx.trace is None or not getattr(ctx.cell, "reference_evals", None):
        return None
    runs = [b - a for _, a, b in ctx.trace.device_ops("render_kernel")]
    if not runs:
        return None
    kernel_s = 1e-9 * sum(runs) / len(runs)
    return 100.0 * bound_s(ctx.cell.frame_flops(), ctx.cell.frame_bytes()) / kernel_s
