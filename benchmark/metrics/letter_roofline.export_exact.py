"""The exact letter field's share of its roofline an export: the least
time its work could take on the card (benchmark/peaks.py ``bound_s``) over
the card's busy time an export in the traced window.  The work is counted
from the reference's form, so it reads the same whatever computes the
field: each field evaluation (``sdf_evals``, an FD normal counting 6) takes
``SAMPLES_PER_EVALUATION`` point-sample pairs of ``FLOPS_PER_PAIR`` FP32
operations and reads its point's 16 bytes.  The busy time holds all of the
export's device work, so the share stays under 100%."""

from benchmark.peaks import bound_s
from benchmark.reference.logo import FLOPS_PER_PAIR, SAMPLES_PER_EVALUATION

POINT_BYTES = 16


def read(ctx):
    records = ctx.window.get("records")
    if ctx.trace is None or not records or not ctx.trace.busy_s:
        return None
    evals = sum(r["sdf_evals"] for r in records) / len(records)
    least = bound_s(evals * SAMPLES_PER_EVALUATION * FLOPS_PER_PAIR, evals * POINT_BYTES)
    return 100.0 * least / (ctx.trace.busy_s / len(records))
