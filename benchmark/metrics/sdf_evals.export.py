"""Field evaluations an export, by the evaluator's counter
(``BatchEvaluator.sdf_eval_count``; an FD normal counts 6), the mean over
the window's exports."""


def read(ctx):
    records = ctx.window.get("records")
    if not records:
        return None
    return sum(r["sdf_evals"] for r in records) / len(records)
