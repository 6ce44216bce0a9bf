"""Seconds of the export's ``refine`` stage (the vertices projected onto the
surface through K1's FD form; the report's ``stage_seconds``, the stage
ends with the vertices on the host), the mean over the window's exports."""


def read(ctx):
    records = ctx.window.get("records")
    if not records:
        return None
    return sum(r["stage_seconds"]["refine"] for r in records) / len(records)
