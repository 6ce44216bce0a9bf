"""Seconds of the export's ``extract`` stage (the report's
``stage_seconds``; the stage ends with its mesh on the host), the mean
over the window's exports."""


def read(ctx):
    records = ctx.window.get("records")
    if not records:
        return None
    return sum(r["stage_seconds"]["extract"] for r in records) / len(records)
