"""What the check must catch, planted underneath the timed path: the control
(the configuration's reference in bfloat16, in the program's place) and
each fault that the cell's driver lists in ``FAULTS``.  The driver's
``substitute`` says what each puts in the program's place.  The CPU tests
and ``benchmark.calibrate`` plant them; the benchmark's runs never do."""

from __future__ import annotations

import contextlib

from benchmark import run


def kinds(cell: str):
    """``control`` and the faults of the cell's driver."""
    return ("control",) + run.driver(_traffic(cell)).FAULTS


@contextlib.contextmanager
def planted(cell: str, kind: str, seed: int, device):
    """Within the block, the program runs with ``kind`` planted underneath
    the timed path of ``cell``, for the run of ``seed`` on ``device``;
    ``program`` plants nothing."""
    if kind == "program":
        yield
        return
    spec = run.workload(run.manifest(), cell)
    config = run.data("configs", spec["config"])
    module, name, replacement = run.driver(_traffic(cell)).substitute(
        kind, run.reference(config), seed, device)
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


def _traffic(cell: str) -> dict:
    return run.data("traffic", run.workload(run.manifest(), cell)["traffic"])
