"""A run of a cell on the CPU at a small size, with the card check
skipped."""

import time

import torch

from benchmark import run

# Frames at 40x30; exports at their own configuration (at smaller octrees
# a sound export's volume gap passes its limit).
SMALL = {"viewport": {"viewport": {"width": 40, "height": 30}}, "export": {}}


def run_small(cell: str, seed: int, seconds: float, trace: bool = False) -> dict:
    kind = cell.split(".")[1]
    return run.run_cell(run.manifest(), cell, seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), sizes=SMALL[kind])
