"""Readings that a cell's limits are set from, on the card, in one process.

    python3 -m benchmark.calibrate --workload design1.viewport --seeds 1 2 3 --seconds 2

Each seed gets a run of the cell as the benchmark makes it, with a short
window, and the numbers its check compares: the lower readings.  The first
three seeds then get the same run with the control, and with each fault of
the cell's driver, planted underneath the timed path (``benchmark.faults``):
the upper readings.  One JSON line a run.  The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from benchmark import faults, run


def emit(**fields):
    print(json.dumps(fields), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    t0 = time.perf_counter()
    bench = run.manifest()
    device = torch.device("cuda", 0)
    for kind in ("program",) + faults.kinds(args.workload):
        for seed in args.seeds if kind == "program" else args.seeds[:3]:
            with faults.planted(args.workload, kind, seed, device):
                result = run.run_cell(bench, args.workload, seed, args.seconds, False, device,
                                      time.perf_counter())
            emit(kind=kind, seed=seed, attempted=result["attempted"],
                 **{k: c["value"] for k, c in result["compared"].items()})
    emit(kind="done", seconds=time.perf_counter() - t0, device=torch.cuda.get_device_name(device))


if __name__ == "__main__":
    main()
