"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m benchmark.run --workload design1.viewport --seed 7 --seconds 40 --trace 0

A cell is ``<config>.<traffic>``: ``configs/<config>.json`` holds the
configuration, ``traffic/<traffic>.json`` the traffic mix, whose ``kind``
names its driver (``drivers/<kind>.py``), ``reference/<reference>.py`` the
configuration's plain reference, ``limits/<cell>.json`` the limit
of each number the check compares and ``metrics/<metric>.py`` each
metric's reader.  A run sets the cell up and warms it (``setup_s``, from
the first line of this module to the first timed call), measures for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON object as the last line of
standard output: the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a profile of the window's first
``trace.TRACE_SECONDS``.  Standard error gets the set-up's seconds by
stage, what the window did, and last the numbers compared beside their
limits, which are also under ``compared``, last in the result.

It fails, and prints no result, without a CUDA device or with fewer than
the cell asks for, when the program under test cannot be imported, and
when JAX, flax or the JAX package is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "designcsg_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def data(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_entries(bench: dict, cell: str, trace: bool):
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def driver(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['kind']}")


def reference(config: dict):
    """The configuration's plain reference: a function that builds it."""
    return importlib.import_module(f"benchmark.reference.{config['reference']}").design


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, sizes=None, stages=None) -> dict:
    """Set up, warm, measure and check one cell on ``device``; returns the
    result object without printing it.  ``sizes`` updates the
    configuration (the CPU tests run small frames and exports); ``stages``
    holds the set-up's seconds so far, by stage."""
    import torch

    from benchmark import trace as tracing

    spec = workload(bench, name)
    config = data("configs", spec["config"])
    for key, value in (sizes or {}).items():
        config[key] = {**config[key], **value} if isinstance(value, dict) else value
    traffic = data("traffic", spec["traffic"])
    limits = data("limits", name)
    cuda = device.type == "cuda"

    cell = driver(traffic).Cell(config, traffic, seed, device, reference(config))
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    profile = None
    if trace:
        # The first TRACE_SECONDS are traced and give the per-layer metrics;
        # the run then goes on untraced to its full length, and the check
        # reads what that rest produced.
        with tracing.traced(device) as capture:
            window = cell.window(min(seconds, tracing.TRACE_SECONDS), trace=True)
        profile = tracing.reduce(capture, window["spans"])
        if seconds > tracing.TRACE_SECONDS:
            cell.window(seconds - tracing.TRACE_SECONDS)
    else:
        window = cell.window(seconds)
    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded once the window closed: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    numbers = cell.check()
    compared = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    ctx = types.SimpleNamespace(setup_s=setup_s, window=window, trace=profile, cell=cell)
    metrics = {}
    for entry in metric_entries(bench, name, trace):
        value = metric_reader(entry["name"]).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(window["attempted"]),
        "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": spec["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown()
    result["setup"] = {**(stages or {}), **cell.stages, "setup_s": setup_s}
    result["window"] = summary(window)
    result["compared"] = compared
    return result


def summary(window: dict) -> dict:
    """What the window did, for standard error: its numbers and short lists,
    and the spread of its calls' seconds."""
    calls = window["call_s"]
    out = {k: v for k, v in window.items()
           if isinstance(v, (int, float)) or (k.endswith("_seen") and len(v) <= 8)}
    q = statistics.quantiles(calls, n=4, method="inclusive") if len(calls) > 1 else calls * 3
    out.update(call_min_s=min(calls), call_quartiles_s=q, call_max_s=max(calls))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache in the checkout, at fixed paths; no library loads JAX.
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    import designcsg_tpu_torch  # noqa: F401  (fails here without the program)

    stages = {"imports_s": time.perf_counter() - _T0}
    bench = manifest()
    chips = workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    at = time.perf_counter()
    torch.zeros(1, device=device)  # the card's context
    stages["cuda_s"] = time.perf_counter() - at

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, _T0, stages=stages)
    print(f"setup {json.dumps(result.pop('setup'))}", file=sys.stderr)
    print(f"window {json.dumps(result.pop('window'))}", file=sys.stderr)
    for key, c in result["compared"].items():
        print(f"compared {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
