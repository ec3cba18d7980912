"""Run one cell of the port's benchmark once and print one JSON line.

    python3 benchmark/run.py --workload play-b32 --seed 7 --seconds 30 --trace 0

The cell, its configuration and its traffic are found by name through
`BENCHMARK.json` at the checkout's root: `configs/<config>.json`,
`traffic/<traffic>.json` (which names its driver, `drivers/<driver>.py`)
and one reader per per-layer metric, `metrics/<metric>.py`. With `--trace
0` the line's metrics are the cell's end-to-end ones, with `--trace 1` its
per-layer ones, read from a profiled part of the window.

A run needs as many CUDA devices as the cell asks for; without them it
exits 1 and prints no result. It measures the PyTorch port only and exits
3 without a result if JAX or the JAX package got loaded. The compared
numbers and their limits are the last lines on standard error and the
line's last key.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _named(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"BENCHMARK.json has no {what} {name!r}")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: end-to-end ones listing it (or
    listing no cells), or per-layer ones that list it, or that list no
    cells and move an end-to-end metric the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def environment() -> None:
    """Build caches at fixed paths inside the checkout, and no JAX loaded
    behind a library's back (`transformers` reads USE_FLAX)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = _named(spec["workloads"], args.workload, "workload")
    config = json.loads((ROOT / _named(spec["configs"], cell["config"], "config")["file"])
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    environment()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(BENCH))
    import harness

    driver = harness.load_module(BENCH / "drivers" / f"{traffic['driver']}.py")
    res = driver.run(cell, config, traffic, args.seed, args.seconds, bool(args.trace), STARTED)
    return report(spec, cell, res, bool(args.trace))


def report(spec: dict, cell: dict, res: dict, trace: bool) -> int:
    """Print the result line (and the checks on standard error); the exit
    code."""
    import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}; the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    device = harness.device_record(cell["chips"])
    device["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    line = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": {}, "device": device}
    rec = res["record"]
    if trace:
        summary = harness.reduce_trace(*rec["trace"]) if rec.get("trace") else harness.reduce_trace(
            [], [])
        rec["summary"] = summary
        device["busy_s"], device["window_s"] = summary["busy_s"], summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    for m in cell_metrics(spec, cell["name"], trace):
        if trace:
            value = harness.load_module(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        else:
            value = res["e2e"].get(m["name"])
        if value is not None:
            line["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
    line["checks"] = res["checks"]
    print(f"run.py: {res['attempted']} attempted, check of {res.get('sample')} took "
          f"{res.get('check_s', 0):.1f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
