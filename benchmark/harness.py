"""What every cell shares: percentiles over every sample, the device
record, the reduction of a `torch.profiler` trace to busy time, top device
operations and idle gaps, and the loading of files found by name."""
from __future__ import annotations

import bisect
import importlib.util
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "open_genie_tpu")


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values, q: float) -> float:
    """Nearest-rank percentile `q` (0-100] over every value."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that a run may not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_record(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


# --------------------------------------------------------------------------
# Traces
# --------------------------------------------------------------------------

def trace_events(prof):
    """`(device, host)`: the device operations (kernels, copies, sets) and
    the host ops of a finished `torch.profiler.profile`, each a list of
    `(name, start_us, end_us)`."""
    device, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and e.device_type.name != "CPU":
            continue
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        (host if e.device_type.name == "CPU" else device).append(row)
    return device, host


def merge(intervals):
    """Union of `(start, end)` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host_sorted, starts, t):
    """Name of the latest-starting host op that covers time `t`."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        name, s, e = host_sorted[j]
        if e >= t:
            return name
    return "(no host op)"


def reduce_trace(device, host, top: int = 10) -> dict:
    """Busy seconds, the traced window's length, the device ops that took
    most time and the idle gaps summed by what the host was doing, from
    `trace_events`' lists. The window runs from the first to the last
    event of either list."""
    if not device:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    lo = min(s for _, s, _ in device + host)
    hi = max(e for _, _, e in device + host)
    busy = merge((s, e) for _, s, e in device)
    busy_us = sum(e - s for s, e in busy)
    by_name = {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    host_sorted = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in host_sorted]
    gaps = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            name = _innermost(host_sorted, starts, (s + e) / 2)
            gaps[name] = gaps.get(name, 0.0) + (e - s)

    def top_of(d):
        return [[k[:120], v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
            "device_ops": top_of(by_name), "idle_gaps": top_of(gaps)}


def kernel_seconds(device, patterns) -> tuple:
    """`(seconds, launches)` of the device ops whose name holds any of
    `patterns`."""
    hits = [e - s for name, s, e in device if any(p in name for p in patterns)]
    return sum(hits) / 1e6, len(hits)
