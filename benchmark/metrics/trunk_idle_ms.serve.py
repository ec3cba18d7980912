"""trunk_idle_ms.serve: milliseconds per step in which no operation ran on
the device while the host was inside a `dynamics.refine` or
`dynamics.commit` span, mean over the profiled steps. An idle gap (the
complement of the merged device operations of the profiled window, as
`harness.reduce_trace` takes it) counts whole where its midpoint lies in
such a span's host range, whatever op the host ran inside it. Layer: the
dynamics trunk (`models/dynamics.py::decode_frame`, the head). Moves
`frames_per_s`. A trace without those spans gives no value."""
import bisect
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402

NAMES = ("dynamics.refine", "dynamics.commit")


def span_ranges(host, names):
    """Merged `[start, end]` host ranges of the spans named in `names`."""
    return harness.merge((s, e) for name, s, e in host if name in names)


def inside(ranges, t) -> bool:
    i = bisect.bisect_right([s for s, _ in ranges], t) - 1
    return i >= 0 and ranges[i][1] >= t


def read(rec):
    n = len(rec.get("traced") or ())
    if not n or not rec.get("trace"):
        return None
    device, host = rec["trace"]
    spans = span_ranges(host, NAMES)
    if not spans or not device:
        return None
    lo = min(s for _, s, _ in device + host)
    hi = max(e for _, _, e in device + host)
    edges = [lo] + [x for iv in harness.merge((s, e) for _, s, e in device) for x in iv] + [hi]
    idle_us = sum(e - s for s, e in zip(edges[0::2], edges[1::2])
                  if e > s and inside(spans, (s + e) / 2))
    return idle_us / 1e3 / n
