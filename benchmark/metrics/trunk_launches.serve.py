"""trunk_launches.serve: kernel launches per step inside the session's
`dynamics.refine` and `dynamics.commit` spans: the host's runtime and
driver rows `cudaLaunchKernel*` and `cuLaunchKernel*` that start in those
spans' host ranges, mean over the profiled steps. Layer: the dynamics
trunk (`models/dynamics.py::decode_frame`, the head). Moves
`frames_per_s`. A trace without those spans gives no value."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def read(rec):
    n = len(rec.get("traced") or ())
    if not n or not rec.get("trace"):
        return None
    idle = harness.load_module(Path(__file__).with_name("trunk_idle_ms.serve.py"))
    device, host = rec["trace"]
    spans = idle.span_ranges(host, idle.NAMES)
    if not spans or not device:
        return None
    return sum(1 for name, s, _ in host
               if name.startswith(LAUNCH) and idle.inside(spans, s)) / n
