"""moe_ms.bd: device milliseconds per step of the expert layers' kernels
that their names tell apart, in the profiled steps of the device trace:
the two launches of kernel K8 (`moe_gate_up_kernel`, `moe_down_kernel`,
`modules/moe.py` -> `ops/kernels/moe_experts.py`) and the routing's sorts
and `searchsorted` (the top-k of the router's logits and the dispatch of
the slots by expert), summed over a step's 5 passes of 48 layers, over the
number of profiled steps. The router's product, its softmax and the
combine's sum run as generic kernels that no name tells from the rest, so
they are not in it. Layer: the sparse experts. Moves `frames_per_s`. A
trace without those kernels gives no value."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402

PATTERNS = ("moe_gate_up_kernel", "moe_down_kernel", "SortKVInPlace", "searchsorted")


def step_ms(rec, patterns):
    """Device ms of the kernels whose names hold any of `patterns`, in the
    profiled steps' trace, over the number of those steps; None without a
    trace or such a kernel."""
    n = len(rec.get("traced") or ())
    if not n or not rec.get("trace"):
        return None
    seconds, launches = harness.kernel_seconds(rec["trace"][0], patterns)
    return 1e3 * seconds / n if launches else None


def read(rec):
    return step_ms(rec, PATTERNS)
