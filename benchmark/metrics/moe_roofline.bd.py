"""moe_roofline.bd: the least time the expert layers' grouped products
need over the device time of the kernels that did them, in the profiled
steps. Layer: the kernels (K8, `ops/kernels/moe_experts.py`). Moves
`frames_per_s`.

Work: every layer pass that the `moe_expert_load` counter recorded in the
profiled steps, `moe_yardstick.experts_bound` of its slots and of the
experts that got one (bytes-bound at decode: the weights of every expert
hit, read once). Time: the device ops named `moe_gate_up_kernel` and
`moe_down_kernel`. A program without the counter or those kernels gives
no value."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402
from moe_yardstick import experts_bound  # noqa: E402

PATTERNS = ("moe_gate_up_kernel", "moe_down_kernel")


def read(rec):
    load, trace = rec.get("expert_load"), rec.get("trace")
    if not load or not trace:
        return None
    seconds, launches = harness.kernel_seconds(trace[0], PATTERNS)
    if not launches or not seconds:
        return None
    (_, kw), = rec["model"]["dynamics"]["desc"]
    bound_ms = sum(experts_bound(p["slots"], p["hit"], kw["n_embd"], kw["d_expert"],
                                 kw["top_k"])["bound_ms"] for p in load)
    return 100.0 * bound_ms / 1e3 / seconds
