"""attn_roofline.serve: the least time the session's spatial attention
needs over the device time of the kernels that did it, in the profiled
steps. Layer: the kernels (`ops/attention.py` and what it dispatches to).
Moves `frames_per_s`.

Work: every dynamics layer attends over each frame's h * w tokens in each
of a step's refinements and its commit, and `keep` times more at a
rebase, at (players x heads, h * w, d_head): `yardstick.flash_bound`,
whatever kernel runs it. Time: every kernel whose name marks a flash or
fused attention (the port's K1 in bf16 and f32, PyTorch's flash, memory-
efficient and cuDNN attention). The session's temporal decode attends
through plain matrix products and softmax, whose kernels no name tells
from the rest, so it is not in this metric."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402
from reference.genie_serve import expand, st_widths  # noqa: E402
from yardstick import flash_bound  # noqa: E402

PATTERNS = ("flash_fwd", "flash_bwd", "fmha_cutlass", "flash_attn", "native_sdpa",
            "attention_kernel")


def read(rec):
    if not rec.get("trace"):
        return None
    seconds, launches = harness.kernel_seconds(rec["trace"][0], PATTERNS)
    if not launches or not seconds:
        return None
    h, w = rec["grid"]
    layers = [st_widths(kw) for _, kw in expand(rec["model"]["dynamics"]["desc"])]
    steps = [rec["steps"][i] for i in rec["traced"]]
    calls = sum(rec["steps_per_frame"] + 1 + (rec["keep"] if j == 0 and e > 0 else 0)
                for e, j, _ in steps)
    per_call = sum(flash_bound("fwd", rec["batch"] * heads[0], h * w, dh[0])["bound_ms"]
                   for _, _, _, _, heads, dh in layers)
    return 100.0 * calls * per_call / 1e3 / seconds
