"""attn_ms.bd: device milliseconds per step of kernel K9, the block-causal
attentions' grouped-query attention of a block over the cached prefix
(`block_attention_kernel`, `modules/attention.py::BlockCausalAttention` ->
`ops/kernels/block_attention.py`), in the profiled steps of the device
trace, summed over a step's 5 passes of 48 layers, over the number of
profiled steps. The projections, QK-norm, RoPE and the cache write run as
generic kernels that no name tells from the rest, so they are not in it.
Layer: block attention. Moves `frames_per_s`. Read as `moe_ms.bd` reads
its kernels."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402

PATTERNS = ("block_attention_kernel",)


def read(rec):
    return harness.load_module(Path(__file__).with_name("moe_ms.bd.py")).step_ms(rec, PATTERNS)
