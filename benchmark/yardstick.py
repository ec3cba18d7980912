"""The benchmark's fixed yardstick: the H100's published peaks and the
least-time arithmetic of a kernel.

Copied, frozen, from `chip_smoke.py` (`bound`, `flash_bound` and the peak
constants) so that what the benchmark counts does not move when the
program does. Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the
full 700 W power limit.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16 / fp16
PEAK_F32_FLOPS = 67e12     # CUDA cores, float32
PEAK_HBM_BYTES = 3.35e12   # bytes per second
HBM_BYTES = 80e9           # device memory
# Exponentials: 132 SMs x 16 ex2 per clock on the special-function units at
# the 1.83 GHz of the 989 TFLOP/s figure.
PEAK_EXP = 132 * 16 * 1.83e9


def bound(flops: float, nbytes: float, peak: float, exps: float = 0.0) -> dict:
    """The least time of a kernel: the larger of its operations over the
    peak for their type and its bytes (each input read once, each output
    written once) over the memory rate; beside it, the exponentials' own
    floor on the special-function units."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "exp_floor_ms": exps / PEAK_EXP * 1e3}


def flash_bound(kernel: str, bh: int, n: int, d: int, causal: bool = False) -> dict:
    """`bound` of flash attention's forward ("fwd"), its key/value gradient
    ("dkv") or its query gradient ("dq") on bf16 `(bh, n, d)`: 4, 8 or 6 d
    operations per (query, key) pair that the mask keeps, one exponential
    each; q, k, v (and dO, lse, delta) read, o and lse (dk and dv, dq)
    written."""
    pairs = bh * (n * (n + 1) // 2 if causal else n * n)
    rows, elt = bh * n, 2
    flops = {"fwd": 4, "dkv": 8, "dq": 6}[kernel] * d * pairs
    nbytes = {"fwd": 4 * rows * d * elt + 4 * rows,
              "dkv": 6 * rows * d * elt + 8 * rows,
              "dq": 5 * rows * d * elt + 8 * rows}[kernel]
    return bound(flops, nbytes, PEAK_BF16_FLOPS, exps=pairs)
