"""The least time of a sparse-expert layer's grouped products (the two
launches of kernel K8, `moe_gate_up_kernel` and `moe_down_kernel`) on
one layer pass, from that pass's routing: `yardstick.bound` of their
operations and bytes.

Bytes, each input read once and each output written once: the weights of
every expert that got a slot (`hit` x 3 matrices of `d_model` x
`d_expert`), the tokens' rows, the sorted slots (int64), the routing
weights (f32), the intermediate `h` written by the first launch and read
by the second (`slots` x `d_expert`), and the f32 output rows (`slots` x
`d_model`). Operations: 2 per multiply-add of the three products of every
slot.
"""
from __future__ import annotations

from yardstick import PEAK_BF16_FLOPS, bound


def experts_bound(slots: int, hit: int, d_model: int, d_expert: int, top_k: int,
                  elt: int = 2) -> dict:
    """`bound` of one layer pass of `slots` (token, expert) pairs over
    `hit` experts, in `elt`-byte weights and activations."""
    tokens = slots // top_k
    weights = hit * 3 * d_model * d_expert * elt
    acts = (tokens * d_model * elt + slots * (8 + 4) + 2 * slots * d_expert * elt
            + slots * d_model * 4)
    flops = 2 * slots * 3 * d_model * d_expert
    return bound(flops, weights + acts, PEAK_BF16_FLOPS)
