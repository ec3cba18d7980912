"""A sparse-expert layer: a router over every expert, top-k with
renormalised weights, and SwiGLU experts computed as grouped products.

The port's own: the JAX package has no expert layer. As in Qwen3-MoE
(which SDAR-30B-A3B keeps): `p = softmax_f32(W_r x)` over `n_experts`,
the `top_k` largest (ties to the lower expert index), `w = p_top / sum
p_top` with `norm_topk_prob`, and `sum_e w_e down_e(silu(gate_e x) *
up_e x)`.

Dispatch and combine stay on the device: one stable sort of the slots by
expert, their offsets (`ops/kernels/moe_experts.py::route_slots`), the
two grouped-product kernels (K8) over every expert, and a sum over each
token's slots. The launches do not depend on the expert count and nothing
syncs the host.

Spans `moe.route` and `moe.experts` (`utils/debug.py::span`), and the
counter `moe_expert_load`: each pass's offsets of the experts' slots,
written into the layer's `load` buffer (so a CUDA graph of the pass
writes them too), a copy kept only while a profiler records (`expert_load`
reads it).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.ops.kernels.moe_experts import moe_experts, route_slots
from open_genie_tpu_torch.utils import debug


def route(logits: torch.Tensor, top_k: int, norm_topk_prob: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(weights, experts)`, both `(T, top_k)`: the `top_k` largest of the
    softmax of `(T, E)` router logits in f32, by a stable descending sort
    of the logits (the same order; a tie goes to the lower expert index),
    renormalised to sum to 1 with `norm_topk_prob`: the softmax of the
    kept logits, which equals `p_top / sum p_top`."""
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[:, :top_k], idx[:, :top_k]
    if norm_topk_prob:
        return torch.softmax(top, dim=-1, dtype=torch.float32), idx
    return torch.softmax(logits, dim=-1, dtype=torch.float32).gather(-1, idx), idx


class SparseMoE(nn.Module):
    """Top-k routed SwiGLU experts over `(..., d_model)` inputs.

    Parameters: `router` `(n_experts, d_model)`; `w_gate_up` `(n_experts,
    2 * d_expert, d_model)`, each expert's gate rows then its up rows;
    `w_down` `(n_experts, d_model, d_expert)`. Buffer `load` `(n_experts +
    1,)` int32: the last pass's offsets of each expert's sorted slots."""

    def __init__(self, d_model: int, n_experts: int, top_k: int, d_expert: int,
                 norm_topk_prob: bool = True):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"SparseMoE: top_k {top_k} does not fit {n_experts} experts")
        self.n_experts, self.top_k, self.norm_topk_prob = n_experts, top_k, norm_topk_prob
        self.router = nn.Linear(d_model, n_experts, bias=False)
        # device -> `arange(n_experts + 1)`, the experts' bounds
        self._bounds_on = {}
        self.w_gate_up = nn.Parameter(torch.empty(n_experts, 2 * d_expert, d_model))
        self.w_down = nn.Parameter(torch.empty(n_experts, d_model, d_expert))
        self.register_buffer("load", torch.zeros(n_experts + 1, dtype=torch.int32),
                             persistent=False)
        nn.init.normal_(self.w_gate_up, std=d_model ** -0.5)
        nn.init.normal_(self.w_down, std=d_expert ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        with debug.span("moe.route"):
            weights, idx = route(self.router(x2), self.top_k, self.norm_topk_prob)
        with debug.span("moe.experts"):
            bounds = self._bounds_on.get(x.device)
            if bounds is None:
                bounds = self._bounds_on[x.device] = torch.arange(self.n_experts + 1,
                                                                  device=x.device)
            order, offsets = route_slots(idx, bounds, out=self.load)
            debug.count("moe_expert_load", offsets)
            out = moe_experts(x2.contiguous(), self.w_gate_up, self.w_down, order, offsets,
                              weights.flatten(), self.top_k)
            y = out.view(x2.shape[0], self.top_k, -1).sum(1).to(x.dtype)
        return y.view(shape)


def expert_load(steps=None) -> List[dict]:
    """The `moe_expert_load` counter, one dict a layer pass: the slots of
    the busiest expert (`max`), the mean over the experts (`mean`), the
    experts that got a slot (`hit`) and their slots (`slots`). A value
    counted for several layers at once (`(layers, E + 1)`) gives one dict a
    layer."""
    out = []
    for rec in debug.counter_record("moe_expert_load", steps):
        value = rec["value"]
        for off in value if value and isinstance(value[0], list) else [value]:
            c = [b - a for a, b in zip(off[:-1], off[1:])]
            out.append({"step": rec["step"], "max": max(c), "mean": sum(c) / len(c),
                        "hit": sum(1 for n in c if n), "slots": sum(c)})
    return out
