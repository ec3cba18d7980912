"""Kernel K8: the grouped expert products of a sparse-expert layer (CUDA,
`csrc/moe_experts.cu`, two launches a call).

Replaces no TPU kernel: the JAX package has no expert layer. The layer
(`modules/moe.py`) sorts its token slots (one slot per token and chosen
expert) by expert; `offsets` marks where each expert's run of sorted slots
starts and ends, on the device. Two kernels then run over every expert at
once, a block per (row tile of one expert, column tile):

* `moe_gate_up` gathers the expert's tokens by their slots and forms `h =
  silu(x W_gate^T) * (x W_up^T)` in f32 from one pass over the expert's
  fused `(2 I, C)` weight, and stores `h` in bf16;
* `moe_down` forms `h W_down^T`, scales each row by its slot's routing
  weight and stores it in f32 at the slot's own row of the output.

A block past the last expert's tiles reads nothing. The work of a decode
pass (about 16 slots an expert) is bound by the bytes of the experts'
weights, each read once; a prefill chunk's by the tensor cores. The row
tile (`block_m`) follows the mean slots an expert, from shapes alone, and
the grid is a bound on the row tiles from shapes alone, so nothing syncs
the host. No atomics: the caller sums a token's `top_k` slot rows, in slot
order.

The wrapper dispatches by device: a CPU tensor goes to the plain twin, a
CUDA tensor launches the kernels (built at first use, never at import),
any other device raises. It counts its launches (two a call) in
`launches`, and by `(slots, experts, C, I, top_k)` in `launches_by_shape`.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from open_genie_tpu_torch.ops import kernels

_DTYPES = (torch.float32, torch.bfloat16)
TWIN_CHUNK = 64  # sorted slots the plain twin gathers weights for at once


def block_m(slots: int, experts: int) -> int:
    """Rows of a block's tile: twice the mean slots an expert (so that one
    tile holds nearly every expert's slots at decode, and each expert's
    weights are read once), rounded up to a power of two from 16 to 64."""
    want = 2 * -(-slots // max(experts, 1))
    return min(64, max(16, 1 << max(0, want - 1).bit_length()))


def moe_experts_plain(
    x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor, order: torch.Tensor,
    offsets: torch.Tensor, weights: torch.Tensor, top_k: int,
) -> torch.Tensor:
    """`moe_experts` in plain PyTorch, the kernels' arithmetic: f32
    products of the working-dtype operands, `h` rounded to `x`'s dtype.
    Gathers each sorted slot's expert weights, `TWIN_CHUNK` slots at a
    time."""
    s, c = order.shape[0], x.shape[1]
    i_dim = w_down.shape[2]
    out = torch.zeros(s, c, dtype=torch.float32, device=x.device)
    off = offsets.long()
    counts = off[1:] - off[:-1]
    experts = torch.repeat_interleave(torch.arange(counts.numel(), device=x.device), counts)
    first = int(off[0])
    slots = order[first: first + experts.numel()].long()
    for c0 in range(0, experts.numel(), TWIN_CHUNK):
        e, sl = experts[c0: c0 + TWIN_CHUNK], slots[c0: c0 + TWIN_CHUNK]
        xs = x[sl // top_k].float()
        gu = torch.einsum("sc,soc->so", xs, w_gate_up[e].float())
        h = (F.silu(gu[:, :i_dim]) * gu[:, i_dim:]).to(x.dtype).float()
        out[sl] = torch.einsum("si,sci->sc", h, w_down[e].float()) * weights[sl, None].float()
    return out


def _check(x, w_gate_up, w_down, order, offsets, weights, top_k) -> None:
    if x.dim() != 2 or w_gate_up.dim() != 3 or w_down.dim() != 3:
        raise ValueError(
            f"moe_experts takes x (T, C), w_gate_up (E, 2I, C), w_down (E, C, I); got "
            f"{tuple(x.shape)}, {tuple(w_gate_up.shape)}, {tuple(w_down.shape)}")
    t, c = x.shape
    e, two_i, c1 = w_gate_up.shape
    if c1 != c or two_i % 2 or tuple(w_down.shape) != (e, c, two_i // 2):
        raise ValueError(
            f"moe_experts: weights {tuple(w_gate_up.shape)}, {tuple(w_down.shape)} do not fit "
            f"x {tuple(x.shape)}")
    if order.shape != (t * top_k,) or weights.shape != (t * top_k,):
        raise ValueError(f"moe_experts: order {tuple(order.shape)} and weights "
                         f"{tuple(weights.shape)} must hold T * top_k = {t * top_k} slots")
    if offsets.shape != (e + 1,):
        raise ValueError(f"moe_experts: offsets {tuple(offsets.shape)}, want ({e + 1},)")
    if x.dtype not in _DTYPES or w_gate_up.dtype != x.dtype or w_down.dtype != x.dtype:
        raise ValueError(f"moe_experts takes x and weights of one dtype, float32 or bfloat16; "
                         f"got {x.dtype}, {w_gate_up.dtype}, {w_down.dtype}")
    if order.dtype != torch.int64 or offsets.dtype != torch.int32:
        raise ValueError(f"moe_experts takes int64 order and int32 offsets, got {order.dtype}, "
                         f"{offsets.dtype}")
    if weights.dtype != torch.float32:
        raise ValueError(f"moe_experts takes float32 routing weights, got {weights.dtype}")
    tensors = (x, w_gate_up, w_down, order, offsets, weights)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("moe_experts: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_experts takes contiguous inputs")


def moe_experts(
    x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor, order: torch.Tensor,
    offsets: torch.Tensor, weights: torch.Tensor, top_k: int,
) -> torch.Tensor:
    """Every expert's SwiGLU on the slots routed to it: `(T * top_k, C)`
    float32, row `s` the output of slot `s` (token `s // top_k`) scaled by
    `weights[s]`.

    `x` `(T, C)`; `w_gate_up` `(E, 2 I, C)`, gate rows then up rows, and
    `w_down` `(E, C, I)`, in x's dtype; `order` `(T * top_k,)` int64, the
    slots sorted by expert; `offsets` `(E + 1,)` int32, expert e's slots at
    `order[offsets[e]:offsets[e + 1]]`, every slot in one of them;
    `weights` `(T * top_k,)` float32 routing weights by slot."""
    _check(x, w_gate_up, w_down, order, offsets, weights, top_k)
    if x.device.type == "cpu":
        return moe_experts_plain(x, w_gate_up, w_down, order, offsets, weights, top_k)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts: no kernel for device {x.device}")
    s, c = order.shape[0], x.shape[1]
    e, i_dim = w_down.shape[0], w_down.shape[2]
    if x.dtype != torch.bfloat16 or c % 8 or i_dim % 8:
        raise ValueError(f"moe_experts' kernels take bfloat16 and C and I multiples of 8, got "
                         f"{x.dtype}, {c}, {i_dim}")
    if any(t.data_ptr() % 16 for t in (x, w_gate_up, w_down)):
        raise ValueError("moe_experts' kernels take x and weights aligned to 16 bytes")
    h = torch.empty(s, i_dim, dtype=x.dtype, device=x.device)
    out = torch.empty(s, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = kernels.library().moe_experts(
            x.data_ptr(), w_gate_up.data_ptr(), w_down.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), weights.data_ptr(), h.data_ptr(), out.data_ptr(), s, e, c,
            i_dim, top_k, block_m(s, e), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "moe_experts")
    moe_experts.launches += 2
    moe_experts.launches_by_shape[(s, e, c, i_dim, top_k)] += 2
    return out


moe_experts.launches = 0
moe_experts.launches_by_shape = Counter()


def route_slots(top_idx: torch.Tensor, bounds: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(order, offsets)` of `(T, top_k)` chosen expert ids: the slots (`t
    * top_k + j`) sorted by expert, stably, and the int32 positions in
    that order where each expert of `bounds` (`0 .. E`, an int tensor on
    the device) starts; expert e's slots are `order[offsets[e]:offsets[e +
    1]]`. `offsets` is written into `out` if given. Two launches, no
    sync."""
    experts, order = torch.sort(top_idx.flatten(), stable=True)
    return order, torch.searchsorted(experts, bounds, out_int32=True, out=out)
