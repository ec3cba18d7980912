"""The collectives of a data- and tensor-parallel step.

The JAX package's step on an `n_data` mesh computes the single-device step
on the global batch (GSPMD). A rank of the port holds only its rows, so
every batch statistic of a loss is reduced across the ranks here, and
every rank then holds the same global loss `L`. Its backward is reverse
mode over the ranks' joint graph:

  * `global_sums` all-reduces in the forward, and in the backward
    all-reduces the cotangents: every rank's use of the sum reaches every
    rank's summands;
  * `backward(loss, group)` seeds each rank's copy of `L` with 1/world, so
    the copies add up to `L` once.

Each rank's backward then yields `dL/dx_i` for its own rows `i` exactly,
however the statistics nest (a statistic of values that depend on another
statistic, as the bit balance's correlations of `tanh(x / rms)`), and the
sum over the ranks of the parameter gradients is `dL/dparams`: the step
all-reduces them by sum (`all_reduce_tensors_`), never by mean. A
separable term is `global_mean(local sum, local count)`; a non-linear
statistic (a batch mean inside an entropy, a covariance) is built from
`global_sums` of its local sums. An autograd Function that reduces in its
own forward (`LfqAvgEntropy`) all-reduces its cotangent likewise.

`group` is a `torch.distributed` process group, or None outside a
distributed run. A group of one rank reduces nothing either: with None or
one rank, every helper is the plain local op (`x.mean()`, `s / n`,
`loss.backward()`), with no launch added, so a step on one rank is the
step without a group bit for bit; only `all_reduce_tensors_` still runs
the gradients' all-reduce on a group of one rank (a copy).

On a mesh with a `model` axis, `group` above is the mesh's data group
(`Mesh.data_group`): the ranks of one data shard hold the same loss, so
each seeds it with 1/n_data. The model group's operators are Megatron's
(`copy_to_model`, `reduce_from_model`, `gather_from_model`): a split
layer's replicated input enters through `copy_to_model`, whose backward
sums the ranks' partial input gradients; a row-split layer's partial
outputs leave through `reduce_from_model`; a column-split output that the
next layer needs whole leaves through `gather_from_model`. Partials of a
16-bit dtype are summed (and gathered) in f32 and cast back. Only
all-reduce, all-gather and broadcast are used (gloo has no
reduce-scatter in every version).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

Number = Union[int, float, torch.Tensor]


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def reduces(group) -> bool:
    """Whether `group` spans more than one rank."""
    return world_size(group) > 1


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A contiguous f32 copy of a 16-bit float tensor, a contiguous copy of
    any other (what is handed to a collective)."""
    wide = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
    return t.detach().to(wide, copy=True).contiguous()


def all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks of `group` in f32 (or wider), cast back to
    `t`'s dtype, outside autograd; `t` itself when nothing reduces."""
    if not reduces(group):
        return t
    out = _wide(t)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def all_gather_wide(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t`, in rank order, outside autograd; 16-bit floats
    moved as f32 (exactly: cast them back)."""
    wide = _wide(t)
    parts = [torch.empty_like(wide) for _ in range(world_size(group))]
    dist.all_gather(parts, wide, group=group)
    return parts


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the cotangents summed over the
    model group (each rank's split branch gives part of the gradient of a
    replicated input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the ranks' partial outputs summed. Backward: the identity
    (the sum's cotangent is every rank's partial's)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the ranks' column blocks joined along the last axis.
    Backward: this rank's block of the cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.width, ctx.index = x.shape[-1], rank(group)
        return torch.cat(all_gather_wide(x, group), dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        at = ctx.index * ctx.width
        return g[..., at:at + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """`x` (replicated over the model group) as the input of split layers;
    `x` itself when the group holds one rank or none."""
    return _CopyToModel.apply(x, group) if reduces(group) else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of the ranks' partial `x`."""
    return _ReduceFromModel.apply(x, group) if reduces(group) else x


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The model group's column blocks `x` joined along the last axis."""
    return _GatherFromModel.apply(x, group) if reduces(group) else x


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed over the ranks, as a new tensor, outside autograd; `t`
    itself when nothing reduces."""
    if not reduces(group):
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumAcrossRanks(torch.autograd.Function):
    """Forward: the all-reduced sum. Backward: the all-reduced sum of the
    cotangents, the derivative of every rank's use of the sum by this
    rank's summand."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def backward(loss: torch.Tensor, group) -> None:
    """The backward of `loss`, the global loss that every rank of `group`
    (the data group) holds: seeded with 1/world of that group on each
    rank (see above); `loss.backward()` when nothing reduces."""
    if reduces(group):
        loss = loss / world_size(group)
    loss.backward()


def _sums_f64(values: Sequence[Number], group) -> List[torch.Tensor]:
    """Each value as a float64 tensor summed over the ranks in one
    all-reduce (float64: counts stay exact past 2^24, sums lose nothing),
    through `_SumAcrossRanks`."""
    device = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    tensors = [v.to(torch.float64) if isinstance(v, torch.Tensor)
               else torch.tensor(float(v), dtype=torch.float64, device=device) for v in values]
    flat = _SumAcrossRanks.apply(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [piece.view(t.shape) for piece, t in zip(flat.split([t.numel() for t in tensors]),
                                                    tensors)]


def global_sums(values: Sequence[Number], group) -> List[Number]:
    """Each value summed over the ranks, in one all-reduce: a tensor in its
    shape and dtype, differentiable (`_SumAcrossRanks`); a number
    (a count) as a float64 scalar. The values as given when nothing
    reduces."""
    if not reduces(group):
        return list(values)
    return [s.to(v.dtype) if isinstance(v, torch.Tensor) else s
            for s, v in zip(_sums_f64(values, group), values)]


def global_mean(local_sum: torch.Tensor, local_count: Number, group) -> torch.Tensor:
    """`sum over ranks of local_sum / sum over ranks of local_count`, in
    one all-reduce; `local_sum / local_count` when nothing reduces."""
    if not reduces(group):
        return local_sum / local_count
    total, count = _sums_f64([local_sum, local_count], group)
    return (total / count).to(local_sum.dtype)


def mean(x: torch.Tensor, group, dim: Optional[int] = None) -> torch.Tensor:
    """The mean of `x` over all its elements (or over `dim`, the batch's
    rows) of every rank: `x.mean()` / `x.mean(dim)` when nothing
    reduces."""
    if not reduces(group):
        return x.mean() if dim is None else x.mean(dim)
    if dim is None:
        return global_mean(x.sum(), x.numel(), group)
    return global_mean(x.sum(dim), x.shape[dim], group)


def all_reduce_tensors_(tensors: Sequence[torch.Tensor], group,
                        bucket_bytes: int = 1 << 26) -> None:
    """Sum each tensor over the ranks in place, packed into flat buckets
    of at most `bucket_bytes` (one all-reduce each, tensors of one dtype a
    bucket). Runs on a group of one rank too (a copy); nothing to do
    without a group."""
    if group is None:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        bucket, size = [], 0
        for t in same + [None]:
            nbytes = 0 if t is None else t.numel() * t.element_size()
            if bucket and (t is None or size + nbytes > bucket_bytes):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                at = 0
                for b in bucket:
                    b.copy_(flat[at:at + b.numel()].view_as(b))
                    at += b.numel()
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += nbytes


def broadcast_tensors_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite each tensor in place with global rank `src`'s, a member of
    `group` (no-op without a group)."""
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def gather_objects(obj, group) -> list:
    """Every rank's `obj` (picklable), in rank order; `[obj]` without a
    group."""
    if group is None:
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)
