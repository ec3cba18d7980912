"""Normalization modules on channels-last tensors (twin of `open_genie_tpu.modules.norm`).

Both modules default to eps 1e-5 (set explicitly in the JAX package, where
flax's own default is 1e-6). Statistics are computed in f32 and the result
cast back to the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def group_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    groups: int,
    eps: float,
    per_frame: bool = False,
) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of a `(B, ..., C)` tensor,
    pooled over every other non-batch axis; with `per_frame`, a 5-D video's
    statistics stay within each frame. f32 statistics, cast back."""
    shape = x.shape
    lead = shape[0] * shape[1] if per_frame and x.dim() == 5 else shape[0]
    c = shape[-1]
    xg = x.float().reshape(lead, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(shape)
    if weight is not None:
        out = out * weight.float() + bias.float()
    return out.to(x.dtype)


class GroupNorm(nn.Module):
    """Registry `group_norm`: GroupNorm pooled over time, space and the
    group's channels, or per frame (`per_frame=True`)."""

    def __init__(self, num_groups: int = 32, num_channels: Optional[int] = None,
                 eps: float = 1e-5, affine: bool = True, per_frame: bool = False):
        super().__init__()
        if num_channels is None:
            raise ValueError("group_norm needs num_channels")
        self.per_frame = per_frame
        self.gn = nn.GroupNorm(num_groups, num_channels, eps=eps, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.gn
        return group_norm(x, gn.weight, gn.bias, gn.num_groups, gn.eps, self.per_frame)


class AdaptiveGroupNorm(nn.Module):
    """Registry `adaptive_group_norm`: GroupNorm whose per-channel affine
    comes from a condition (the quantized latents in the MAGVIT2 decoder).

    The condition `(B, ..., dim_cond)` is mean-pooled in f32 over every
    axis but batch and channel (with `per_frame`, over space only, one
    affine per frame) and goes through the `std` and `avg` heads in f32
    (initialized weight 0 / bias 1 and all 0, as in the JAX package); the
    affine is cast to the input dtype.
    """

    def __init__(self, dim_cond: int, num_groups: int, num_channels: int,
                 cond_bias: bool = True, affine: bool = True, eps: float = 1e-5,
                 per_frame: bool = False):
        super().__init__()
        self.per_frame = per_frame
        self.gn = nn.GroupNorm(num_groups, num_channels, eps=eps, affine=affine)
        self.std = nn.Linear(dim_cond, num_channels)
        self.std.const_init = (0.0, 1.0)  # (weight, bias), read by utils.init_weights
        self.avg = None
        if cond_bias:
            self.avg = nn.Linear(dim_cond, num_channels)
            self.avg.const_init = (0.0, 0.0)
        with torch.no_grad():
            for head in (self.std, self.avg):
                if head is not None:
                    head.weight.fill_(head.const_init[0])
                    head.bias.fill_(head.const_init[1])

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is None:
            raise ValueError("AdaptiveGroupNorm requires a conditioning input")
        gn = self.gn
        norm = group_norm(x, gn.weight, gn.bias, gn.num_groups, gn.eps, self.per_frame)
        c = cond.float()
        first = 2 if self.per_frame else 1
        if self.per_frame and c.dim() < 3:
            raise ValueError("per_frame AdaptiveGroupNorm needs a (B, T, ..., dim_cond) condition")
        axes = tuple(range(first, c.dim() - 1))
        if axes:
            c = c.mean(dim=axes)
        heads = [F.linear(c, h.weight.float(), h.bias.float())
                 for h in (self.std, self.avg) if h is not None]
        if self.per_frame:
            t_x, t_c = x.shape[1], heads[0].shape[1]
            if t_x % t_c:
                raise ValueError(f"per_frame cond length {t_c} does not divide input length {t_x}")
            heads = [h.repeat_interleave(t_x // t_c, dim=1) for h in heads]
            shape = (x.shape[0], t_x) + (1,) * (x.dim() - 3) + (x.shape[-1],)
        else:
            shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        heads = [h.reshape(shape).to(norm.dtype) for h in heads]
        return norm * heads[0] + heads[1] if len(heads) == 2 else norm * heads[0]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, `F.rms_norm` (one kernel on the card):
    the statistics and the division in f32, then the scale."""
    return F.rms_norm(x, (x.shape[-1],), weight, eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (`rms_norm`), scale initialised to 1.
    The port's own: the JAX package has none."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
