"""Image modules on channels-last `(B, H, W, C)` (twin of `open_genie_tpu.modules.image`).

Used by the frame discriminator. GroupNorm is flax's default (eps 1e-6),
computed in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.norm import group_norm
from open_genie_tpu_torch.ops.conv import conv2d_cl
from open_genie_tpu_torch.ops.resample import blur_pool_2d, space_to_depth
from open_genie_tpu_torch.utils import cast_tuple, default

IntOr2 = Union[int, Tuple[int, int]]


class BlurPooling2d(nn.Module):
    """Registry `blur_pool`: anti-aliased strided downsample of `(B, H, W,
    C)` images by a binomial kernel (`ops.resample.blur_pool_2d`); no
    parameters, `num_groups` taken and ignored as in the JAX package."""

    def __init__(self, kernel_size: IntOr2 = 3, stride: IntOr2 = 2, num_groups: int = 1):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur_pool_2d(x, self.kernel_size, self.stride)


class SpaceDownsample(nn.Module):
    """Inverse pixel shuffle, then a 1x1 conv back to `in_dim` channels."""

    def __init__(self, in_dim: int, factor: int = 2):
        super().__init__()
        self.factor = factor
        self.proj = nn.Conv2d(in_dim * factor * factor, in_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_cl(space_to_depth(x, self.factor), self.proj.weight, self.proj.bias)


class ImageResidualBlock(nn.Module):
    """GroupNorm -> LeakyReLU -> conv, twice (then an optional
    `SpaceDownsample`), plus a residual that is a strided 1x1 conv when the
    width or the size changes and the identity otherwise."""

    def __init__(
        self,
        inp_channel: int,
        out_channel: Optional[int] = None,
        kernel_size: IntOr2 = 3,
        padding: IntOr2 = 1,
        num_groups: int = 1,
        downsample: Optional[int] = None,
    ):
        super().__init__()
        out_ch = default(out_channel, inp_channel)
        k = cast_tuple(kernel_size, 2)
        self.padding = cast_tuple(padding, 2)
        self.num_groups = num_groups
        self.stride = downsample or 1
        self.norm1 = nn.GroupNorm(num_groups, inp_channel, eps=1e-6)
        self.conv1 = nn.Conv2d(inp_channel, out_ch, k)
        self.norm2 = nn.GroupNorm(num_groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, k)
        self.down = SpaceDownsample(out_ch, downsample) if downsample else None
        project = out_channel is not None or downsample
        self.res_proj = nn.Conv2d(inp_channel, out_ch, 1) if project else None

    def _norm_act(self, norm: nn.GroupNorm, h: torch.Tensor) -> torch.Tensor:
        h = group_norm(h, norm.weight, norm.bias, self.num_groups, norm.eps)
        return F.leaky_relu(h, 0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv2d_cl(self._norm_act(self.norm1, x), self.conv1.weight, self.conv1.bias,
                      padding=self.padding)
        h = conv2d_cl(self._norm_act(self.norm2, h), self.conv2.weight, self.conv2.bias,
                      padding=self.padding)
        if self.down is not None:
            h = self.down(h)
        if self.res_proj is None:
            return h + x
        return h + conv2d_cl(x, self.res_proj.weight, self.res_proj.bias, stride=self.stride)
