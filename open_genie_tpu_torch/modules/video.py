"""Video modules on channels-last `(B, T, H, W, C)` (twin of `open_genie_tpu.modules.video`).

`t_factor` is each module's time-axis length scaling, read by
`VideoTokenizer.temporal_downsampling`; the resamplers' `st_factor` is the
space-time volume scaling (`time_factor * space_factor ** 2`, reciprocal
for a downsampler), read by `LatentAction`'s encoder/decoder check.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from open_genie_tpu_torch.modules.misc import ACTIVATIONS
from open_genie_tpu_torch.modules.norm import group_norm
from open_genie_tpu_torch.ops.conv import causal_conv3d, conv3d_cl
from open_genie_tpu_torch.ops.resample import depth_to_spacetime
from open_genie_tpu_torch.utils import cast_tuple, default

IntOr3 = Union[int, Tuple[int, int, int]]


class CausalConv3d(nn.Module):
    """Causal 3-D conv: time zero-padded on the left only, space padded
    symmetrically, optionally strided."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: IntOr3 = 3,
        stride: IntOr3 = 1,
        dilation: IntOr3 = 1,
        padding: Optional[Union[int, Tuple[int, int]]] = None,
        pad_mode: str = "constant",
        use_bias: bool = True,
    ):
        super().__init__()
        if pad_mode not in ("constant", "zeros"):
            raise NotImplementedError(
                f"CausalConv3d pad_mode={pad_mode!r} is not ported yet"
            )
        kt, kh, kw = cast_tuple(kernel_size, 3)
        pad = padding if isinstance(padding, (tuple, list)) else (padding, padding)
        self.space_padding = (default(pad[0], (kh - 1) // 2), default(pad[1], (kw - 1) // 2))
        self.stride = cast_tuple(stride, 3)
        self.dilation = cast_tuple(dilation, 3)
        self.t_factor = 1.0 / self.stride[0]
        self.conv3d = nn.Conv3d(
            in_channels, out_channels, (kt, kh, kw), stride=self.stride,
            dilation=self.dilation, bias=use_bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return causal_conv3d(
            x, self.conv3d.weight, self.conv3d.bias, stride=self.stride,
            dilation=self.dilation, space_padding=self.space_padding,
        )


class SpaceTimeDownsample(nn.Module):
    """Strided causal-conv downsample."""

    def __init__(
        self,
        in_channels: int,
        kernel_size: IntOr3 = 3,
        out_channels: Optional[int] = None,
        time_factor: int = 2,
        space_factor: int = 2,
    ):
        super().__init__()
        self.t_factor = 1.0 / time_factor
        self.st_factor = 1.0 / (time_factor * space_factor ** 2)
        self.down = CausalConv3d(
            in_channels, default(out_channels, in_channels),
            kernel_size=kernel_size,
            stride=(time_factor, space_factor, space_factor),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(x)


class DepthToSpaceTimeUpsample(nn.Module):
    """CausalConv3d + joint space-time pixel shuffle (channel order `(c p q r)`)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        time_factor: int = 2,
        space_factor: int = 2,
        kernel_size: IntOr3 = 1,
    ):
        super().__init__()
        out_ch = default(out_channels, in_channels)
        self.time_factor, self.space_factor = time_factor, space_factor
        self.t_factor = float(time_factor)
        self.st_factor = float(time_factor * space_factor ** 2)
        self.conv = CausalConv3d(
            in_channels, out_ch * time_factor * space_factor ** 2,
            kernel_size=kernel_size,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_spacetime(self.conv(x), self.time_factor, self.space_factor)


class SpaceTimeUpsample(nn.Module):
    """Strided transposed-conv upsample with kernel = stride =
    `(time_factor, space_factor, space_factor)`: every input position
    writes its own output block. Blueprint name `spacetime_upsample`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        time_factor: int = 2,
        space_factor: int = 2,
        kernel_size: IntOr3 = 3,  # accepted for blueprint compatibility; unused
    ):
        super().__init__()
        factors = (time_factor, space_factor, space_factor)
        self.t_factor = float(time_factor)
        self.st_factor = float(time_factor * space_factor ** 2)
        self.up = nn.ConvTranspose3d(
            in_channels, default(out_channels, in_channels), factors, stride=factors
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.up(x.permute(0, 4, 1, 2, 3))
        return out.permute(0, 2, 3, 4, 1)


# The JAX residual block's names: the registry's activations and two aliases.
_RESIDUAL_ACTS = {**ACTIVATIONS, "leaky": ACTIVATIONS["leaky_relu"], "swish": ACTIVATIONS["silu"]}


class VideoResidualBlock(nn.Module):
    """Registry `video-residual`: two-branch residual block.

    main: GroupNorm -> act -> conv(k) -> GroupNorm -> act -> conv(k)
    res : 1x1x1 conv (always, as in the JAX package)

    The convs are symmetric-padded and non-causal (`nn.Conv3d`), or
    `CausalConv3d` with `use_causal`. GroupNorm is flax's default (eps
    1e-6) pooled over T, H, W and the group's channels, or per frame with
    `per_frame_norm`. The downsampling branch, blur pooling and other pad
    modes are not ported yet.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        kernel_size: IntOr3 = 3,
        num_groups: int = 1,
        pad_mode: str = "constant",
        downsample=None,
        use_causal: bool = False,
        use_norm: bool = True,
        use_blur: bool = True,
        act_fn: str = "swish",
        per_frame_norm: bool = False,
    ):
        super().__init__()
        if downsample is not None:
            raise NotImplementedError("VideoResidualBlock downsample is not ported yet")
        if pad_mode not in ("constant", "zeros"):
            raise NotImplementedError(f"VideoResidualBlock pad_mode={pad_mode!r} is not ported yet")
        out_ch = default(out_channels, in_channels)
        k = cast_tuple(kernel_size, 3)
        self.act = _RESIDUAL_ACTS[act_fn]
        self.num_groups, self.per_frame_norm = num_groups, per_frame_norm
        self.use_causal = use_causal
        self.padding = tuple((kk - 1) // 2 for kk in k)
        if use_norm:
            self.norm1 = nn.GroupNorm(num_groups, in_channels, eps=1e-6)
            self.norm2 = nn.GroupNorm(num_groups, out_ch, eps=1e-6)
        else:
            self.norm1 = self.norm2 = None
        conv = CausalConv3d if use_causal else nn.Conv3d
        self.conv1 = conv(in_channels, out_ch, k)
        self.conv2 = conv(out_ch, out_ch, k)
        self.res_proj = conv(in_channels, out_ch, 1)

    def _norm(self, norm: Optional[nn.GroupNorm], h: torch.Tensor) -> torch.Tensor:
        if norm is None:
            return h
        return group_norm(h, norm.weight, norm.bias, self.num_groups, norm.eps,
                          per_frame=self.per_frame_norm)

    def _conv(self, conv: nn.Module, h: torch.Tensor, padding) -> torch.Tensor:
        if self.use_causal:
            return conv(h)
        return conv3d_cl(h, conv.weight, conv.bias, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self._conv(self.conv1, self.act(self._norm(self.norm1, x)), self.padding)
        h = self._conv(self.conv2, self.act(self._norm(self.norm2, h)), self.padding)
        return h + self._conv(self.res_proj, x, 0)
