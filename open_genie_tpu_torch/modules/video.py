"""Video modules on channels-last `(B, T, H, W, C)` (twin of `open_genie_tpu.modules.video`).

`t_factor` is each module's time-axis length scaling, read by
`VideoTokenizer.temporal_downsampling`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from open_genie_tpu_torch.ops.conv import causal_conv3d
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
        self.conv = CausalConv3d(
            in_channels, out_ch * time_factor * space_factor ** 2,
            kernel_size=kernel_size,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_spacetime(self.conv(x), self.time_factor, self.space_factor)
