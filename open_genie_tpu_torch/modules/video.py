"""Video modules on channels-last `(B, T, H, W, C)` (twin of `open_genie_tpu.modules.video`).

`t_factor` is each module's time-axis length scaling, read by
`VideoTokenizer.temporal_downsampling`; the resamplers' `st_factor` is the
space-time volume scaling (`time_factor * space_factor ** 2`, reciprocal
for a downsampler), read by `LatentAction`'s encoder/decoder check.

Streaming decode: `CausalConv3d`, `DepthToSpaceTimeUpsample` and a causal
`VideoResidualBlock` take `cache=`, the trailing input window of each of
their time-causal convs (`stream_state_len()` frames, zeros at sequence
start: exactly the causal zero padding). They then run on the next `m`
frames alone, update the window IN PLACE and return `(out, cache)`; the
outputs equal the full forward's for those frames.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from open_genie_tpu_torch.modules.misc import ACTIVATIONS
from open_genie_tpu_torch.modules.norm import group_norm
from open_genie_tpu_torch.ops.conv import causal_conv3d, causal_time_pad, conv3d_cl
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

    def stream_state_len(self) -> int:
        """Frames of trailing input a stream step carries: the causal
        left-pad width."""
        return causal_time_pad(self.conv3d.kernel_size[0], self.stride[0], self.dilation[0])

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None):
        """Full causal forward, or with `cache` (the `(B, time_pad, H, W,
        C_in)` trailing input window) the conv VALID in time over
        `cache ++ x`: returns `(out, cache)`, the window moved on by
        `x`'s frames in place. Streaming needs time stride 1 (and the
        constant time padding that this module always has)."""
        if cache is None:
            return causal_conv3d(
                x, self.conv3d.weight, self.conv3d.bias, stride=self.stride,
                dilation=self.dilation, space_padding=self.space_padding,
            )
        assert self.stride[0] == 1, "streaming causal conv requires time stride 1"
        window = torch.cat([cache.to(x.dtype), x], dim=1)
        out = conv3d_cl(
            window, self.conv3d.weight, self.conv3d.bias, stride=self.stride,
            dilation=self.dilation, padding=(0, *self.space_padding),
        )
        cache.copy_(window[:, x.shape[1]:])
        return out, cache


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

    def stream_state_len(self) -> int:
        return self.conv.stream_state_len()

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None):
        """Full forward, or streaming with `cache`, the inner conv's input
        window: `m` frames in give `m * time_factor` frames out, and
        `(out, cache)` is returned."""
        if cache is None:
            return depth_to_spacetime(self.conv(x), self.time_factor, self.space_factor)
        h, cache = self.conv(x, cache=cache)
        return depth_to_spacetime(h, self.time_factor, self.space_factor), cache


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

    def stream_state_len(self) -> int:
        """Frames of trailing input each main-branch conv carries; the 1x1x1
        residual projection is stateless."""
        return self.conv1.stream_state_len()

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        """Full forward, or streaming with `cache` = `{"conv1", "conv2"}`,
        the main-branch convs' input windows: needs `use_causal` and
        frame-local norms (`per_frame_norm` or `use_norm=False`), and
        returns `(out, cache)`."""
        if cache is not None:
            assert self.use_causal, "streaming VideoResidualBlock requires use_causal=True"
            assert self.per_frame_norm or self.norm1 is None, (
                "streaming VideoResidualBlock requires per_frame_norm "
                "(time-pooled GroupNorm is not causal)"
            )
            h, _ = self.conv1(self.act(self._norm(self.norm1, x)), cache=cache["conv1"])
            h, _ = self.conv2(self.act(self._norm(self.norm2, h)), cache=cache["conv2"])
            return h + self.res_proj(x), cache
        h = self._conv(self.conv1, self.act(self._norm(self.norm1, x)), self.padding)
        h = self._conv(self.conv2, self.act(self._norm(self.norm2, h)), self.padding)
        return h + self._conv(self.res_proj, x, 0)
