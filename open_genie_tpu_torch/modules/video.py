"""Video modules on channels-last `(B, T, H, W, C)` (twin of `open_genie_tpu.modules.video`).

`t_factor` is each module's time-axis length scaling, read by
`VideoTokenizer.temporal_downsampling` and `blueprint_time_factor`; the
resamplers' `st_factor` is the space-time volume scaling (`time_factor *
space_factor ** 2`, reciprocal for a downsampler), read by `LatentAction`'s
encoder/decoder check. Both are class properties where the JAX package's
are, so a blueprint's factor needs no module of the names that have none.
`VideoResidualBlock` has no `t_factor`, with `downsample` too: the JAX
package's has none, and the port keeps its `temporal_downsampling`.

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
from open_genie_tpu_torch.ops.conv import (
    CONSTANT_PAD_MODES,
    causal_conv3d,
    causal_conv_transpose3d,
    causal_time_pad,
    conv3d_cl,
)
from open_genie_tpu_torch.ops.resample import (
    blur_pool_3d,
    depth_to_space,
    depth_to_spacetime,
    depth_to_time,
)
from open_genie_tpu_torch.utils import cast_tuple, default

IntOr3 = Union[int, Tuple[int, int, int]]


class CausalConv3d(nn.Module):
    """Causal 3-D conv: time padded on the left only, space symmetrically,
    both in `pad_mode` (numpy's names, zeros by default), optionally
    strided."""

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
        kt, kh, kw = cast_tuple(kernel_size, 3)
        pad = padding if isinstance(padding, (tuple, list)) else (padding, padding)
        self.space_padding = (default(pad[0], (kh - 1) // 2), default(pad[1], (kw - 1) // 2))
        self.stride = cast_tuple(stride, 3)
        self.dilation = cast_tuple(dilation, 3)
        self.pad_mode = pad_mode
        self.conv3d = nn.Conv3d(
            in_channels, out_channels, (kt, kh, kw), stride=self.stride,
            dilation=self.dilation, bias=use_bias,
        )

    @property
    def t_factor(self) -> float:
        return 1.0 / self.stride[0]

    def stream_state_len(self) -> int:
        """Frames of trailing input a stream step carries: the causal
        left-pad width."""
        return causal_time_pad(self.conv3d.kernel_size[0], self.stride[0], self.dilation[0])

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None):
        """Full causal forward, or with `cache` (the `(B, time_pad, H, W,
        C_in)` trailing input window) the conv VALID in time over
        `cache ++ x`: returns `(out, cache)`, the window moved on by
        `x`'s frames in place. Streaming needs time stride 1 and the
        constant pad mode (an edge pad would depend on the first frame)."""
        if cache is None:
            return causal_conv3d(
                x, self.conv3d.weight, self.conv3d.bias, stride=self.stride,
                dilation=self.dilation, space_padding=self.space_padding,
                pad_mode=self.pad_mode,
            )
        assert self.stride[0] == 1, "streaming causal conv requires time stride 1"
        assert self.pad_mode in CONSTANT_PAD_MODES, (
            "streaming causal conv requires constant time padding")
        window = torch.cat([cache.to(x.dtype), x], dim=1)
        out = conv3d_cl(
            window, self.conv3d.weight, self.conv3d.bias, stride=self.stride,
            dilation=self.dilation, padding=(0, *self.space_padding),
        )
        cache.copy_(window[:, x.shape[1]:])
        return out, cache


class CausalConvTranspose3d(nn.Module):
    """Registry `causal-conv3d-transpose`: a transposed 3-D conv whose output
    is trimmed to `(T * st, H * sh, W * sw)`, keeping the leading frames
    (`ops.conv.causal_conv_transpose3d`). The weight sits in an
    `nn.ConvTranspose3d`, so the bridge flips flax's kernel into it."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: IntOr3 = 3,
        stride: IntOr3 = 1,
        space_pad: Optional[Union[int, Tuple[int, int]]] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        k = cast_tuple(kernel_size, 3)
        pad = space_pad if isinstance(space_pad, (tuple, list)) else (space_pad, space_pad)
        self.space_padding = (default(pad[0], k[1] // 2), default(pad[1], k[2] // 2))
        self.stride = cast_tuple(stride, 3)
        self.conv_transpose3d = nn.ConvTranspose3d(
            in_channels, out_channels, k, stride=self.stride, bias=use_bias)

    @property
    def t_factor(self) -> float:
        return float(self.stride[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv_transpose3d
        return causal_conv_transpose3d(x, conv.weight, conv.bias, stride=self.stride,
                                       space_padding=self.space_padding)


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
        self.time_factor, self.space_factor = time_factor, space_factor
        self.down = CausalConv3d(
            in_channels, default(out_channels, in_channels),
            kernel_size=kernel_size,
            stride=(time_factor, space_factor, space_factor),
        )

    @property
    def t_factor(self) -> float:
        return 1.0 / self.time_factor

    @property
    def st_factor(self) -> float:
        return 1.0 / (self.time_factor * self.space_factor ** 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(x)


class _DepthToUpsample(nn.Module):
    """A 1x1x1 conv `proj` to `C_out * factor ** n_axes` channels, then a
    pixel shuffle."""

    def __init__(self, in_channels: int, out_channels: Optional[int], factor: int,
                 n_axes: int):
        super().__init__()
        self.factor = factor
        self.proj = nn.Conv3d(in_channels, default(out_channels, in_channels) * factor ** n_axes,
                              1)

    def _proj(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_cl(x, self.proj.weight, self.proj.bias)


class DepthToSpaceUpsample(_DepthToUpsample):
    """Registry `depth2space_upsample`: per-frame 1x1 conv and space shuffle
    (channel order `(c p q)`). Frame-local, so it streams with no state."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, factor: int = 2):
        super().__init__(in_channels, out_channels, factor, 2)

    @property
    def st_factor(self) -> float:
        return float(self.factor ** 2)

    @property
    def t_factor(self) -> float:
        return 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(self._proj(x), self.factor)


class DepthToTimeUpsample(_DepthToUpsample):
    """Registry `depth2time_upsample`: 1x1 conv and time shuffle (channel
    order `(c f)`): each frame becomes `factor` frames, so it streams with
    no state, `factor` frames out per frame in."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, factor: int = 2):
        super().__init__(in_channels, out_channels, factor, 1)

    @property
    def st_factor(self) -> float:
        return float(self.factor)

    @property
    def t_factor(self) -> float:
        return float(self.factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_time(self._proj(x), self.factor)


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
        self.conv = CausalConv3d(
            in_channels, out_ch * time_factor * space_factor ** 2,
            kernel_size=kernel_size,
        )

    @property
    def t_factor(self) -> float:
        return float(self.time_factor)

    @property
    def st_factor(self) -> float:
        return float(self.time_factor * self.space_factor ** 2)

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
        self.time_factor, self.space_factor = time_factor, space_factor
        self.up = nn.ConvTranspose3d(
            in_channels, default(out_channels, in_channels), factors, stride=factors
        )

    @property
    def t_factor(self) -> float:
        return float(self.time_factor)

    @property
    def st_factor(self) -> float:
        return float(self.time_factor * self.space_factor ** 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.up(x.permute(0, 4, 1, 2, 3))
        return out.permute(0, 2, 3, 4, 1)


class BlurPooling3d(nn.Module):
    """Anti-aliased downsample by a constant binomial kernel, depthwise
    (`ops.resample.blur_pool_3d`); no parameters. `out_channels` and
    `num_groups` are taken and ignored, as in the JAX package: the output
    width is the input width. It has no registry name there either."""

    def __init__(
        self,
        in_channels: int,
        kernel_size: IntOr3 = 3,
        out_channels: Optional[int] = None,
        time_factor: int = 2,
        space_factor: Union[int, Tuple[int, int]] = 2,
        num_groups: int = 1,
    ):
        super().__init__()
        self.kernel_size, self.time_factor, self.space_factor = (
            kernel_size, time_factor, space_factor)

    @property
    def t_factor(self) -> float:
        return 1.0 / self.time_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur_pool_3d(x, self.kernel_size, self.time_factor, self.space_factor)


# The JAX residual block's names: the registry's activations and two aliases.
_RESIDUAL_ACTS = {**ACTIVATIONS, "leaky": ACTIVATIONS["leaky_relu"], "swish": ACTIVATIONS["silu"]}


class VideoResidualBlock(nn.Module):
    """Registry `video-residual`: two-branch residual block.

    main: GroupNorm -> act -> conv(k) -> [down] -> GroupNorm -> act -> conv(k)
    res : [down] -> 1x1x1 conv (always, as in the JAX package)

    The convs are symmetric-padded and non-causal (`nn.Conv3d`, zeros:
    `pad_mode` does not reach them, as in the JAX package), or
    `CausalConv3d` in `pad_mode` with `use_causal`. GroupNorm is flax's
    default (eps 1e-6) pooled over T, H, W and the group's channels, or per
    frame with `per_frame_norm`. `downsample` (`d` for `(d, d)`, or `(tf,
    sf)`) blurs with the block's kernel size (`use_blur`, no parameters) or
    runs a strided `SpaceTimeDownsample` (`down_main` on the main branch,
    `down_res` on the residual).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        kernel_size: IntOr3 = 3,
        num_groups: int = 1,
        pad_mode: str = "constant",
        downsample: Optional[Union[int, Tuple[int, int]]] = None,
        use_causal: bool = False,
        use_norm: bool = True,
        use_blur: bool = True,
        act_fn: str = "swish",
        per_frame_norm: bool = False,
    ):
        super().__init__()
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
        if use_causal:
            conv = lambda i, o, kk: CausalConv3d(i, o, kk, pad_mode=pad_mode)  # noqa: E731
        else:
            conv = nn.Conv3d
        self.conv1 = conv(in_channels, out_ch, k)
        self.conv2 = conv(out_ch, out_ch, k)
        self.res_proj = conv(in_channels, out_ch, 1)
        self.downsample = (downsample, downsample) if isinstance(downsample, int) else downsample
        self.down_main = self.down_res = None
        if self.downsample is not None:
            tf, sf = self.downsample
            if use_blur:
                self.down_main = self.down_res = BlurPooling3d(
                    out_ch, kernel_size=k, time_factor=tf, space_factor=sf)
            else:
                self.down_main = SpaceTimeDownsample(out_ch, k, time_factor=tf, space_factor=sf)
                self.down_res = SpaceTimeDownsample(in_channels, k, time_factor=tf,
                                                    space_factor=sf)

    def _norm(self, norm: Optional[nn.GroupNorm], h: torch.Tensor) -> torch.Tensor:
        if norm is None:
            return h
        return group_norm(h, norm.weight, norm.bias, self.num_groups, norm.eps,
                          per_frame=self.per_frame_norm)

    def _conv(self, conv: nn.Module, h: torch.Tensor, padding) -> torch.Tensor:
        if self.use_causal:
            return conv(h)
        return conv3d_cl(h, conv.weight, conv.bias, padding=padding)

    @staticmethod
    def _down(down: Optional[nn.Module], h: torch.Tensor) -> torch.Tensor:
        return h if down is None else down(h)

    def stream_state_len(self) -> int:
        """Frames of trailing input each main-branch conv carries; the 1x1x1
        residual projection is stateless."""
        return self.conv1.stream_state_len()

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        """Full forward, or streaming with `cache` = `{"conv1", "conv2"}`,
        the main-branch convs' input windows: needs `use_causal`, no
        downsample and frame-local norms (`per_frame_norm` or
        `use_norm=False`), and returns `(out, cache)`."""
        if cache is not None:
            assert self.use_causal and self.downsample is None, (
                "streaming VideoResidualBlock: use_causal=True, no downsample")
            assert self.per_frame_norm or self.norm1 is None, (
                "streaming VideoResidualBlock requires per_frame_norm "
                "(time-pooled GroupNorm is not causal)"
            )
            h, _ = self.conv1(self.act(self._norm(self.norm1, x)), cache=cache["conv1"])
            h, _ = self.conv2(self.act(self._norm(self.norm2, h)), cache=cache["conv2"])
            return h + self.res_proj(x), cache
        h = self._conv(self.conv1, self.act(self._norm(self.norm1, x)), self.padding)
        h = self._down(self.down_main, h)
        h = self._conv(self.conv2, self.act(self._norm(self.norm2, h)), self.padding)
        return h + self._conv(self.res_proj, self._down(self.down_res, x), 0)
