"""Frame and video discriminators, channels-last (twin of `open_genie_tpu.modules.discriminator`).

A conv stem, a pyramid of residual blocks (each, with `use_attn`, followed
by spatial attention and a conv FFN, both with a skip), a conv head and one
dense logit per image or clip. Stages pair consecutive entries of the
channel pyramid and consume the first `len(dims) - 1` entries of
`down_step`. The JAX package sizes the dense head from its first input;
the port sizes it at build from `inp_size` by the convs' arithmetic.
"""
from __future__ import annotations

from math import prod
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.attention import SpatialAttention
from open_genie_tpu_torch.modules.image import ImageResidualBlock
from open_genie_tpu_torch.modules.misc import ForwardBlock
from open_genie_tpu_torch.modules.video import CausalConv3d, VideoResidualBlock
from open_genie_tpu_torch.ops.conv import conv2d_cl, conv3d_cl
from open_genie_tpu_torch.utils import cast_tuple


class FrameDiscriminator(nn.Module):
    """Per-image discriminator: `(B, H, W, C)` in [0, 1] -> `(B,)` logits."""

    def __init__(
        self,
        inp_size: Union[int, Tuple[int, int]],
        model_dim: int = 64,
        dim_mults: Tuple[int, ...] = (1, 2, 4),
        down_step: Tuple[Optional[int], ...] = (None, 2, 2),
        inp_channels: int = 3,
        kernel_size: Union[int, Tuple[int, int]] = 3,
        num_groups: int = 1,
        num_heads: int = 4,
        dim_head: int = 32,
        use_attn: bool = False,
        use_blur: bool = True,  # accepted for blueprint compatibility; unused
        act_fn: str = "leaky",  # likewise (the JAX module's blocks use leaky ReLU)
    ):
        super().__init__()
        dims = [model_dim * m for m in dim_mults]
        if len(dims) != len(down_step):
            raise ValueError("Dimension and downsample steps must match.")
        size = cast_tuple(inp_size, 2)
        self.use_attn = use_attn
        self.proj_in = nn.Conv2d(inp_channels, model_dim, 3)
        self.n_stages = len(dims) - 1
        # The first block takes the stem's width (JAX's takes its input's).
        widths = [model_dim] + dims[1:-1]
        for i, ((inp_dim, out_dim), down) in enumerate(zip(zip(widths, dims[1:]), down_step)):
            self.add_module(f"res_{i}", ImageResidualBlock(
                inp_dim, out_dim, downsample=down, num_groups=num_groups,
                kernel_size=kernel_size))
            if use_attn:
                self.add_module(f"attn_{i}", SpatialAttention(
                    num_heads, dim_head, d_inp=out_dim, d_out=out_dim))
                self.add_module(f"ff_{i}", ForwardBlock(
                    out_dim, hid_dim=4 * out_dim, block="conv2d", kernel_size=1))
            size = tuple(s // (down or 1) for s in size)
        self.head_conv = nn.Conv2d(dims[-1], dims[-1], 3)
        self.head = nn.Linear(prod(size) * dims[-1], 1)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        out = conv2d_cl(image, self.proj_in.weight, self.proj_in.bias, padding=1)
        for i in range(self.n_stages):
            out = getattr(self, f"res_{i}")(out)
            if self.use_attn:
                out = getattr(self, f"attn_{i}")(out) + out
                out = getattr(self, f"ff_{i}")(out) + out
        out = conv2d_cl(out, self.head_conv.weight, self.head_conv.bias, padding=1)
        out = F.leaky_relu(out, 0.01)
        # Flattened channels-last, as flax's Dense saw it: an NCHW flatten
        # would permute the head's weights.
        return self.head(out.reshape(out.shape[0], -1))[:, 0]


def _conv_len(n: int, k: int, stride: int = 1, pad: int = 0) -> int:
    """Output length of a conv over `n` with `pad` added in all."""
    return (n + pad - k) // stride + 1


def video_disc_out_size(
    inp_size: Tuple[int, int, int],
    kernel_size: Union[int, Tuple[int, int, int]] = 3,
    down_step: Tuple = (None, 2, 2),
    use_blur: bool = True,
    use_causal: bool = False,
) -> Tuple[int, int, int]:
    """`(T, H, W)` that `VideoDiscriminator`'s head conv sees for a clip of
    `inp_size`: the stem (a causal conv, or a conv padded 1 on each side),
    then per block conv1, the downsample of its `down_step` entry (a blur
    padded `(k - 1) // 2` a side, or a strided causal conv) and conv2; the
    head conv keeps the size. Only the first `len(down_step) - 1` entries
    are used, as the blocks pair consecutive widths."""
    k = cast_tuple(kernel_size, 3)
    sym = [2 * ((kk - 1) // 2) for kk in k]

    def conv(size):  # a block's or the causal stem's stride-1 conv
        if use_causal:  # time padded k - 1 on the left: kept
            return (size[0],) + tuple(_conv_len(n, kk, 1, p)
                                      for n, kk, p in zip(size[1:], k[1:], sym[1:]))
        return tuple(_conv_len(n, kk, 1, p) for n, kk, p in zip(size, k, sym))

    size = conv(inp_size) if use_causal else tuple(
        _conv_len(n, kk, 1, 2) for n, kk in zip(inp_size, k))
    for down in down_step[:-1]:
        size = conv(size)
        if down is not None:
            tf, sf = (down, down) if isinstance(down, int) else down
            strides = (tf, sf, sf)
            if use_blur:
                size = tuple(_conv_len(n, kk, s, p)
                             for n, kk, s, p in zip(size, k, strides, sym))
            else:  # time padded k - tf on the left
                size = (_conv_len(size[0], k[0], tf, k[0] - tf),) + tuple(
                    _conv_len(n, kk, s, p)
                    for n, kk, s, p in zip(size[1:], k[1:], strides[1:], sym[1:]))
        size = conv(size)
    return size


class VideoDiscriminator(nn.Module):
    """Whole-clip discriminator: `(B, T, H, W, C)` in [0, 1] -> `(B,)`
    logits. `inp_size` `(T, H, W)`, or `(T, H)` for `W = H`; the dense head
    flattens the head conv's output channels-last, and a clip of another
    size raises."""

    def __init__(
        self,
        inp_size: Union[Tuple[int, int], Tuple[int, int, int]],
        model_dim: int = 64,
        dim_mults: Tuple[int, ...] = (1, 2, 4),
        down_step: Tuple = (None, 2, 2),
        inp_channels: int = 3,
        kernel_size: Union[int, Tuple[int, int, int]] = 3,
        num_groups: int = 1,
        num_heads: int = 4,
        dim_head: int = 32,
        act_fn: str = "leaky",
        use_attn: bool = False,
        use_blur: bool = True,
        use_causal: bool = False,
    ):
        super().__init__()
        dims = [model_dim * m for m in dim_mults]
        if len(dims) != len(down_step):
            raise ValueError("Dimension and downsample steps must match.")
        size = tuple(inp_size)
        self.inp_size = size if len(size) == 3 else (size[0], size[1], size[1])
        k = cast_tuple(kernel_size, 3)
        self.use_attn = use_attn
        if use_causal:
            self.proj_in = CausalConv3d(inp_channels, model_dim, k)
        else:
            self.proj_in = nn.Conv3d(inp_channels, model_dim, k, padding=1)
        self.n_stages = len(dims) - 1
        # The first block takes the stem's width (JAX's takes its input's).
        widths = [model_dim] + dims[1:-1]
        for i, ((inp_dim, out_dim), down) in enumerate(zip(zip(widths, dims[1:]), down_step)):
            self.add_module(f"res_{i}", VideoResidualBlock(
                inp_dim, out_dim, downsample=down, num_groups=num_groups, kernel_size=k,
                act_fn=act_fn, use_blur=use_blur, use_causal=use_causal))
            if use_attn:
                self.add_module(f"attn_{i}", SpatialAttention(
                    num_heads, dim_head, d_inp=out_dim, d_out=out_dim))
                self.add_module(f"ff_{i}", ForwardBlock(
                    out_dim, hid_dim=4 * out_dim, block="conv3d", kernel_size=1,
                    causal_time=False))
        self.out_size = video_disc_out_size(self.inp_size, k, down_step, use_blur, use_causal)
        self.head_conv = nn.Conv3d(dims[-1], dims[-1], 3, padding=1)
        self.head = nn.Linear(prod(self.out_size) * dims[-1], 1)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        if tuple(video.shape[1:4]) != self.inp_size:
            raise ValueError(
                f"VideoDiscriminator built for clips of (T, H, W) = {self.inp_size} got "
                f"{tuple(video.shape[1:4])}")
        if isinstance(self.proj_in, CausalConv3d):
            out = self.proj_in(video)
        else:
            out = conv3d_cl(video, self.proj_in.weight, self.proj_in.bias, padding=1)
        for i in range(self.n_stages):
            out = getattr(self, f"res_{i}")(out)
            if self.use_attn:
                out = getattr(self, f"attn_{i}")(out) + out
                out = getattr(self, f"ff_{i}")(out) + out
        out = conv3d_cl(out, self.head_conv.weight, self.head_conv.bias, padding=1)
        out = F.leaky_relu(out, 0.01)
        return self.head(out.reshape(out.shape[0], -1))[:, 0]
