"""Frame discriminator on channels-last images (twin of `open_genie_tpu.modules.discriminator`).

A conv stem, a pyramid of residual blocks (each, with `use_attn`, followed
by spatial attention and a conv FFN, both with a skip), a conv head and one
dense logit per image. Stages pair consecutive entries of the channel
pyramid and consume the first `len(dims) - 1` entries of `down_step`.
`VideoDiscriminator` is not ported yet.
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
from open_genie_tpu_torch.ops.conv import conv2d_cl
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
        for i, ((inp_dim, out_dim), down) in enumerate(zip(zip(dims[:-1], dims[1:]), down_step)):
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
