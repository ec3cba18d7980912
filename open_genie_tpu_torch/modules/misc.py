"""ForwardBlock (the FFN of the space-time block and of the discriminator)
and the parameter-free activations.

Twin of `open_genie_tpu.modules.misc`. `ForwardBlock` is ported in its two
forms the port builds: `block='conv3d'` with `causal_time=True` (the
space-time attention block's: per-frame GroupNorm, then causal conv3d
layers) and `block='conv2d'` (the frame discriminator's: GroupNorm over the
image, then 2-D convs). tanh-GELU between the convs, GroupNorm eps 1e-6
(flax's default).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.norm import group_norm
from open_genie_tpu_torch.ops.conv import causal_conv3d, conv2d_cl
from open_genie_tpu_torch.utils import cast_tuple, default

ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu default
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "silu": F.silu,
}


def per_frame_group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm with statistics per frame of a `(B, T, H, W, C)` video
    (over `(H, W, C / groups)`), computed in f32 and cast back. Frame-local
    statistics keep the block causal in time and let the cached decode
    keep history frames normalised."""
    return group_norm(x, weight, bias, groups, eps, per_frame=True)


class Activation(nn.Module):
    """Parameter-free activation as a blueprint module (registry names
    `gelu`, `relu`, `leaky_relu`, `silu`)."""

    def __init__(self, fn: str = "gelu"):
        super().__init__()
        if fn not in ACTIVATIONS:
            raise ValueError(f"unknown activation {fn!r}")
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.fn](x)


class ForwardBlock(nn.Module):
    """GroupNorm -> conv (-> tanh-GELU -> conv ...), on channels-last
    `(B, T, H, W, C)` video (`block='conv3d'`, causal in time) or `(B, H, W,
    C)` images (`block='conv2d'`)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: Optional[int] = None,
        hid_dim: Optional[Union[int, Tuple[int, ...]]] = None,
        num_groups: int = 1,
        use_bias: bool = True,
        kernel_size: int = 3,
        block: str = "conv3d",
    ):
        super().__init__()
        if block not in ("conv3d", "conv2d"):
            raise NotImplementedError(f"ForwardBlock block={block!r} is not ported yet")
        hid = (hid_dim,) if isinstance(hid_dim, int) else tuple(default(hid_dim, ()))
        dims = (in_dim,) + hid + (default(out_dim, in_dim),)
        self.block = block
        self.num_groups = num_groups
        self.n_blocks = len(dims) - 1
        self.norm = nn.GroupNorm(num_groups, in_dim, eps=1e-6)
        conv, nd = (nn.Conv3d, 3) if block == "conv3d" else (nn.Conv2d, 2)
        self.padding = tuple((k - 1) // 2 for k in cast_tuple(kernel_size, nd))
        for i in range(self.n_blocks):
            self.add_module(
                f"block_{i}",
                conv(dims[i], dims[i + 1], cast_tuple(kernel_size, nd), bias=use_bias),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        video = self.block == "conv3d"
        h = group_norm(x, self.norm.weight, self.norm.bias, self.num_groups, self.norm.eps,
                       per_frame=video)
        for i in range(self.n_blocks):
            conv = getattr(self, f"block_{i}")
            if video:
                h = causal_conv3d(h, conv.weight, conv.bias)
            else:
                h = conv2d_cl(h, conv.weight, conv.bias, padding=self.padding)
            if i < self.n_blocks - 1:
                h = ACTIVATIONS["gelu"](h)
        return h
