"""ForwardBlock: the causal conv3d FFN of the space-time block.

Twin of `open_genie_tpu.modules.misc.ForwardBlock` in its `block='conv3d'`,
`causal_time=True` form (the only form the space-time attention block
builds): per-frame GroupNorm, then causal conv3d layers with tanh-GELU
between them.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.ops.conv import causal_conv3d
from open_genie_tpu_torch.utils import cast_tuple, default


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
    b, t, h, w, c = x.shape
    xg = x.float().reshape(b * t, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return (xn * weight.float() + bias.float()).to(x.dtype)


class ForwardBlock(nn.Module):
    """Per-frame GroupNorm -> causal conv3d (-> tanh-GELU -> conv3d ...)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: Optional[int] = None,
        hid_dim: Optional[Union[int, Tuple[int, ...]]] = None,
        num_groups: int = 1,
        use_bias: bool = True,
        kernel_size: int = 3,
    ):
        super().__init__()
        hid = (hid_dim,) if isinstance(hid_dim, int) else tuple(default(hid_dim, ()))
        dims = (in_dim,) + hid + (default(out_dim, in_dim),)
        self.num_groups = num_groups
        self.n_blocks = len(dims) - 1
        self.norm = nn.GroupNorm(num_groups, in_dim, eps=1e-6)
        for i in range(self.n_blocks):
            self.add_module(
                f"block_{i}",
                nn.Conv3d(dims[i], dims[i + 1], cast_tuple(kernel_size, 3),
                          bias=use_bias),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = per_frame_group_norm(x, self.norm.weight, self.norm.bias, self.num_groups)
        for i in range(self.n_blocks):
            conv = getattr(self, f"block_{i}")
            h = causal_conv3d(h, conv.weight, conv.bias)
            if i < self.n_blocks - 1:
                h = F.gelu(h, approximate="tanh")  # flax's nn.gelu default
        return h
