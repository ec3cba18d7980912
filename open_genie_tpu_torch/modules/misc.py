"""ForwardBlock (the FFN of the space-time block and of the discriminator)
and the parameter-free activations.

Twin of `open_genie_tpu.modules.misc`. `ForwardBlock` takes the JAX
package's arguments and defaults: `block` `'dense'` (Linear layers over the
last axis), `'conv2d'` (channels-last images) or `'conv3d'` (channels-last
video). With `causal_time` a conv3d block normalises each frame on its own
and pads time on the left only (the space-time attention block's FFN);
without it GroupNorm pools over every axis but the batch and every pad is
symmetric (`(k - 1) // 2`). tanh-GELU between the layers (and after the
last with `last_act`), GroupNorm eps 1e-6 (flax's default).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_genie_tpu_torch.modules.norm import group_norm
from open_genie_tpu_torch.ops.conv import causal_conv3d, conv2d_cl, conv3d_cl
from open_genie_tpu_torch.parallel import collectives
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
    """GroupNorm -> (layer -> tanh-GELU) chain, the GELU after the last
    layer only with `last_act`; `hid_dim` an int, a tuple or None (no
    hidden layer).

    With a `tp_group` (`parallel.tensor.shard_module`) `block_0` holds
    this rank's output channels of the replicated, normalised input (the
    GroupNorm is not split): as the only layer its output is gathered;
    before `block_1`, which holds the matching input channels, the
    partial outputs of `block_1` are summed over the group and its bias
    added once."""

    tp_group = None

    def __init__(
        self,
        in_dim: int,
        out_dim: Optional[int] = None,
        hid_dim: Optional[Union[int, Tuple[int, ...]]] = 256,
        block: str = "dense",
        num_groups: int = 1,
        last_act: bool = False,
        use_bias: bool = True,
        kernel_size: int = 1,
        causal_time: bool = False,
    ):
        super().__init__()
        hid = (hid_dim,) if isinstance(hid_dim, int) else tuple(default(hid_dim, ()))
        dims = (in_dim,) + hid + (default(out_dim, in_dim),)
        self.block, self.num_groups, self.last_act = block, num_groups, last_act
        self.causal = block == "conv3d" and causal_time
        self.n_blocks = len(dims) - 1
        self.norm = nn.GroupNorm(num_groups, in_dim, eps=1e-6)
        if block == "dense":
            layer = lambda i, o: nn.Linear(i, o, bias=use_bias)  # noqa: E731
        elif block in ("conv2d", "conv3d"):
            nd = 2 if block == "conv2d" else 3
            k = cast_tuple(kernel_size, nd)
            self.padding = tuple((kk - 1) // 2 for kk in k)
            conv = nn.Conv2d if nd == 2 else nn.Conv3d
            layer = lambda i, o: conv(i, o, k, bias=use_bias)  # noqa: E731
        else:
            raise ValueError(f"ForwardBlock block={block!r} is not dense, conv2d or conv3d")
        for i in range(self.n_blocks):
            self.add_module(f"block_{i}", layer(dims[i], dims[i + 1]))

    def _layer(self, layer: nn.Module, h: torch.Tensor, bias: bool = True) -> torch.Tensor:
        b = layer.bias if bias else None
        if self.block == "dense":
            return F.linear(h, layer.weight, b)
        if self.block == "conv2d":
            return conv2d_cl(h, layer.weight, b, padding=self.padding)
        if self.causal:
            return causal_conv3d(h, layer.weight, b, space_padding=self.padding[1:])
        return conv3d_cl(h, layer.weight, b, padding=self.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm(x, self.norm.weight, self.norm.bias, self.num_groups, self.norm.eps,
                       per_frame=self.causal)
        tp = self.tp_group
        if tp is not None:
            h = collectives.copy_to_model(h, tp)
        for i in range(self.n_blocks):
            layer = getattr(self, f"block_{i}")
            if tp is not None and i == 1:  # the row partner of the split block_0
                h = collectives.reduce_from_model(self._layer(layer, h, bias=False), tp)
                if layer.bias is not None:
                    h = h + layer.bias
            else:
                h = self._layer(layer, h)
            if tp is not None and i == 0 and self.n_blocks == 1:
                h = collectives.gather_from_model(h, tp)
            if i < self.n_blocks - 1 or self.last_act:
                h = ACTIVATIONS["gelu"](h)
        return h
