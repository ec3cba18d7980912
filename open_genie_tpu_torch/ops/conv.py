"""Causal 3-D convolution on channels-last video (twin of `open_genie_tpu.ops.conv`).

The JAX package runs these on XLA's stock convolution; here they run on
`F.conv3d` (cuDNN on the card). Tensors stay `(B, T, H, W, C)` at the
interface and are permuted to PyTorch's `(B, C, T, H, W)` inside.
Kernels are PyTorch's `(O, I, kt, kh, kw)`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from open_genie_tpu_torch.utils import cast_tuple, default


def causal_time_pad(kernel_t: int, stride_t: int = 1, dilation_t: int = 1) -> int:
    """Left-only temporal padding preserving causality:
    `(k_t - 1) * dilation_t + (1 - stride_t)`."""
    return (kernel_t - 1) * dilation_t + (1 - stride_t)


def conv3d_cl(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride=1,
    dilation=1,
    padding=0,
) -> torch.Tensor:
    """`F.conv3d` on a channels-last `(B, T, H, W, C)` tensor."""
    out = F.conv3d(
        x.permute(0, 4, 1, 2, 3), weight, bias,
        stride=stride, padding=padding, dilation=dilation,
    )
    return out.permute(0, 2, 3, 4, 1)


def conv2d_cl(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride=1,
    padding=0,
) -> torch.Tensor:
    """`F.conv2d` on a channels-last `(B, H, W, C)` tensor."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def causal_conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int | Tuple[int, int, int] = 1,
    dilation: int | Tuple[int, int, int] = 1,
    space_padding: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Causal 3-D convolution over a `(B, T, H, W, C)` video.

    Time is zero-padded on the left only by `causal_time_pad`, space
    symmetrically by `(k - 1) // 2` per axis (or `space_padding`).
    """
    st, _, _ = cast_tuple(stride, 3)
    dt, _, _ = cast_tuple(dilation, 3)
    kt, kh, kw = weight.shape[2:]
    tp = causal_time_pad(kt, st, dt)
    hp, wp = default(space_padding, ((kh - 1) // 2, (kw - 1) // 2))
    # F.pad lists the last axis first: (C, W, H, T) pairs for channels-last.
    x = F.pad(x, (0, 0, 0, 0, 0, 0, tp, 0))
    return conv3d_cl(
        x, weight, bias, stride=cast_tuple(stride, 3),
        dilation=cast_tuple(dilation, 3), padding=(0, hp, wp),
    )


def time_valid_conv3d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Conv3d VALID in time, SAME (symmetric) in space -- the windowed form
    of a causal conv, for the cached decode (`weight` may be a time-slice
    of the full kernel)."""
    kh, kw = weight.shape[3:]
    return conv3d_cl(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
        padding=(0, (kh - 1) // 2, (kw - 1) // 2),
    )
