"""Causal 3-D convolution on channels-last video (twin of `open_genie_tpu.ops.conv`).

The JAX package runs these on XLA's stock convolution; here they run on
`F.conv3d` (cuDNN on the card). Tensors stay `(B, T, H, W, C)` at the
interface and are permuted to PyTorch's `(B, C, T, H, W)` inside.
Kernels are PyTorch's `(O, I, kt, kh, kw)`, a transposed conv's `(I, O,
kt, kh, kw)`.

Pad modes take numpy's names, as the JAX package passes them to
`jnp.pad`: `constant` (or `zeros`), `edge` (or `replicate`), `reflect`,
`wrap` and `symmetric`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
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


CONSTANT_PAD_MODES = ("constant", "zeros")
# numpy's pad modes that map output positions onto input positions.
_INDEX_PAD_MODES = {"edge": "edge", "replicate": "edge", "reflect": "reflect",
                    "wrap": "wrap", "symmetric": "symmetric"}


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, lo: int, hi: int, mode: str, device: torch.device) -> torch.Tensor:
    """numpy's own index map of `mode` over an axis of `n` (so pads wider
    than the axis, which F.pad refuses, fold as numpy folds them), on
    `device` once."""
    with torch.inference_mode(False):
        return torch.from_numpy(np.pad(np.arange(n), (lo, hi), mode=mode)).to(device)


def pad_video_cf(x: torch.Tensor, pads: Tuple[Tuple[int, int], ...], mode: str) -> torch.Tensor:
    """Pad the last three axes of a channels-first `(B, C, T, H, W)` tensor
    by `pads` (`(before, after)` per axis, T first) in numpy's non-constant
    `mode`, as `jnp.pad` does; a mode the port does not take raises
    `ValueError`."""
    if mode not in _INDEX_PAD_MODES:
        raise ValueError(
            f"pad_mode {mode!r}: the port pads with {CONSTANT_PAD_MODES + tuple(_INDEX_PAD_MODES)}")
    for axis, (lo, hi) in enumerate(pads, start=2):
        if lo or hi:
            x = x.index_select(axis, _pad_index(x.shape[axis], lo, hi,
                                                _INDEX_PAD_MODES[mode], x.device))
    return x


def causal_conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int | Tuple[int, int, int] = 1,
    dilation: int | Tuple[int, int, int] = 1,
    space_padding: Optional[Tuple[int, int]] = None,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Causal 3-D convolution over a `(B, T, H, W, C)` video.

    Time is padded on the left only by `causal_time_pad`, space
    symmetrically by `(k - 1) // 2` per axis (or `space_padding`), both in
    `pad_mode` (zeros by default); the conv then runs VALID.
    """
    st, _, _ = cast_tuple(stride, 3)
    dt, _, _ = cast_tuple(dilation, 3)
    kt, kh, kw = weight.shape[2:]
    tp = causal_time_pad(kt, st, dt)
    hp, wp = default(space_padding, ((kh - 1) // 2, (kw - 1) // 2))
    if pad_mode in CONSTANT_PAD_MODES:
        # Time only; the conv pads space itself. F.pad lists the last axis
        # first: (C, W, H, T) pairs for channels-last.
        x, padding = F.pad(x, (0, 0, 0, 0, 0, 0, tp, 0)), (0, hp, wp)
    else:
        x = pad_video_cf(x.permute(0, 4, 1, 2, 3), ((tp, 0), (hp, hp), (wp, wp)), pad_mode)
        x, padding = x.permute(0, 2, 3, 4, 1), 0
    return conv3d_cl(x, weight, bias, stride=cast_tuple(stride, 3),
                     dilation=cast_tuple(dilation, 3), padding=padding)


def causal_conv_transpose3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int | Tuple[int, int, int] = 1,
    space_padding: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Causal transposed 3-D convolution over a `(B, T, H, W, C)` video,
    `weight` `(C_in, C_out, kt, kh, kw)`: the full (VALID) transposed conv,
    trimmed to `(T * st, H * sh, W * sw)` by keeping the leading frames (so
    an output frame sees no later input frame) and dropping
    `space_padding` (default `k // 2` per axis) from the start of each
    spatial axis."""
    st, sh, sw = cast_tuple(stride, 3)
    kh, kw = weight.shape[3:]
    hp, wp = default(space_padding, (kh // 2, kw // 2))
    _, t, h, w, _ = x.shape
    out = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), weight, stride=(st, sh, sw))
    out = out[:, :, : t * st, hp: hp + h * sh, wp: wp + w * sw].permute(0, 2, 3, 4, 1)
    return out if bias is None else out + bias


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
