"""Resampling on channels-last video and images (twin of `open_genie_tpu.ops.resample`).

Binomial blur kernels and anti-aliased blur pooling (a depthwise strided
conv, cuDNN on the card, as the JAX package's is an XLA conv), and the
pixel shuffles from depth to space, time and both. A 3-D blur kernel takes
each axis's own binomial row (the JAX package's fix of the reference's
`kernel_size[0]` for every axis).
"""
from __future__ import annotations

import functools
from math import comb
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from open_genie_tpu_torch.utils import cast_tuple


def binomial_kernel_1d(k: int) -> np.ndarray:
    """Row `k - 1` of Pascal's triangle, f32."""
    return np.asarray([comb(k - 1, i) for i in range(k)], dtype=np.float32)


def blur_kernel_2d(kernel_size: int | Tuple[int, int], norm: bool = True) -> torch.Tensor:
    """Separable binomial blur kernel `(kh, kw)`, summing to one with `norm`."""
    kh, kw = cast_tuple(kernel_size, 2)
    ker = np.outer(binomial_kernel_1d(kh), binomial_kernel_1d(kw))
    return torch.from_numpy(ker / ker.sum() if norm else ker)


def blur_kernel_3d(kernel_size: int | Tuple[int, int, int], norm: bool = True) -> torch.Tensor:
    """Separable binomial blur kernel `(kt, kh, kw)`, summing to one with `norm`."""
    kt, kh, kw = cast_tuple(kernel_size, 3)
    ker = np.einsum("t,h,w->thw", binomial_kernel_1d(kt), binomial_kernel_1d(kh),
                    binomial_kernel_1d(kw))
    return torch.from_numpy(ker / ker.sum() if norm else ker)


@functools.lru_cache(maxsize=64)
def _depthwise_blur(k: tuple, c: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The `(C, 1, *k)` depthwise weight of a blur, cast to `dtype` on
    `device` once (a copy per call would sync the host). Made outside
    inference mode, so a training step may save it for its backward."""
    with torch.inference_mode(False):
        ker = blur_kernel_3d(k) if len(k) == 3 else blur_kernel_2d(k)
        return ker.to(device, dtype).expand(c, 1, *k).contiguous()


def blur_pool_3d(
    x: torch.Tensor,
    kernel_size: int | Tuple[int, int, int] = 3,
    time_factor: int = 2,
    space_factor: int | Tuple[int, int] = 2,
) -> torch.Tensor:
    """Anti-aliased strided downsample of `(B, T, H, W, C)` video: each
    channel convolved with the binomial kernel at stride `(time_factor,
    space_factor)`, zero-padded `(k - 1) // 2` on both sides of each axis."""
    c = x.shape[-1]
    sh, sw = cast_tuple(space_factor, 2)
    k = cast_tuple(kernel_size, 3)
    ker = _depthwise_blur(k, c, x.device, x.dtype)
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), ker, stride=(time_factor, sh, sw),
                   padding=tuple((kk - 1) // 2 for kk in k), groups=c)
    return out.permute(0, 2, 3, 4, 1)


def blur_pool_2d(
    x: torch.Tensor,
    kernel_size: int | Tuple[int, int] = 3,
    stride: int | Tuple[int, int] = 2,
) -> torch.Tensor:
    """Anti-aliased strided downsample of `(B, H, W, C)` images. The pad is
    `(k - 1) // stride` per axis, as in the JAX package (not `(k - 1) // 2`)."""
    c = x.shape[-1]
    k = cast_tuple(kernel_size, 2)
    s = cast_tuple(stride, 2)
    ker = _depthwise_blur(k, c, x.device, x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), ker, stride=s,
                   padding=tuple((kk - 1) // ss for kk, ss in zip(k, s)), groups=c)
    return out.permute(0, 2, 3, 1)


def depth_to_space(x: torch.Tensor, factor: int) -> torch.Tensor:
    """`(B, T, H, W, C * f * f)` -> `(B, T, f*H, f*W, C)` per-frame shuffle,
    channel order `(c p q)`: the leading channel blocks carry the output
    channels."""
    b, t, h, w, cpq = x.shape
    c = cpq // (factor * factor)
    x = x.reshape(b, t, h, w, c, factor, factor)
    # (b t h w c p q) -> (b t h p w q c)
    return x.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, t, h * factor, w * factor, c)


def depth_to_time(x: torch.Tensor, factor: int) -> torch.Tensor:
    """`(B, T, H, W, C * f)` -> `(B, f*T, H, W, C)`, channel order `(c f)`."""
    b, t, h, w, cf = x.shape
    c = cf // factor
    x = x.reshape(b, t, h, w, c, factor)
    # (b t h w c f) -> (b t f h w c)
    return x.permute(0, 1, 5, 2, 3, 4).reshape(b, t * factor, h, w, c)


def depth_to_spacetime(
    x: torch.Tensor, time_factor: int, space_factor: int
) -> torch.Tensor:
    """`(B, T, H, W, C * p * q * r)` -> `(B, p*T, q*H, r*W, C)` joint shuffle.

    Channel order is the reference decoder's `(c p q r)`: the leading
    channel blocks carry the output channels.
    """
    p, q, r = time_factor, space_factor, space_factor
    b, t, h, w, cpqr = x.shape
    c = cpqr // (p * q * r)
    x = x.reshape(b, t, h, w, c, p, q, r)
    # (b t h w c p q r) -> (b t p h q w r c)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * p, h * q, w * r, c)


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Inverse pixel shuffle on `(B, H, W, C)` images -> `(B, H/f, W/f,
    C * f * f)`, channel order `(c p q)` as `b c (h p) (w q) -> b (c p q) h w`."""
    b, h, w, c = x.shape
    p = q = factor
    x = x.reshape(b, h // p, p, w // q, q, c)
    # (b h p w q c) -> (b h w c p q)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, h // p, w // q, c * p * q)
