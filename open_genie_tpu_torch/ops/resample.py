"""Pixel-shuffle resampling on channels-last video (twin of `open_genie_tpu.ops.resample`)."""
from __future__ import annotations

import torch


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
