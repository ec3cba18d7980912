"""Rotary position embeddings (twin of `open_genie_tpu.ops.rope`)."""
from __future__ import annotations

from math import pi

import numpy as np
import torch


def rope_frequencies(
    dim: int,
    kind: str = "1d",
    theta: float = 10000.0,
    max_freq: float = 10.0,
    num_freq: int = 1,
    theta_rescale_factor: float = 1.0,
) -> np.ndarray:
    """The `(dim // 2,)` float32 frequency ladder of a given kind.

    '1d' is the classic inverse-frequency ladder (temporal attention);
    '2d' is `linspace(1, max_freq / 2, dim // 2) * pi`, applied over the
    flattened `h * w` position (spatial attention); 'const' is all ones.
    """
    theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    if kind == "1d":
        freq = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    elif kind == "2d":
        freq = np.linspace(1.0, max_freq / 2, dim // 2) * pi
    elif kind == "const":
        freq = np.ones(num_freq)
    else:
        raise ValueError(f"Unknown RoPE kind: {kind}")
    return np.asarray(freq, dtype=np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation `(x1, x2) -> (-x2, x1)` on interleaved pairs."""
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def apply_rope(
    seq: torch.Tensor,
    freq: torch.Tensor,
    offset: int = 0,
    interpolate_factor: float = 1.0,
) -> torch.Tensor:
    """Rotate a `(..., N, D)` sequence by position-dependent phases.

    `freq` is a float32 `(D // 2,)` tensor on `seq`'s device; positions
    run along the second-to-last axis, starting at `offset` (the decode
    position). Phases repeat pairwise (`f0 f0 f1 f1 ...`) over interleaved
    feature pairs, and cos/sin are cast to the sequence dtype before the
    rotation, as in the JAX package.
    """
    n = seq.shape[-2]
    pos = (
        torch.arange(n, dtype=torch.float32, device=seq.device) + offset
    ) / interpolate_factor
    phase = (pos[:, None] * freq[None, :]).repeat_interleave(2, dim=-1)

    rot_dim = phase.shape[-1]
    mid, right = seq[..., :rot_dim], seq[..., rot_dim:]
    cos = torch.cos(phase).to(seq.dtype)
    sin = torch.sin(phase).to(seq.dtype)
    mid = mid * cos + _rotate_half(mid) * sin
    return torch.cat((mid, right), dim=-1) if right.numel() else mid
