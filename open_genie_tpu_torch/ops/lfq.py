"""Lookup-free quantization, eval part (twin of `open_genie_tpu.ops.lfq`).

Bit i of a code index is 1 iff feature i is `> 0`, most significant bit
first. The training losses (entropy terms, kernels K5/K6) are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bit_mask(codebook_dim: int, device=None) -> torch.Tensor:
    """`(d,)` int32 powers of two, MSB-first: `[2^(d-1), ..., 2, 1]`."""
    return 2 ** torch.arange(
        codebook_dim - 1, -1, -1, dtype=torch.int32, device=device
    )


def codebook_entries(idxs: torch.Tensor, codebook_dim: int) -> torch.Tensor:
    """Map integer code indices to their float32 `{-1, +1}^d` codewords."""
    bits = (idxs[..., None] & bit_mask(codebook_dim, idxs.device)) != 0
    return 2.0 * bits.float() - 1.0


def pack_bits(pos: torch.Tensor) -> torch.Tensor:
    """`(..., d)` bool -> `(...)` int32 index, first feature most significant."""
    mask = bit_mask(pos.shape[-1], pos.device)
    return (pos.to(torch.int32) * mask).sum(-1, dtype=torch.int32)


def lfq_quantize(
    x: torch.Tensor, codebook_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval sign quantization of `(..., d)` features: `(code, indices)`.

    `x > 0` decides, never `sign`: `sign(0) = 0` would emit a codeword
    outside `{-1, +1}^d` and disagree with the bit convention of the index.
    """
    assert x.shape[-1] == codebook_dim, (x.shape, codebook_dim)
    pos = x > 0
    quant = torch.where(pos, 1.0, -1.0).to(x.dtype)
    return quant, pack_bits(pos)
