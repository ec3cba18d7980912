"""Lookup-free quantization module, eval part (twin of `open_genie_tpu.modules.quantization`)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.ops.lfq import codebook_entries, lfq_quantize
from open_genie_tpu_torch.utils import default


class LookupFreeQuantization(nn.Module):
    """Sign quantization to `{-1, +1}^d` with MSB-first integer indices.

    Only the projection-free, single-codebook configuration is ported
    (encoder width == `codebook_dim`); it holds no parameters.
    """

    def __init__(self, codebook_dim: int, num_codebook: int = 1,
                 input_dim: Optional[int] = None):
        super().__init__()
        if num_codebook != 1 or default(input_dim, codebook_dim) != codebook_dim:
            raise NotImplementedError(
                "LFQ with several codebooks or an input projection is not "
                "ported yet"
            )
        self.codebook_dim = codebook_dim

    def decode_entries(self, idxs: torch.Tensor) -> torch.Tensor:
        """Integer indices -> their float32 `{-1, +1}^d` codewords."""
        return codebook_entries(idxs, self.codebook_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval quantization of `(..., d)` features -> `(codes, idxs)`."""
        return lfq_quantize(x, self.codebook_dim)
