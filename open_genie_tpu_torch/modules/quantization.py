"""Lookup-free quantization module (twin of `open_genie_tpu.modules.quantization`)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.ops.lfq import codebook_entries, lfq_loss, lfq_quantize
from open_genie_tpu_torch.utils import default


class LookupFreeQuantization(nn.Module):
    """Sign quantization to `{-1, +1}^d` with MSB-first integer indices,
    and in training the straight-through code and the LFQ loss.

    Only the projection-free, single-codebook configuration is ported
    (input width == `codebook_dim`); it holds no parameters, so `use_bias`
    (the projections' bias) is accepted and unused.
    """

    def __init__(
        self,
        codebook_dim: int,
        num_codebook: int = 1,
        input_dim: Optional[int] = None,
        use_bias: bool = True,
        frac_sample: float = 1.0,
        commit_weight: float = 0.25,
        entropy_weight: float = 0.1,
        diversity_weight: float = 1.0,
        bit_balance_weight: float = 0.0,
    ):
        super().__init__()
        if num_codebook != 1 or default(input_dim, codebook_dim) != codebook_dim:
            raise NotImplementedError(
                "LFQ with several codebooks or an input projection is not "
                "ported yet"
            )
        self.codebook_dim = codebook_dim
        self.loss_kw = dict(
            commit_weight=commit_weight, entropy_weight=entropy_weight,
            diversity_weight=diversity_weight, frac_sample=frac_sample,
            bit_balance_weight=bit_balance_weight,
        )

    def decode_entries(self, idxs: torch.Tensor) -> torch.Tensor:
        """Integer indices -> their float32 `{-1, +1}^d` codewords."""
        return codebook_entries(idxs, self.codebook_dim)

    def forward(
        self,
        x: torch.Tensor,
        beta: float = 100.0,
        training: bool = False,
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        """Quantize `(..., d)` features -> `((codes, idxs), loss, aux)`.

        Outside training `loss` is None and `aux` empty; in training the
        codes carry the straight-through gradient and `loss` is the LFQ loss.
        """
        code, idxs = lfq_quantize(x, self.codebook_dim, training=training)
        if not training:
            return (code, idxs), None, {}
        quant = torch.where(x > 0, 1.0, -1.0).to(x.dtype)
        loss, aux = lfq_loss(x, quant, beta=beta, **self.loss_kw)
        return (code, idxs), loss, aux
