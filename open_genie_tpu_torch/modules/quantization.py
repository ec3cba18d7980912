"""Lookup-free quantization module (twin of `open_genie_tpu.modules.quantization`)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.ops.lfq import codebook_entries, lfq_loss, lfq_quantize
from open_genie_tpu_torch.utils import default


class LookupFreeQuantization(nn.Module):
    """Sign quantization to `{-1, +1}^d` per codebook with MSB-first
    integer indices, and in training the straight-through code and the LFQ
    loss.

    With `num_codebook` c, the features split into c codebooks of
    `codebook_dim` d each. Where `input_dim` differs from `d * c`, Linear
    projections `proj_inp` (input_dim -> d c) and `proj_out` (d c ->
    input_dim), with a bias if `use_bias`, map into and out of the code
    space; the decoder always sees `input_dim` wide latents.
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
        d, c = codebook_dim, num_codebook
        self.codebook_dim, self.num_codebook = d, c
        self.input_dim = default(input_dim, d * c)
        self.project = self.input_dim != d * c
        if self.project:
            self.proj_inp = nn.Linear(self.input_dim, d * c, bias=use_bias)
            self.proj_out = nn.Linear(d * c, self.input_dim, bias=use_bias)
        self.loss_kw = dict(
            commit_weight=commit_weight, entropy_weight=entropy_weight,
            diversity_weight=diversity_weight, frac_sample=frac_sample,
            bit_balance_weight=bit_balance_weight,
        )

    @property
    def codebook_size(self) -> int:
        return 2 ** self.codebook_dim * self.num_codebook

    def codebook(self) -> torch.Tensor:
        """`(codebook_size, codebook_dim)` float32 sign codewords. With
        several codebooks the indices run past `2^d` and, as in the JAX
        package, only their low d bits are read, so the rows repeat."""
        return codebook_entries(torch.arange(self.codebook_size), self.codebook_dim)

    def decode_entries(self, idxs: torch.Tensor) -> torch.Tensor:
        """Integer indices (`(...)`, or `(..., c)` with several codebooks) ->
        the decoder-facing latents: their codewords, concatenated over the
        codebooks and mapped through `proj_out` where there is one
        (float32 codewords without it)."""
        ent = codebook_entries(idxs, self.codebook_dim)
        if self.num_codebook > 1:  # (..., c, d) -> (..., c d)
            ent = ent.flatten(-2)
        if self.project:
            ent = self.proj_out(ent.to(self.proj_out.weight.dtype))
        return ent

    def forward(
        self,
        x: torch.Tensor,
        beta: float = 100.0,
        training: bool = False,
        entropy_scale=1.0,
        bit_balance_scale=1.0,
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        """Quantize `(..., input_dim)` features -> `((out, idxs), loss, aux)`.

        `out` is `(..., input_dim)`; `idxs` is `(..., c)`, squeezed to
        `(...)` with one codebook. Outside training `loss` is None and
        `aux` empty; in training the codes carry the straight-through
        gradient and `loss` is the LFQ loss of the `(..., c, d)` projected
        features against the `where(x > 0, 1, -1)` commitment target, its
        entropy objective scaled by `entropy_scale` and its bit balance by
        `bit_balance_scale` (see `ops.lfq.lfq_loss`).
        """
        d, c = self.codebook_dim, self.num_codebook
        lead = x.shape[:-1]
        if self.project:
            x = self.proj_inp(x)
        x = x.reshape(*lead, c, d)
        code, idxs = lfq_quantize(x, d, training=training)
        out = code.reshape(*lead, c * d)
        if self.project:
            out = self.proj_out(out)
        if c == 1:
            idxs = idxs.squeeze(-1)
        if not training:
            return (out, idxs), None, {}
        quant = torch.where(x > 0, 1.0, -1.0).to(x.dtype)
        loss, aux = lfq_loss(x, quant, beta=beta, num_codebooks=c, entropy_scale=entropy_scale,
                             bit_balance_scale=bit_balance_scale, **self.loss_kw)
        return (out, idxs), loss, aux
