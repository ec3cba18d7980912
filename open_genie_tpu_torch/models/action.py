"""LatentAction VQ-VAE (twin of `open_genie_tpu.models.action`).

A space-time attention encoder over video, a per-frame projection to a
`d_codebook`-wide action code, LFQ, and a decoder that reconstructs the
video with the quantized actions cross-attended into its temporal
attention only (`cond=(None, q_act)`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.modules import (
    blueprint_out_width,
    blueprint_st_factor,
    blueprint_time_factor,
    parse_blueprint,
)
from open_genie_tpu_torch.modules.attention import SpaceTimeAttention
from open_genie_tpu_torch.modules.quantization import LookupFreeQuantization
from open_genie_tpu_torch.modules.video import CausalConv3d
from open_genie_tpu_torch.ops.lfq import codebook_entries
from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.utils import cast_tuple


class LatentAction(nn.Module):
    """Construct with the JAX `LatentAction`'s fields. `inp_shape` fixes
    the frame size, since `to_act` flattens each encoded frame.

    `remat` (default True, as in the JAX package) recomputes each encoder
    and decoder layer in the backward instead of keeping its activations.
    """

    def __init__(
        self,
        enc_desc: Any,
        dec_desc: Any,
        d_codebook: int = 8,
        inp_channels: int = 3,
        inp_shape: Tuple[int, int] = (64, 64),
        ker_size: int = 3,
        n_embd: int = 256,
        n_codebook: int = 1,
        lfq_bias: bool = True,
        lfq_frac_sample: float = 1.0,
        lfq_commit_weight: float = 0.25,
        lfq_entropy_weight: float = 0.1,
        lfq_diversity_weight: float = 1.0,
        lfq_bit_balance_weight: float = 0.0,
        quant_loss_weight: float = 1.0,
        remat: bool = True,
    ):
        super().__init__()
        # Widths: n_embd enters the encoder, whose output enters the decoder.
        enc_width = blueprint_out_width(enc_desc, n_embd)
        dec_width = blueprint_out_width(dec_desc, enc_width)
        enc_fact = blueprint_st_factor(enc_desc)
        dec_fact = blueprint_st_factor(dec_desc)
        assert abs(enc_fact * dec_fact - 1.0) < 1e-6, (
            "The product of the space-time up/down factors must be 1, got "
            f"{enc_fact} * {dec_fact}"
        )
        self.d_codebook = d_codebook
        self.quant_loss_weight = quant_loss_weight
        self.proj_in = CausalConv3d(inp_channels, n_embd, kernel_size=ker_size)
        self.proj_out = CausalConv3d(dec_width, inp_channels, kernel_size=ker_size)
        self.enc_layers, self.enc_ext = parse_blueprint(enc_desc, remat=remat, width=n_embd)
        self.dec_layers, self.dec_ext = parse_blueprint(dec_desc, remat=remat, width=enc_width)

        # Per-frame flattened (h', w', c) -> d_codebook. Frames keep their
        # time axis through the encoder's space factor, so h' w' = h w *
        # st_factor / t_factor.
        h, w = cast_tuple(inp_shape, 2)
        area = int(round(h * w * enc_fact / blueprint_time_factor(enc_desc)))
        self.to_act = nn.Linear(area * enc_width, d_codebook, bias=False)
        self.quant = LookupFreeQuantization(
            d_codebook, n_codebook, use_bias=lfq_bias,
            frac_sample=lfq_frac_sample, commit_weight=lfq_commit_weight,
            entropy_weight=lfq_entropy_weight,
            diversity_weight=lfq_diversity_weight,
            bit_balance_weight=lfq_bit_balance_weight,
        )

    def sample(self, idxs: torch.Tensor) -> torch.Tensor:
        """Action ids -> their float32 `{-1, +1}^d` codewords (how a user's
        action ids become action codes at inference)."""
        return codebook_entries(idxs, self.d_codebook)

    def encode(self, video: torch.Tensor, mask: Optional[torch.Tensor] = None, group=None):
        """Video `(B, T, H, W, C)` -> `((q_act, idxs, enc_video), q_loss,
        q_aux)`: the `(B, T, d)` quantized action code, the `(B, T)` action
        ids and the encoder features that `decode` takes. In training the
        code carries the straight-through gradient and `q_loss` is the LFQ
        loss (over the global batch of a data-parallel `group`); outside
        training `q_loss` is None.

        `mask` (bool, True = attend), where given, reaches every attention
        of the encoder's space-time blocks, spatial and temporal alike, as
        in the JAX package: it must broadcast to both `(B T, heads, H' W',
        H' W')` and `(B H' W', heads, T, T)`."""
        x = self.proj_in(video)
        for layer in self.enc_layers:
            x = layer(x, mask=mask) if mask is not None and isinstance(
                layer, SpaceTimeAttention) else layer(x)
        b, t = x.shape[:2]
        act = self.to_act(x.reshape(b, t, -1))
        (q_act, idxs), q_loss, q_aux = self.quant(act, training=self.training, group=group)
        return (q_act, idxs, x), q_loss, q_aux

    def decode(self, enc_video: torch.Tensor, q_act: torch.Tensor) -> torch.Tensor:
        """Reconstruct the video; the actions condition only the temporal
        attention of the `has_ext` layers, as cross-attention keys/values."""
        x = enc_video
        for layer, has_ext in zip(self.dec_layers, self.dec_ext):
            x = layer(x, (None, q_act)) if has_ext else layer(x)
        return self.proj_out(x)

    def forward(self, video: torch.Tensor, mask: Optional[torch.Tensor] = None, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """Full VQ-VAE pass -> `(idxs, loss, aux)`: reconstruction MSE plus
        the weighted LFQ loss, over the global batch of a data-parallel
        `group`. `mask` goes to the encoder (`encode`)."""
        (q_act, idxs, enc_video), q_loss, q_aux = self.encode(video, mask, group)
        recon = self.decode(enc_video, q_act)
        rec_loss = collectives.mean((recon - video) ** 2, group)
        loss = rec_loss
        if q_loss is not None:
            loss = loss + q_loss * self.quant_loss_weight
        aux: Dict[str, Any] = {
            "rec_loss": rec_loss,
            "q_loss": q_loss if q_loss is not None else 0.0,
            **{f"lfq_{k}": v for k, v in q_aux.items()},
        }
        return idxs, loss, aux
