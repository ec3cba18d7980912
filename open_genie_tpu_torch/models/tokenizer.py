"""VideoTokenizer, inference part (twin of `open_genie_tpu.models.tokenizer`).

Training the tokenizer is not ported yet; a Genie training step uses it
frozen (`tokenize_frozen`).

Layout `(B, T, H, W, C)` channels-last. Inputs are cast to the model's
parameter dtype (JAX promotes mixed dtypes; torch refuses them).
"""
from __future__ import annotations

from math import prod
from typing import Any, Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.modules import parse_blueprint
from open_genie_tpu_torch.modules.quantization import LookupFreeQuantization
from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
from open_genie_tpu_torch.utils import cast_tuple, last_out_channels, module_dtype


def _first_in_channels(blueprint) -> Optional[int]:
    for desc in blueprint:
        if isinstance(desc, str):
            continue
        for key in ("in_channels", "n_embd", "d_inp"):
            if desc[1].get(key) is not None:
                return desc[1][key]
    return None


class VideoTokenizer(nn.Module):
    """Blueprint-assembled video tokenizer with lookup-free quantization."""

    def __init__(self, enc_desc: Any, dec_desc: Any, d_codebook: int = 18,
                 n_codebook: int = 1):
        super().__init__()
        self.enc_desc, self.dec_desc = enc_desc, dec_desc
        self.d_codebook, self.n_codebook = d_codebook, n_codebook
        self.enc_layers, enc_ext = parse_blueprint(enc_desc)
        self.dec_layers, dec_ext = parse_blueprint(dec_desc)
        if any(enc_ext) or any(dec_ext):
            raise NotImplementedError(
                "externally conditioned tokenizer layers (has_ext) are not "
                "ported yet"
            )
        last_enc = last_out_channels(enc_desc)
        first_dec = _first_in_channels(dec_desc)
        assert last_enc == first_dec, (
            f"Inconsistent encoder/decoder dimensions: {last_enc} vs {first_dec}"
        )
        self.quant = LookupFreeQuantization(d_codebook, n_codebook, input_dim=last_enc)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        x = video.to(module_dtype(self))
        for layer in self.enc_layers:
            x = layer(x)
        return x

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        x = quant.to(module_dtype(self))
        for layer in self.dec_layers:
            x = layer(x)
        return x

    @property
    def temporal_downsampling(self) -> int:
        """Input frames consumed per token frame: the shortest prompt that
        tokenizes to one token frame."""
        factor = prod(getattr(layer, "t_factor", 1.0) for layer in self.enc_layers)
        return max(1, int(round(1.0 / factor)))

    def head_fusable(self) -> bool:
        """The encoder ends in a 1x1x1 stride-1 `causal-conv3d` projecting
        straight to the codebook width (no LFQ projection): then the head
        conv and the LFQ sign and index fuse into kernel K2."""
        if self.n_codebook != 1 or not self.enc_desc:
            return False
        last = self.enc_desc[-1]
        if isinstance(last, str):
            return False
        name, kw = last
        if name != "causal-conv3d" or int(kw.get("n_rep", 1)) != 1:
            return False
        if cast_tuple(kw.get("kernel_size", 3), 3) != (1, 1, 1):
            return False
        if cast_tuple(kw.get("stride", 1), 3) != (1, 1, 1):
            return False
        return kw.get("out_channels") == self.d_codebook

    @torch.inference_mode()
    def tokenize(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Video -> `(quantized latents, int32 token grid)`, eval mode.

        With a fusable head, the head conv + LFQ run as kernel K2 (its
        plain twin on a CPU tensor)."""
        return self._tokenize(video)

    @torch.no_grad()
    def tokenize_frozen(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """`tokenize` for a training step with this tokenizer frozen: no
        graph either, but ordinary tensors that a later layer may save for
        its backward (inference-mode tensors may not be)."""
        return self._tokenize(video)

    def _tokenize(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.head_fusable():
            return self.quant(self.encode(video))[0]
        x = video.to(module_dtype(self))
        for layer in self.enc_layers[:-1]:
            x = layer(x)
        head = self.enc_layers[-1].conv3d
        d, c = head.weight.shape[:2]
        w = head.weight.reshape(d, c).t()
        b = head.bias if head.bias is not None else w.new_zeros(d)
        lead = x.shape[:-1]
        codes, idxs = lfq_head(x.reshape(-1, c).contiguous(), w, b)
        return codes.reshape(*lead, d), idxs.reshape(lead)

    @torch.inference_mode()
    def decode_tokens(self, idxs: torch.Tensor) -> torch.Tensor:
        """Integer token grid -> video, via the LFQ codebook."""
        return self.decode(self.quant.decode_entries(idxs))
