"""VideoTokenizer (twin of `open_genie_tpu.models.tokenizer`).

Encode -> LFQ -> decode, with the LFQ training loss in training mode
(`forward(..., train=True)`); the rest of the tokenizer's training
objective is `train.losses.TokenizerTrainModule`. A Genie training step
uses the tokenizer frozen (`tokenize_frozen`).

Layout `(B, T, H, W, C)` channels-last. Inputs are cast to the model's
parameter dtype (JAX promotes mixed dtypes; torch refuses them). Layers
marked `has_ext` take a condition: in the decoder, the quantized latents
(the MAGVIT2 decoder's adaptive GroupNorms). With `remat` (the default, as
in the JAX package) every layer recomputes its activations in the backward.

Streaming decode (`decode_stream`): a decoder that `stream_decodable()`
passes is strictly time-causal with finite state, so it decodes one token
frame at a time against per-layer states (`init_stream_cache`) and gives
exactly the batch `decode_tokens` output, in O(1) work per frame.
"""
from __future__ import annotations

from math import prod
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.modules import blueprint_layers, parse_blueprint
from open_genie_tpu_torch.modules.attention import SpaceTimeAttention, st_attn_cache
from open_genie_tpu_torch.modules.quantization import LookupFreeQuantization
from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head
from open_genie_tpu_torch.utils import cast_tuple, default, last_out_channels, module_dtype


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

    def __init__(
        self,
        enc_desc: Any,
        dec_desc: Any,
        d_codebook: int = 18,
        n_codebook: int = 1,
        lfq_bias: bool = True,
        lfq_frac_sample: float = 1.0,
        lfq_commit_weight: float = 0.25,
        lfq_entropy_weight: float = 0.1,
        lfq_diversity_weight: float = 1.0,
        lfq_bit_balance_weight: float = 0.0,
        remat: bool = True,
    ):
        super().__init__()
        self.enc_desc, self.dec_desc = enc_desc, dec_desc
        self.d_codebook, self.n_codebook = d_codebook, n_codebook
        last_enc = last_out_channels(enc_desc)
        first_dec = _first_in_channels(dec_desc)
        assert last_enc == first_dec, (
            f"Inconsistent encoder/decoder dimensions: {last_enc} vs {first_dec}"
        )
        # The video's channels are not known at build; the decoder takes
        # the encoder's width back from the quantizer.
        self.enc_layers, self.enc_ext = parse_blueprint(enc_desc, remat=remat)
        self.dec_width = last_enc
        self.dec_layers, self.dec_ext = parse_blueprint(dec_desc, remat=remat, width=last_enc)
        self.quant = LookupFreeQuantization(
            d_codebook, n_codebook, input_dim=last_enc, use_bias=lfq_bias,
            frac_sample=lfq_frac_sample, commit_weight=lfq_commit_weight,
            entropy_weight=lfq_entropy_weight, diversity_weight=lfq_diversity_weight,
            bit_balance_weight=lfq_bit_balance_weight,
        )

    @staticmethod
    def _run(layers, ext, x: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
        for layer, has_ext in zip(layers, ext):
            x = layer(x, cond) if has_ext else layer(x)
        return x

    def encode(self, video: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._run(self.enc_layers, self.enc_ext, video.to(module_dtype(self)), cond)

    def decode(self, quant: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the decoder; `cond` defaults to the quantized latents."""
        cond = default(cond, quant)
        return self._run(self.dec_layers, self.dec_ext, quant.to(module_dtype(self)), cond)

    def forward(
        self,
        video: torch.Tensor,
        beta: float = 100.0,
        train: bool = False,
        entropy_scale=1.0,
        bit_balance_scale=1.0,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encode -> quantize -> decode: `(rec_video, out)` with `out`
        holding `quant`, `idxs`, `quant_loss` (None outside `train`) and the
        LFQ aux terms `lfq_aux`."""
        enc = self.encode(video)
        (quant, idxs), quant_loss, aux = self.quant(
            enc, beta=beta, training=train, entropy_scale=entropy_scale,
            bit_balance_scale=bit_balance_scale,
        )
        rec = self.decode(quant)
        return rec, {"quant": quant, "idxs": idxs, "quant_loss": quant_loss, "lfq_aux": aux}

    def quantize(self, enc_video: torch.Tensor, beta: float = 100.0, training: bool = False):
        """LFQ of encoder features: `((quant, idxs), quant_loss, aux)`."""
        return self.quant(enc_video, beta=beta, training=training)

    @property
    def temporal_downsampling(self) -> int:
        """Input frames consumed per token frame: the shortest prompt that
        tokenizes to one token frame."""
        factor = prod(getattr(layer, "t_factor", 1.0) for layer in self.enc_layers)
        return max(1, int(round(1.0 / factor)))

    def head_fusable(self) -> bool:
        """The encoder ends in a 1x1x1 stride-1 `causal-conv3d` projecting
        straight to the width of one codebook (so no LFQ projection): then
        the head conv and the LFQ sign and index fuse into kernel K2. With
        an LFQ projection or several codebooks the head is not fusable and
        tokenizing takes the unfused path."""
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
        x = self._run(self.enc_layers[:-1], self.enc_ext[:-1], video.to(module_dtype(self)), None)
        head = self.enc_layers[-1].conv3d
        d, c = head.weight.shape[:2]
        w = head.weight.reshape(d, c).t()
        b = head.bias if head.bias is not None else w.new_zeros(d)
        lead = x.shape[:-1]
        codes, idxs = lfq_head(x.reshape(-1, c).contiguous(), w, b)
        return codes.reshape(*lead, d), idxs.reshape(lead)

    @torch.inference_mode()
    def decode_tokens(self, idxs: torch.Tensor) -> torch.Tensor:
        """Integer token grid `(B, T, H, W)` (`(B, T, H, W, c)` with several
        codebooks) -> video, via the LFQ codebook and its output
        projection."""
        return self.decode(self.quant.decode_entries(idxs))

    # ------------------------------------------------------------------ #
    # Streaming decode: one token frame at a time, for serving.
    # ------------------------------------------------------------------ #

    def stream_decodable(self) -> bool:
        """Whether the decoder streams exactly (`decode_stream`): every
        layer is strictly time-causal with finite state.

          * `causal-conv3d` with time stride 1 and constant padding;
          * `video-residual` with `use_causal`, no downsample and frame-local
            norms (`per_frame_norm` or `use_norm=False`);
          * `space-time_attn` with a single-conv FFN, before any time
            upsample (its KV decode takes one position a step);
          * `depth2spacetime_upsample` (and the JAX package's
            `depth2time_upsample` and `depth2space_upsample`, which the
            port does not build yet);
          * `group_norm` / `adaptive_group_norm` with `per_frame`; only a
            per-frame adaptive norm may take the condition (`has_ext`);
          * parameter-free activations.
        The stock MAGVIT2 decoder (time-pooled GroupNorm) does not stream;
        `magvit2_stream` does."""
        for d in self.dec_desc:
            if isinstance(d, str) or not d[1].get("has_ext"):
                continue
            if not (d[0] == "adaptive_group_norm" and d[1].get("per_frame")):
                return False
        frames_per_step = 1
        for name, kw, _ in blueprint_layers(self.dec_desc, self.dec_width):
            if name == "causal-conv3d":
                if cast_tuple(kw.get("stride", 1), 3)[0] != 1 or kw.get(
                    "pad_mode", "constant"
                ) not in ("constant", "zeros"):
                    return False
            elif name == "video-residual":
                if not kw.get("use_causal") or kw.get("downsample") is not None:
                    return False
                if kw.get("use_norm", True) and not kw.get("per_frame_norm"):
                    return False
                if kw.get("pad_mode", "constant") not in ("constant", "zeros"):
                    return False
            elif name == "space-time_attn":
                if kw.get("hid_dim") is not None or frames_per_step != 1:
                    return False
            elif name == "depth2spacetime_upsample":
                frames_per_step *= int(kw.get("time_factor", 2))
            elif name == "depth2time_upsample":
                frames_per_step *= int(kw.get("factor", 2))
            elif name in ("group_norm", "adaptive_group_norm"):
                if not kw.get("per_frame"):
                    return False
            elif name not in ("depth2space_upsample", "silu", "gelu", "relu", "leaky_relu"):
                return False
        return True

    def stream_dtype(self) -> torch.dtype:
        """Dtype of the streaming states: the tokenizer's own parameters'
        (not the dynamics trunk's, which may differ in a mixed-precision
        checkpoint)."""
        return next(
            (p.dtype for p in self.parameters() if p.dtype.is_floating_point), torch.float32
        )

    def init_stream_cache(self, batch: int, h: int, w: int, t_max: int, device=None) -> list:
        """Zeroed per-layer streaming states for a `t_max`-token-frame
        session at token grid `(h, w)`, in `stream_dtype()`, on `device`
        (default: the tokenizer's): a conv layer's `(B, time_pad, H, W,
        C_in)` input window, a residual block's `{conv1, conv2}` windows, a
        `space-time_attn`'s `{k, v, ffn, fh}` decode cache, `None` for a
        stateless layer."""
        assert self.stream_decodable(), (
            "decoder blueprint is not streamable (see stream_decodable)"
        )
        dtype = self.stream_dtype()
        device = device or next(self.parameters()).device
        zeros = lambda t, hh, ww, c: torch.zeros(  # noqa: E731
            batch, t, hh, ww, c, dtype=dtype, device=device)
        caches = []
        for (name, kw, _), layer in zip(blueprint_layers(self.dec_desc, self.dec_width),
                                        self.dec_layers):
            if name == "causal-conv3d":
                caches.append(zeros(layer.stream_state_len(), h, w, kw["in_channels"]))
            elif name == "video-residual":
                tp = layer.stream_state_len()
                caches.append({
                    "conv1": zeros(tp, h, w, layer.conv1.conv3d.in_channels),
                    "conv2": zeros(tp, h, w, layer.conv2.conv3d.in_channels),
                })
            elif name == "space-time_attn":
                caches.append(st_attn_cache(kw, batch, h, w, t_max, dtype, device))
            elif name == "depth2spacetime_upsample":
                caches.append(zeros(layer.stream_state_len(), h, w, kw["in_channels"]))
                h, w = h * layer.space_factor, w * layer.space_factor
            else:
                caches.append(None)
        return caches

    @torch.inference_mode()
    def decode_stream(self, idxs: torch.Tensor, cache: list, pos: int):
        """Decode ONE token frame `(B, H, W)` (or `(B, 1, H, W)`; with
        several codebooks a trailing axis of c) at token-frame index `pos`
        against the streaming states `cache`, which are updated in place.
        Returns `(pixels, cache)`, `pixels` `(B, time_factor_total, H', W',
        C)`: the batch `decode_tokens` output for that frame's pixel
        frames."""
        if idxs.dim() == 3 + (self.n_codebook > 1):
            idxs = idxs[:, None]
        x = self.quant.decode_entries(idxs).to(module_dtype(self))
        # A per-frame adaptive norm reads only the current token frame's
        # latents, which is all that the stream holds.
        cond = x
        for i, lc in enumerate(cache):
            x = self.stream_layer(i, x, cond, lc, pos)
        return x, cache

    def stream_layer(self, i: int, x: torch.Tensor, cond: torch.Tensor, cache, pos: int):
        """Decoder layer `i`'s streaming step on `x`, one token frame's
        worth of its input (`cond`: that token frame's latents), against
        its state `cache` (updated in place)."""
        layer, has_ext = self.dec_layers[i], self.dec_ext[i]
        if isinstance(layer, SpaceTimeAttention):
            return layer(x, cache=cache, cache_pos=pos)[0]
        if cache is not None:
            return layer(x, cache=cache)[0]
        return layer(x, cond) if has_ext else layer(x)
