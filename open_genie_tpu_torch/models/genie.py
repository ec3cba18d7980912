"""Genie: action-conditioned world model (twin of `open_genie_tpu.models.genie`).

Training (`compute_loss`): the frozen tokenizer turns the video into a
token grid, the latent-action VQ-VAE turns it into per-frame action ids
and its own loss, and the dynamics model's masked-token cross-entropy on
those tokens and actions is added to it.

Rollout (`forward`): the prompt is tokenized, each new frame is generated
by KV-cached MaskGIT refinement of the dynamics model, and the token video
is decoded to pixels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from open_genie_tpu_torch.models.action import LatentAction
from open_genie_tpu_torch.models.dynamics import (
    DynamicsModel,
    get_schedule,
    maskgit_commit,
)
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer


class Genie(nn.Module):
    """Construct with the JAX package's three nested config dicts:
    `Genie(tokenizer=dict(...), latent_action=dict(...), dynamics=dict(...))`."""

    def __init__(self, tokenizer: Dict[str, Any], latent_action: Dict[str, Any],
                 dynamics: Dict[str, Any]):
        super().__init__()
        self.tokenizer = VideoTokenizer(**tokenizer)
        self.latent_action = LatentAction(**latent_action)
        dyn = dict(dynamics)
        dyn.setdefault("tok_vocab", 2 ** self.tokenizer.d_codebook)
        dyn.setdefault("act_vocab", 2 ** self.latent_action.d_codebook)
        self.dynamics = DynamicsModel(**dyn)

    def compute_loss(
        self,
        video: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Joint latent-action + dynamics loss on `(B, T, H, W, C)` video.

        The tokenizer runs frozen, with no graph. The latent-action model
        trains its LFQ (and applies dropout) when this module is in
        training mode. The dynamics' Bernoulli mask is `mask` or drawn from
        `generator` (see `DynamicsModel.compute_loss`).
        """
        _, tok_idxs = self.tokenizer.tokenize_frozen(video)
        act_idxs, act_loss, act_aux = self.latent_action(video)
        act_idxs = self.align_actions(act_idxs, tok_idxs.shape[1])
        dyn_loss, dyn_aux = self.dynamics.compute_loss(
            tok_idxs, act_idxs, mask=mask, generator=generator
        )
        aux = {
            "act_loss": act_loss,
            "dyn_loss": dyn_loss,
            **{f"act_{k}": v for k, v in act_aux.items()},
            **{f"dyn_{k}": v for k, v in dyn_aux.items()},
        }
        return act_loss + dyn_loss, aux

    @staticmethod
    def align_actions(act_idxs: torch.Tensor, t_tok: int) -> torch.Tensor:
        """Subsample per-input-frame action ids to the token time axis
        (a time-compressing tokenizer yields fewer token frames)."""
        t_act = act_idxs.shape[1]
        if t_act != t_tok:
            act_idxs = act_idxs[:, :: t_act // t_tok][:, :t_tok]
        return act_idxs

    @property
    def act_vocab(self) -> int:
        return self.dynamics.act_emb.num_embeddings

    @torch.inference_mode()
    def tokenize_prompt(self, prompt: torch.Tensor) -> torch.Tensor:
        """Prompt image `(B, H, W, C)` or video `(B, T, H, W, C)` -> token
        grid. Prompts shorter than the tokenizer's temporal downsampling
        are padded at the front by repeating the first frame."""
        if prompt.dim() == 4:
            prompt = prompt[:, None]
        t_down = self.tokenizer.temporal_downsampling
        if prompt.shape[1] < t_down:
            pad = prompt[:, :1].repeat(1, t_down - prompt.shape[1], 1, 1, 1)
            prompt = torch.cat([pad, prompt], dim=1)
        _, idxs = self.tokenizer.tokenize(prompt)
        assert idxs.shape[1] >= 1, (
            f"prompt of {prompt.shape[1]} frame(s) tokenizes to zero token frames"
        )
        return idxs

    def _decode_dtype(self) -> torch.dtype:
        """Decode caches follow the dynamics params' dtype."""
        return self.dynamics.tok_emb.weight.dtype

    @torch.inference_mode()
    def rollout_tokens(
        self,
        tokens: torch.Tensor,
        actions: torch.Tensor,
        num_frames: int,
        steps_per_frame: int = 25,
        temp: float = 1.0,
        which: str = "linear",
        top_k: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """KV-cached autoregressive MaskGIT rollout.

        `tokens` `(B, T0, H, W)` is the prompt's token grid and `actions`
        `(B, >= T0 + num_frames)` the action ids. The prompt frames are
        committed into the caches, then each new frame runs
        `steps_per_frame` read-only refinements and one commit. Returns
        `(B, T0 + num_frames, H, W)` tokens.
        """
        b, t0, h, w = tokens.shape
        schedule = get_schedule(steps_per_frame, (h, w), which)
        cache = self.dynamics.init_cache(
            b, h, w, t0 + num_frames, dtype=self._decode_dtype(),
            device=tokens.device,
        )
        for pos in range(t0):
            _, cache = self.dynamics.decode_frame(
                tokens[:, pos], actions[:, pos], cache, pos
            )
        buf = torch.cat([tokens, tokens.new_zeros(b, num_frames, h, w)], dim=1)
        for f in range(num_frames):
            tgt = t0 + f
            frame, cache = self._refine_frame(
                cache, tgt, actions[:, tgt], schedule, temp, (b, h, w),
                buf.dtype, top_k, generator,
                None if gumbel is None else gumbel[f],
            )
            buf[:, tgt] = frame
        return buf

    def _refine_frame(self, cache, tgt, act_t, schedule, temp, bhw, dtype,
                      top_k=None, generator=None, gumbel=None):
        """One cached MaskGIT frame: `len(schedule)` read-only refinement
        passes over the new frame, then a commit pass that appends the
        finished frame's K/V and FFN window to the caches."""
        b, h, w = bhw
        mask = torch.ones(b, h * w, dtype=torch.bool, device=act_t.device)
        code = torch.zeros(b, h * w, dtype=dtype, device=act_t.device)
        for s, num_tokens in enumerate(schedule):
            frame = code.masked_fill(mask, 0).view(b, h, w)
            logits, _ = self.dynamics.decode_frame(
                frame, act_t, cache, tgt, commit=False
            )
            mask, code = maskgit_commit(
                logits.reshape(b, h * w, -1), mask, code, int(num_tokens),
                temp, top_k=top_k, generator=generator,
                gumbel=None if gumbel is None else gumbel[s],
            )
        frame = code.view(b, h, w)
        _, cache = self.dynamics.decode_frame(frame, act_t, cache, tgt)
        return frame, cache

    def _check_actions(self, actions: torch.Tensor, total: int) -> torch.Tensor:
        """Reject ids outside `[0, act_vocab)` (the embedding has no row for
        them), and zero-pad short action lists to `total` frames."""
        if actions.numel() and (
            int(actions.min()) < 0 or int(actions.max()) >= self.act_vocab
        ):
            raise ValueError(
                f"action ids must lie in [0, {self.act_vocab}), got "
                f"[{int(actions.min())}, {int(actions.max())}]"
            )
        if actions.shape[1] < total:
            pad = actions.new_zeros(actions.shape[0], total - actions.shape[1])
            actions = torch.cat([actions, pad], dim=1)
        return actions

    @torch.inference_mode()
    def generate_tokens(
        self,
        prompt: torch.Tensor,
        actions: torch.Tensor,
        num_frames: int,
        steps_per_frame: int = 25,
        temp: float = 1.0,
        top_k: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """`forward` up to the token video `(B, T0 + num_frames, H', W')`."""
        tokens = self.tokenize_prompt(prompt)
        t0 = tokens.shape[1]
        actions = self._check_actions(actions.to(tokens.device), t0 + num_frames)
        if gumbel is not None:
            b, _, h, w = tokens.shape
            expect = (num_frames, steps_per_frame, b, h * w, self.dynamics.head.out_features)
            if tuple(gumbel.shape) != expect:
                raise ValueError(f"gumbel must have shape {expect}, got {tuple(gumbel.shape)}")
        return self.rollout_tokens(
            tokens, actions, num_frames, steps_per_frame, temp, top_k=top_k,
            generator=generator, gumbel=gumbel,
        )

    def forward(
        self,
        prompt: torch.Tensor,
        actions: torch.Tensor,
        num_frames: int,
        steps_per_frame: int = 25,
        temp: float = 1.0,
        top_k: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Generate video from an image/video prompt and action ids.

        Returns `(B, T0 + num_frames, H, W, C)` channels-last video. The
        MaskGIT sampling noise comes from `generator`, or from `gumbel`, a
        `(num_frames, steps_per_frame, B, H'*W', V)` tensor (parity tests
        feed the JAX package's noise through it).
        """
        tokens = self.generate_tokens(
            prompt, actions, num_frames, steps_per_frame, temp, top_k,
            generator, gumbel,
        )
        return self.tokenizer.decode_tokens(tokens)
