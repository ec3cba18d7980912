"""Genie: action-conditioned world model (twin of `open_genie_tpu.models.genie`).

Training (`compute_loss`): the frozen tokenizer turns the video into a
token grid, the latent-action VQ-VAE turns it into per-frame action ids
and its own loss, and the dynamics model's masked-token cross-entropy on
those tokens and actions is added to it.

Rollout (`forward`): the prompt is tokenized, each new frame is generated
by KV-cached MaskGIT refinement of the dynamics model, and the token video
is decoded to pixels. `rollout_tokens_full` is the same rollout without
caches, re-forwarding the whole clip each step.

Staged training: `tokenize_with_actions` turns video into the token and
action batches that `train.losses.DynamicsTrainModule` trains on.

Serving (`session_*`, `decode_window`, `init_pixel_stream`,
`decode_stream_frame`): the steps of `serve.InteractiveSession`, one
frame at a time against caches allocated for the session's horizon.
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
from open_genie_tpu_torch.utils.debug import span


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
        return_act_idxs: bool = False,
        group=None,
        rate_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Joint latent-action + dynamics loss on `(B, T, H, W, C)` video.

        The tokenizer runs frozen, with no graph. The latent-action model
        trains its LFQ (and applies dropout) when this module is in
        training mode. The dynamics' Bernoulli mask is `mask` or drawn from
        `generator` (see `DynamicsModel.compute_loss`). `return_act_idxs`
        adds the `(B, T)` per-input-frame action ids to the aux dict as
        `act_idxs` (for evaluation; the train step wants scalars). With a
        data-parallel `group`, `video` is this rank's rows of the global
        batch and both losses are the global batch's (`rate_generator`: see
        `DynamicsModel.compute_loss`).
        """
        _, tok_idxs = self.tokenizer.tokenize_frozen(video)
        act_idxs, act_loss, act_aux = self.latent_action(video, group=group)
        act_idxs_full = act_idxs
        act_idxs = self.align_actions(act_idxs, tok_idxs.shape[1])
        dyn_loss, dyn_aux = self.dynamics.compute_loss(
            tok_idxs, act_idxs, mask=mask, generator=generator, group=group,
            rate_generator=rate_generator,
        )
        aux = {
            "act_loss": act_loss,
            "dyn_loss": dyn_loss,
            **{f"act_{k}": v for k, v in act_aux.items()},
            **{f"dyn_{k}": v for k, v in dyn_aux.items()},
        }
        if return_act_idxs:
            aux["act_idxs"] = act_idxs_full
        return act_loss + dyn_loss, aux

    @torch.inference_mode()
    def tokenize_with_actions(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen-model inference for stage-3 training data: `(B, T, H, W,
        C)` video -> `(B, T', H', W')` tokens and the `(B, T')` action ids
        aligned to the token time axis. The latent action runs in eval mode
        (no LFQ loss, no dropout) whatever this module's mode."""
        tokens = self.tokenize_prompt(video)
        was_training = self.latent_action.training
        self.latent_action.eval()
        try:
            act_idxs, _, _ = self.latent_action(video)
        finally:
            self.latent_action.train(was_training)
        return tokens, self.align_actions(act_idxs, tokens.shape[1])

    def init_full(
        self,
        video: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The joint loss plus 0 x the mean of the tokenizer's
        reconstruction, as the JAX package's initialization path computes
        it. Every parameter exists from construction here, so this only
        gives that value (the reconstruction carries no graph)."""
        loss, _ = self.compute_loss(video, mask=mask, generator=generator)
        with torch.no_grad():
            _, idxs = self.tokenizer.tokenize_frozen(video)
            rec = self.tokenizer.decode(self.tokenizer.quant.decode_entries(idxs))
        return loss + 0.0 * rec.float().mean()

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

    @torch.inference_mode()
    def rollout_tokens_full(
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
        """Autoregressive MaskGIT rollout without caches: every refinement
        step re-forwards the dynamics over the whole fixed buffer of `T0 +
        num_frames` frames (the frames after the one being generated are
        zeros, which causal temporal attention keeps from the frames before
        them). Serves trunks that have no decode caches; token-exact with
        `rollout_tokens` given the same noise, up to rounding.

        `tokens` `(B, T0, H, W)`, `actions` `(B, >= T0 + num_frames)`; the
        noise is `gumbel`, a `(num_frames, steps_per_frame, B, H*W, V)`
        tensor, or drawn from `generator`. Returns `(B, T0 + num_frames, H,
        W)` tokens."""
        b, t0, h, w = tokens.shape
        total = t0 + num_frames
        schedule = get_schedule(steps_per_frame, (h, w), which)
        buf = torch.cat([tokens, tokens.new_zeros(b, num_frames, h, w)], dim=1)
        acts = actions[:, :total]
        for f in range(num_frames):
            tgt = t0 + f
            mask = torch.ones(b, h * w, dtype=torch.bool, device=tokens.device)
            code = torch.zeros(b, h * w, dtype=buf.dtype, device=tokens.device)
            for s, num_tokens in enumerate(schedule):
                buf[:, tgt] = code.masked_fill(mask, 0).view(b, h, w)
                logits = self.dynamics(buf, acts)[:, tgt]
                mask, code = maskgit_commit(
                    logits.reshape(b, h * w, -1), mask, code, int(num_tokens), temp,
                    top_k=top_k, generator=generator,
                    gumbel=None if gumbel is None else gumbel[f][s],
                )
            buf[:, tgt] = code.view(b, h, w)
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
            with span("dynamics.refine"):
                frame = code.masked_fill(mask, 0).view(b, h, w)
                logits, _ = self.dynamics.decode_frame(
                    frame, act_t, cache, tgt, commit=False
                )
            with span("maskgit.sample"):
                mask, code = maskgit_commit(
                    logits.reshape(b, h * w, -1), mask, code, int(num_tokens),
                    temp, top_k=top_k, generator=generator,
                    gumbel=None if gumbel is None else gumbel[s],
                )
        frame = code.view(b, h, w)
        with span("dynamics.commit"):
            _, cache = self.dynamics.decode_frame(frame, act_t, cache, tgt)
        return frame, cache

    # ------------------------------------------------------------------ #
    # Interactive session (see serve.py)
    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def session_prefill(self, prompt: torch.Tensor, max_frames: int,
                        actions: Optional[torch.Tensor] = None):
        """Start a session: tokenize the prompt, allocate KV caches for
        `t0 + max_frames` frames and commit the prompt frames with
        `actions[:, :t0]` (zeros by default). Returns `(buf, cache, t0)`,
        `buf` the tokens zero-padded to the session horizon."""
        tokens = self.tokenize_prompt(prompt)
        b, t0 = tokens.shape[:2]
        if actions is None:
            actions = torch.zeros(b, t0, dtype=torch.long, device=tokens.device)
        buf, cache = self.session_rebase(tokens, actions[:, :t0].to(tokens.device), max_frames)
        return buf, cache, t0

    @torch.inference_mode()
    def session_rebase(self, tokens: torch.Tensor, actions: torch.Tensor, max_frames: int):
        """Fresh KV caches prefilled from a trailing `(B, W, H, W)` token
        window and its `(B, W)` action ids, positions restarting at 0
        (exact for RoPE attention among the kept frames, whose scores
        depend only on position differences). Returns `(buf, cache)`,
        `buf` zero-padded to `W + max_frames` frames."""
        b, t0, h, w = tokens.shape
        cache = self.dynamics.init_cache(
            b, h, w, t0 + max_frames, dtype=self._decode_dtype(), device=tokens.device
        )
        for pos in range(t0):
            _, cache = self.dynamics.decode_frame(tokens[:, pos], actions[:, pos], cache, pos)
        buf = torch.cat([tokens, tokens.new_zeros(b, max_frames, h, w)], dim=1)
        return buf, cache

    @torch.inference_mode()
    def session_step(self, buf: torch.Tensor, cache, t: int, action: torch.Tensor,
                     steps_per_frame: int = 8, temp: float = 1.0, which: str = "linear",
                     top_k: Optional[int] = None, generator: Optional[torch.Generator] = None,
                     gumbel: Optional[torch.Tensor] = None):
        """Generate the frame at position `t` of the session buffer from a
        live `(B,)` action, writing it into `buf` and its K/V into `cache`
        in place. The noise comes from `generator`, or from `gumbel`, a
        `(steps, B, H'*W', V)` tensor. Returns `(buf, cache)`; token-exact
        with `rollout_tokens` given the same noise."""
        b, _, h, w = buf.shape
        schedule = get_schedule(steps_per_frame, (h, w), which)
        frame, cache = self._refine_frame(
            cache, t, action, schedule, temp, (b, h, w), buf.dtype, top_k, generator, gumbel
        )
        buf[:, t] = frame
        return buf, cache

    def decode_window(self, tokens: torch.Tensor) -> torch.Tensor:
        """Decode a token-frame window to pixels."""
        return self.tokenizer.decode_tokens(tokens)

    def init_pixel_stream(self, batch: int, h: int, w: int, t_max: int, device=None) -> list:
        """Streaming pixel-decoder states for a `t_max`-frame session, in
        the tokenizer's own dtype (`VideoTokenizer.init_stream_cache`)."""
        return self.tokenizer.init_stream_cache(batch, h, w, t_max, device=device)

    def decode_stream_frame(self, idxs: torch.Tensor, dcache: list, pos: int):
        """Stream-decode one token frame to pixels: `(pixels, dcache)`,
        exact against `decode_window` (`VideoTokenizer.decode_stream`)."""
        with span("tokenizer.decode_stream"):
            return self.tokenizer.decode_stream(idxs, dcache, pos)

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
