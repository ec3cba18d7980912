"""MaskGIT DynamicsModel (twin of `open_genie_tpu.models.dynamics`): the
full forward and its Bernoulli-masked training loss, the KV-cached frame
decode of the rollout, `refine_frame` (one frame by cached MaskGIT
refinement, which the Genie's rollout and session and the block session
of `serve.py` run), a prefill of many frames, and `generate`, which
appends one frame by MaskGIT refinement, through the KV caches where the
trunk allows it.

Beyond the JAX package's model: the action embedding is optional (a
token model, such as SDAR-30B-A3B, has none), masked positions take a
configured `mask_id`, the head may have no bias and may follow a final
RMSNorm. Which of these a model has is settled at construction; the
per-frame decode runs no branch for them."""
from __future__ import annotations

from math import pi
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from open_genie_tpu_torch.modules import blueprint_out_width, parse_blueprint
from open_genie_tpu_torch.modules.norm import RMSNorm
from open_genie_tpu_torch.ops.kernels.maskgit_sample import gumbel_of_uniform, maskgit_sample
from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.parallel.tensor import vocab_parallel_argmax, vocab_parallel_log_prob
from open_genie_tpu_torch.utils import module_dtype
from open_genie_tpu_torch.utils.debug import span


def get_schedule(steps: int, shape: Tuple[int, int], which: str = "linear") -> np.ndarray:
    """Tokens-per-step schedule summing exactly to `h * w`: linear / cosine
    / arccos ramps, at least 1 token per step, remainder on the last step."""
    n = int(np.prod(shape))
    t = np.linspace(1, 0, steps)
    if which == "linear":
        s = 1 - t
    elif which == "cosine":
        s = np.cos(t * pi * 0.5)
    elif which == "arccos":
        s = np.arccos(t) / (pi * 0.5)
    else:
        raise ValueError(f"Unknown schedule type: {which}")
    total = s.sum()
    if steps == 1 or total <= 0:
        # Degenerate ramps (steps=1 makes a single zero weight): uniform split.
        s = np.ones(steps)
        total = float(steps)
    schedule = (s / total) * n
    schedule = np.clip(np.round(schedule).astype(np.int32), 1, None)
    schedule[-1] += n - schedule.sum()
    return schedule


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise rounded to bf16 (the JAX package draws it in
    bf16), from `generator`, returned as float32."""
    return gumbel_of_uniform(_uniform(shape, generator, device))


def _uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The one float32 uniform draw behind a refinement's Gumbel noise."""
    if generator is None:
        raise ValueError("pass a torch.Generator or a gumbel noise tensor")
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def maskgit_commit(
    logits: torch.Tensor,
    mask: torch.Tensor,
    code: torch.Tensor,
    num_tokens: int,
    temp: float = 1.0,
    top_k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MaskGIT refinement commit.

    Args:
      logits: `(B, HW, V)` raw logits (any float dtype).
      mask: `(B, HW)` bool, True = still masked.
      code: `(B, HW)` committed token ids so far.
      num_tokens: tokens to commit this step.
      top_k: sample among each position's `top_k` highest logits.
      generator / gumbel: the Gumbel noise, given as a `(B, HW, V)` tensor
        or drawn from the generator (one float32 uniform draw of the
        logits' shape).

    Samples by Gumbel-argmax; confidence is the sampled token's
    log-probability. The `num_tokens` most confident masked positions
    commit by a descending sort and a threshold compare, so on an exact
    confidence tie at the threshold both positions commit. All after the
    draw is `ops.kernels.maskgit_sample`: kernel K7 on the card, its plain
    twin on the CPU.
    """
    v = logits.shape[-1]
    if logits.dtype not in (torch.float32, torch.bfloat16):
        logits = logits.float()
    if top_k is not None:
        assert top_k >= 1, f"top_k must be >= 1, got {top_k}"
        if top_k < v:
            logits = logits.float() / temp
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits, temp = logits.masked_fill(logits < kth, float("-inf")), 1.0
    if gumbel is None:
        noise = _uniform(logits.shape, generator, logits.device)
    else:
        noise = gumbel if gumbel.dtype in (torch.float32, torch.bfloat16) else gumbel.float()
    mask, code, _, _ = maskgit_sample(
        logits.contiguous(), noise.contiguous(), mask, code, num_tokens, temp,
        uniform=gumbel is None,
    )
    return mask, code


class DynamicsModel(nn.Module):
    """MaskGIT over `(B, T, H, W)` token grids with `(B, T)` action ids.

    Tensor parallel (`parallel.tensor.shard_module`): `tp_parts` names
    what is split over `tp_group`. A split embedding holds this rank's
    block of the width and its lookups are gathered; a split `head` holds
    this rank's block of the vocabulary: `forward` gathers the logits,
    `compute_loss` reduces the log-softmax and the argmax over the blocks
    instead. The cached decode is not split.

    `act_vocab` None: no action embedding (`act_id` is ignored and may be
    None). `mask_id`: the token that fills masked positions in
    `refine_frame`. `head_bias`: whether the head has a bias.
    `final_norm_eps`: an RMSNorm of that eps before the head, or none."""

    tp_group = None
    tp_parts = frozenset()

    def __init__(self, desc: Any, tok_vocab: int, act_vocab: Optional[int], embed_dim: int,
                 mask_id: int = 0, head_bias: bool = True,
                 final_norm_eps: Optional[float] = None):
        super().__init__()
        self.desc = desc
        # Layers marked `has_ext` are built and, as in the JAX package, run
        # with no condition: the trunk has none to give them.
        self.layers, _ = parse_blueprint(desc, width=embed_dim)
        width = blueprint_out_width(desc, embed_dim)
        self.tok_emb = nn.Embedding(tok_vocab, embed_dim)
        self.act_emb = None if act_vocab is None else nn.Embedding(act_vocab, embed_dim)
        self.norm = None if final_norm_eps is None else RMSNorm(width, final_norm_eps)
        self.head = nn.Linear(width, tok_vocab, bias=head_bias)
        self.mask_id = mask_id
        # The decode's choices, made here once.
        self._embed_frame = self._tokens if self.act_emb is None else self._tokens_and_action
        self._frame_logits = self._head if self.norm is None else self._normed_head
        self._chunked_prefill = all(getattr(layer, "prefills_chunks", False)
                                    for layer in self.layers)

    def _tokens(self, tok: torch.Tensor, act_id) -> torch.Tensor:
        return self.tok_emb(tok)

    def _tokens_and_action(self, tok: torch.Tensor, act_id: torch.Tensor) -> torch.Tensor:
        return self.tok_emb(tok) + self.act_emb(act_id)[:, None, None, None, :]

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)

    def _normed_head(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.norm(x))

    def _embed(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        out = getattr(self, name)(ids)
        return (collectives.gather_from_model(out, self.tp_group) if name in self.tp_parts
                else out)

    def _head_group(self):
        """The model group the head's vocabulary splits over, or None."""
        return self.tp_group if "head" in self.tp_parts else None

    def _local_logits(self, tokens: torch.Tensor, act_id: torch.Tensor) -> torch.Tensor:
        """The trunk and this rank's block of the head's logits (all of
        them where the head is not split)."""
        x = self._embed("tok_emb", tokens)
        if self.act_emb is not None:
            x = x + self._embed("act_emb", act_id)[:, :, None, None, :]
        for layer in self.layers:
            x = layer(x)
        if self.norm is not None:
            x = self.norm(x)
        group = self._head_group()
        return self.head(x if group is None else collectives.copy_to_model(x, group))

    def forward(self, tokens: torch.Tensor, act_id: torch.Tensor) -> torch.Tensor:
        """Full forward: per-position logits `(B, T, H, W, V)`; actions are
        embedded per frame and added over the spatial grid."""
        logits = self._local_logits(tokens, act_id)
        group = self._head_group()
        return logits if group is None else collectives.gather_from_model(logits, group)

    def compute_loss(
        self,
        tokens: torch.Tensor,
        act_id: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        fill: int = 0,
        group=None,
        rate_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Bernoulli-masked token cross-entropy over `(B, T, H, W)` tokens.

        `mask` (bool, True = masked) is given, or drawn: a rate ~ U(0.5, 1)
        from `rate_generator` (default `generator`), then each position
        masked with that rate from `generator`. Masked positions are
        replaced by `fill`; the loss is the mean cross-entropy over the
        masked positions only, against the original tokens. Returns
        `(loss, {"masked_frac", "masked_acc"})`.

        With a data-parallel `group`, `tokens` are this rank's rows of the
        global batch and every term is the global batch's: the sums over
        the masked positions of every rank over their global count. One
        rate a global batch, as the JAX package draws it, needs a
        `rate_generator` in the same state on every rank; `generator` is
        this rank's own. With a split head the cross-entropy and the
        accuracy's argmax are vocabulary-parallel.
        """
        if mask is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or a mask tensor")
            dev = tokens.device
            rate = 0.5 + 0.5 * torch.rand((), generator=rate_generator or generator, device=dev)
            mask = torch.rand(tokens.shape, generator=generator, device=dev) < rate
        inp = tokens.masked_fill(mask, fill)
        logits = self._local_logits(inp, act_id)
        vocab = self._head_group()
        tok_logp = vocab_parallel_log_prob(logits, tokens, vocab)
        masked = mask.float()
        hit = vocab_parallel_argmax(logits, vocab) == tokens
        nll, hits = (tok_logp * masked).sum(), (hit.float() * masked).sum()
        if not collectives.reduces(group):
            denom = masked.sum().clamp_min(1.0)
            frac = masked.mean()
        else:
            nll, hits, count, total = collectives.global_sums(
                [nll, hits, masked.sum(), masked.numel()], group)
            denom = count.clamp_min(1.0)
            frac = (count / total).float()
        loss = -nll / denom
        acc = hits / denom
        return loss, {"masked_frac": frac, "masked_acc": acc}

    def init_cache(self, batch: int, h: int, w: int, t_max: int,
                   dtype: Optional[torch.dtype] = None, device=None) -> List[dict]:
        """Zeroed per-layer decode caches for a `t_max`-frame rollout, each
        from its layer (`init_cache`). Every layer must keep a cache of one
        kind (`cache_kind`: per-position temporal buffers of `space-time_attn`,
        or K/V over the token prefix of `sdar_block`); otherwise raises
        `ValueError` naming the first layer that does not. Dtype and device
        default to the model's."""
        if self.tp_parts:
            raise NotImplementedError("the cached decode of a tensor-parallel dynamics model is "
                                      "not split (no TP rollout); gather the weights first")
        kinds = [getattr(layer, "cache_kind", None) for layer in self.layers]
        for i, (layer, kind) in enumerate(zip(self.layers, kinds)):
            if kind is None or kind != kinds[0]:
                have = "no decode cache" if kind is None else f"a {kind!r} cache"
                raise ValueError(
                    f"cached decode: dynamics layer {i} ({type(layer).__name__}) has {have}; "
                    f"layer 0 ({type(self.layers[0]).__name__}) has a {kinds[0]!r} cache, and "
                    f"every layer must keep one of the same kind")
        dtype = dtype or module_dtype(self)
        device = device or self.head.weight.device
        return [layer.init_cache(batch, h, w, t_max, dtype, device) for layer in self.layers]

    @torch.inference_mode()
    def decode_frame(self, frame_tok: torch.Tensor, act_id: torch.Tensor,
                     cache: List[dict], pos: int, commit: bool = True):
        """One-frame forward against cached history.

        `frame_tok` `(B, H, W)` are the tokens of the frame at time `pos`,
        `act_id` `(B,)` its actions. `commit=True` writes the frame's K/V
        and FFN window into `cache` in place (prefill, final commit);
        `commit=False` only reads it (MaskGIT refine steps). Returns
        `(logits (B, H, W, V), cache)`.
        """
        x = self._embed_frame(frame_tok[:, None], act_id)
        for layer, layer_cache in zip(self.layers, cache):
            x, _ = layer(x, cache=layer_cache, cache_pos=pos, cache_write=commit)
        return self._frame_logits(x[:, 0]), cache

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, act_id: Optional[torch.Tensor], cache: List[dict],
                pos: int) -> List[dict]:
        """Commit the `(B, T, H, W)` frames at positions `pos .. pos + T - 1`
        (with their `(B, T)` actions, if the model takes any) into `cache`
        in one pass of the trunk, whose layers must all prefill several
        frames at once (`prefills_chunks`; other trunks commit a frame at a
        time through `decode_frame`). Computes no logits."""
        if not self._chunked_prefill:
            raise NotImplementedError("this trunk's layers commit one frame at a time "
                                      "(decode_frame); none prefills several at once")
        x = self.tok_emb(tokens)
        if self.act_emb is not None:
            x = x + self.act_emb(act_id)[:, :, None, None, :]
        for layer, layer_cache in zip(self.layers, cache):
            x, _ = layer(x, cache=layer_cache, cache_pos=pos)
        return cache

    def refine_frame(self, cache, tgt, act_t, schedule, temp, bhw, dtype, device, top_k=None,
                     generator=None, gumbel=None, commit=maskgit_commit, decode=None):
        """One cached MaskGIT frame at position `tgt`: `len(schedule)`
        read-only refinement passes over the new frame (its masked
        positions filled with `mask_id`), each followed by a commit of
        `schedule[s]` tokens sampled from the noise (`gumbel[s]`, or one
        uniform draw from `generator`), then a commit pass that appends the
        finished frame to the caches. `bhw` is the frame's `(B, H, W)`,
        `dtype` and `device` its tokens'. `commit` is the sampler
        (`maskgit_commit`), `decode` the pass (`decode_frame`, or a caller's
        replay of it). Returns `(frame, cache)`."""
        b, h, w = bhw
        mask = torch.ones(b, h * w, dtype=torch.bool, device=device)
        code = torch.zeros(b, h * w, dtype=dtype, device=device)
        for s, num_tokens in enumerate(schedule):
            with span("dynamics.refine"):
                frame = code.masked_fill(mask, self.mask_id).view(b, h, w)
                logits, _ = decode(frame, act_t, cache, tgt, commit=False)
            with span("maskgit.sample"):
                mask, code = commit(
                    logits.reshape(b, h * w, -1), mask, code, int(num_tokens),
                    temp, top_k=top_k, generator=generator,
                    gumbel=None if gumbel is None else gumbel[s],
                )
        frame = code.view(b, h, w)
        with span("dynamics.commit"):
            _, cache = decode(frame, act_t, cache, tgt)
        return frame, cache

    def supports_cached_decode(self) -> bool:
        """Whether `generate` can refine through the KV-cached frame decode:
        every layer keeps a decode cache, all of one kind (`init_cache`);
        any other trunk re-forwards the whole clip every step, as a split
        model does."""
        kinds = {getattr(layer, "cache_kind", None) for layer in self.layers}
        return not self.tp_parts and len(kinds) == 1 and None not in kinds

    @torch.inference_mode()
    def generate(
        self,
        tokens: torch.Tensor,
        act_id: torch.Tensor,
        steps: int = 10,
        which: str = "linear",
        temp: float = 1.0,
        masked_tok: int = 0,
        use_cache: bool = True,
        top_k: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Append one frame to the `(B, T, H, W)` token history by `steps`
        MaskGIT refinements: `(B, T + 1, H, W)` tokens.

        `act_id` `(B, T)` are the history's actions; the appended frame
        takes a zero action (the "mock" action slot). Each step conditions
        on the tokens committed so far, the rest filled with `masked_tok`.
        With `use_cache` and an all-`space-time_attn` trunk the history is
        prefilled into KV caches once and each step decodes only the new
        frame; otherwise each step re-forwards the whole clip. The noise is
        `gumbel`, a `(steps, B, H*W, V)` tensor, or drawn from `generator`.
        """
        b, t, h, w = tokens.shape
        schedule = get_schedule(steps, (h, w), which)
        mask = torch.ones(b, h * w, dtype=torch.bool, device=tokens.device)
        code = torch.full((b, h * w), masked_tok, dtype=tokens.dtype, device=tokens.device)
        act_new = act_id.new_zeros(b)
        if use_cache and self.supports_cached_decode():
            cache = self.init_cache(b, h, w, t + 1, device=tokens.device)
            for pos in range(t):
                _, cache = self.decode_frame(tokens[:, pos], act_id[:, pos], cache, pos)

            def logits_of(frame):
                return self.decode_frame(frame, act_new, cache, t, commit=False)[0]
        else:
            grid = torch.cat([tokens, tokens.new_full((b, 1, h, w), masked_tok)], dim=1)
            acts = torch.cat([act_id, act_new[:, None]], dim=1)

            def logits_of(frame):
                grid[:, -1] = frame
                return self(grid, acts)[:, -1]
        for s, num_tokens in enumerate(schedule):
            frame = code.masked_fill(mask, masked_tok).view(b, h, w)
            mask, code = maskgit_commit(
                logits_of(frame).reshape(b, h * w, -1), mask, code, int(num_tokens), temp,
                top_k=top_k, generator=generator, gumbel=None if gumbel is None else gumbel[s],
            )
        return torch.cat([tokens, code.view(b, 1, h, w)], dim=1)
