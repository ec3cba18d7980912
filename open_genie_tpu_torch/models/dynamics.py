"""MaskGIT DynamicsModel (twin of `open_genie_tpu.models.dynamics`): the
full forward and its Bernoulli-masked training loss, the KV-cached frame
decode of the rollout, and `generate`, which appends one frame by MaskGIT
refinement, through the KV caches where the trunk allows it."""
from __future__ import annotations

from math import pi
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from open_genie_tpu_torch.modules import blueprint_out_width, parse_blueprint
from open_genie_tpu_torch.modules.attention import st_attn_cache
from open_genie_tpu_torch.ops.kernels.maskgit_sample import gumbel_of_uniform, maskgit_sample
from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.parallel.tensor import vocab_parallel_argmax, vocab_parallel_log_prob
from open_genie_tpu_torch.utils import module_dtype


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
    instead. The cached decode is not split."""

    tp_group = None
    tp_parts = frozenset()

    def __init__(self, desc: Any, tok_vocab: int, act_vocab: int, embed_dim: int):
        super().__init__()
        self.desc = desc
        # Layers marked `has_ext` are built and, as in the JAX package, run
        # with no condition: the trunk has none to give them.
        self.layers, _ = parse_blueprint(desc, width=embed_dim)
        self.tok_emb = nn.Embedding(tok_vocab, embed_dim)
        self.act_emb = nn.Embedding(act_vocab, embed_dim)
        self.head = nn.Linear(blueprint_out_width(desc, embed_dim), tok_vocab)

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
        x = self._embed("tok_emb", tokens) + self._embed("act_emb", act_id)[:, :, None, None, :]
        for layer in self.layers:
            x = layer(x)
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
        """Zeroed per-layer decode caches for a `t_max`-frame rollout
        (all-`space-time_attn` trunks only). Dtype and device default to
        the model's."""
        if self.tp_parts:
            raise NotImplementedError("the cached decode of a tensor-parallel dynamics model is "
                                      "not split (no TP rollout); gather the weights first")
        dtype = dtype or module_dtype(self)
        device = device or self.head.weight.device
        caches = []
        for desc in self.desc:
            name, kwargs = (desc, {}) if isinstance(desc, str) else desc
            assert name == "space-time_attn", (
                "cached decode requires an all-space-time_attn dynamics trunk"
            )
            for _ in range(int(kwargs.get("n_rep", 1))):
                caches.append(st_attn_cache(kwargs, batch, h, w, t_max, dtype, device))
        return caches

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
        x = self.tok_emb(frame_tok[:, None]) + self.act_emb(act_id)[:, None, None, None, :]
        for layer, layer_cache in zip(self.layers, cache):
            x, _ = layer(x, cache=layer_cache, cache_pos=pos, cache_write=commit)
        return self.head(x[:, 0]), cache

    def supports_cached_decode(self) -> bool:
        """Whether `generate` can refine through the KV-cached frame decode:
        only an all-`space-time_attn` trunk has decode caches; any other
        trunk re-forwards the whole clip every step, as a split model
        does."""
        return not self.tp_parts and all(
            (d if isinstance(d, str) else d[0]) == "space-time_attn" for d in self.desc)

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
