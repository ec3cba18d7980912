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
    if generator is None:
        raise ValueError("pass a torch.Generator or a gumbel noise tensor")
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(torch.bfloat16).float()


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
        or drawn from the generator.

    Samples by Gumbel-argmax; confidence is the sampled token's
    log-probability. The `num_tokens` most confident masked positions
    commit by a descending sort and a threshold compare, so on an exact
    confidence tie at the threshold both positions commit.
    """
    b, hw, v = logits.shape
    logits = logits.float() / temp
    if top_k is not None:
        assert top_k >= 1, f"top_k must be >= 1, got {top_k}"
        if top_k < v:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, device=logits.device)
    pred = torch.argmax(logits + gumbel.float(), dim=-1)  # (B, HW)
    logp = torch.gather(logits, -1, pred[..., None])[..., 0]
    conf = logp - torch.logsumexp(logits, dim=-1)
    conf = conf.masked_fill(~mask, float("-inf"))

    sorted_conf = torch.sort(conf, dim=-1, descending=True).values
    idx = min(max(int(num_tokens) - 1, 0), hw - 1)
    thr = sorted_conf[:, idx: idx + 1]  # the num_tokens-th best per row
    commit = (conf >= thr) & mask
    code = torch.where(commit, pred.to(code.dtype), code)
    return mask & ~commit, code


class DynamicsModel(nn.Module):
    """MaskGIT over `(B, T, H, W)` token grids with `(B, T)` action ids."""

    def __init__(self, desc: Any, tok_vocab: int, act_vocab: int, embed_dim: int):
        super().__init__()
        self.desc = desc
        # Layers marked `has_ext` are built and, as in the JAX package, run
        # with no condition: the trunk has none to give them.
        self.layers, _ = parse_blueprint(desc, width=embed_dim)
        self.tok_emb = nn.Embedding(tok_vocab, embed_dim)
        self.act_emb = nn.Embedding(act_vocab, embed_dim)
        self.head = nn.Linear(blueprint_out_width(desc, embed_dim), tok_vocab)

    def forward(self, tokens: torch.Tensor, act_id: torch.Tensor) -> torch.Tensor:
        """Full forward: per-position logits `(B, T, H, W, V)`; actions are
        embedded per frame and added over the spatial grid."""
        x = self.tok_emb(tokens) + self.act_emb(act_id)[:, :, None, None, :]
        for layer in self.layers:
            x = layer(x)
        return self.head(x)

    def compute_loss(
        self,
        tokens: torch.Tensor,
        act_id: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        fill: int = 0,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Bernoulli-masked token cross-entropy over `(B, T, H, W)` tokens.

        `mask` (bool, True = masked) is given, or drawn from `generator`:
        a rate ~ U(0.5, 1), then each position masked with that rate.
        Masked positions are replaced by `fill`; the loss is the mean
        cross-entropy over the masked positions only, against the original
        tokens. Returns `(loss, {"masked_frac", "masked_acc"})`.
        """
        if mask is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or a mask tensor")
            dev = tokens.device
            rate = 0.5 + 0.5 * torch.rand((), generator=generator, device=dev)
            mask = torch.rand(tokens.shape, generator=generator, device=dev) < rate
        inp = tokens.masked_fill(mask, fill)
        logits = self(inp, act_id)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_logp = torch.gather(logp, -1, tokens.long()[..., None])[..., 0]
        masked = mask.float()
        denom = masked.sum().clamp_min(1.0)
        loss = -(tok_logp * masked).sum() / denom
        acc = ((logits.argmax(-1) == tokens).float() * masked).sum() / denom
        return loss, {"masked_frac": masked.mean(), "masked_acc": acc}

    def init_cache(self, batch: int, h: int, w: int, t_max: int,
                   dtype: Optional[torch.dtype] = None, device=None) -> List[dict]:
        """Zeroed per-layer decode caches for a `t_max`-frame rollout
        (all-`space-time_attn` trunks only). Dtype and device default to
        the model's."""
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
        trunk re-forwards the whole clip every step."""
        return all((d if isinstance(d, str) else d[0]) == "space-time_attn" for d in self.desc)

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
