"""Registry `sdar_block`: one layer of SDAR-30B-A3B, a block-diffusion
language model on a Qwen3-MoE body (https://huggingface.co/JetLM/
SDAR-30B-A3B-Chat). The port's own: the JAX package has none.

Pre-norm residuals, `h = x + Attn(RMSNorm(x))`, `y = h + MoE(RMSNorm(h))`:
block-causal grouped-query attention with per-head QK-norm and RoPE
(`modules/attention.py::BlockCausalAttention`), then top-k routed SwiGLU
experts (`modules/moe.py::SparseMoE`).

On the dynamics trunk's `(B, T, H, W, C)` frames, each frame is one block
of `H * W` tokens, in raster order: tokens see their own block and every
earlier one. Its decode cache (`cache_kind` "token") holds K/V over the
whole token prefix; a refinement and a commit of a block alike write the
block's K/V into its slots and attend over the prefix, and a pass of
several frames (a prefill) writes them all.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from open_genie_tpu_torch.modules.attention import BlockCausalAttention, block_attn_cache
from open_genie_tpu_torch.modules.moe import SparseMoE
from open_genie_tpu_torch.modules.norm import RMSNorm


class SdarBlock(nn.Module):
    """Pre-norm block-causal attention and sparse experts, `n_embd` wide."""

    cache_kind = "token"
    prefills_chunks = True

    def __init__(self, n_embd: int, n_head: int = 32, n_kv_head: int = 4, d_head: int = 128,
                 n_experts: int = 128, top_k: int = 8, d_expert: int = 768,
                 norm_topk_prob: bool = True, rope_theta: float = 1e6, eps: float = 1e-6):
        super().__init__()
        self.attn_norm = RMSNorm(n_embd, eps)
        self.attn = BlockCausalAttention(n_embd, n_head, n_kv_head, d_head, rope_theta, eps)
        self.moe_norm = RMSNorm(n_embd, eps)
        self.moe = SparseMoE(n_embd, n_experts, top_k, d_expert, norm_topk_prob)

    def init_cache(self, batch: int, h: int, w: int, t_max: int, dtype: torch.dtype,
                   device=None) -> dict:
        """The `(B, n_kv_head, t_max * h * w, d_head)` K/V of `t_max` frames."""
        return block_attn_cache(self.attn.n_kv_head, self.attn.d_head, batch, t_max * h * w,
                                dtype, device)

    def forward(self, video: torch.Tensor, cache: Optional[dict] = None,
                cache_pos: Optional[int] = None, cache_write: bool = True):
        """Full forward on `(B, T, H, W, C)`, or the frames at `cache_pos`
        onwards against the cache (returns `(out, cache)`; `cache_write`
        is moot: every pass writes its frames' K/V)."""
        b, t, h, w, c = video.shape
        blk = h * w
        x = video.reshape(b, t * blk, c)
        pos = 0 if cache is None else cache_pos * blk
        x = x + self.attn(self.attn_norm(x), blk, cache, pos)
        x = x + self.moe(self.moe_norm(x))
        out = x.view(b, t, h, w, c)
        return out if cache is None else (out, cache)
