"""Scaled dot-product attention: plain path + flash-kernel dispatch.

Twin of `open_genie_tpu.ops.attention`. A call with no mask, as many
queries as keys, a head dim the flash kernels take (`HEAD_DIMS`) and f32 or
bf16 inputs goes to flash attention (kernel K1 on a CUDA tensor, and K3 and
K4 for its gradient; the plain twins on a CPU tensor); every other call
takes the plain path, on either device, as the JAX package's XLA path takes
every call off the TPU. The choice is made from shapes and dtypes before
any launch. The JAX package sends such calls to its Pallas kernel only from
1024 tokens up, a threshold measured on a TPU; on Hopper the threshold is
still to be chosen by measurement, so all of them go to the kernel for now.
"""
from __future__ import annotations

from typing import Optional

import torch

from open_genie_tpu_torch.ops.kernels.flash_attention import (
    DTYPES,
    HEAD_DIMS,
    flash_attention_autograd,
)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over `(B, H, N, D)` tensors.

    `mask` is a boolean tensor broadcastable to `(B, H, Nq, Nk)`, True
    meaning "attend". With `causal`, the diagonal is aligned to the end of
    the keys (queries may see earlier keys when Nk > Nq).
    """
    b, h, nq, d = q.shape
    nk = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    if mask is None and nq == nk and d in HEAD_DIMS and q.dtype in DTYPES:
        qf, kf, vf = (t.reshape(b * h, nq, d).contiguous() for t in (q, k, v))
        return flash_attention_autograd(qf, kf, vf, scale, causal).view(b, h, nq, d)
    return _plain_attention(q, k, v, scale, causal=causal, mask=mask)


def _plain_attention(q, k, v, scale, causal=False, mask=None):
    """Twin of `_xla_attention`: f32 logits and accumulation, probabilities
    cast to the input dtype before the value product."""
    orig_dtype = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        nq, nk = logits.shape[-2:]
        row = torch.arange(nq, device=q.device)[:, None] + (nk - nq)
        col = torch.arange(nk, device=q.device)[None, :]
        logits = logits.masked_fill(col > row, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(orig_dtype).float(), v.float())
    return out.to(orig_dtype)
