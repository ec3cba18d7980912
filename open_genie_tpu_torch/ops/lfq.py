"""Lookup-free quantization (twin of `open_genie_tpu.ops.lfq`).

Bit i of a code index is 1 iff feature i is `> 0`, most significant bit
first. The training losses are ported for codebooks of at most 4096 codes,
whose batch-averaged entropy takes the direct path; above that the JAX
package streams over the codebook with kernels K5/K6, not ported yet.

The entropy terms at beta = 100 cancel two large logits against each other,
so their products must be true f32: they are written as broadcast sums of
`+-x` over the codewords, not as matmuls, so that no TF32 setting can reach
them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# Codebooks up to this many codes take the direct (one-pass) path.
DIRECT_MAX_CODES = 4096


def bit_mask(codebook_dim: int, device=None) -> torch.Tensor:
    """`(d,)` int32 powers of two, MSB-first: `[2^(d-1), ..., 2, 1]`."""
    return 2 ** torch.arange(
        codebook_dim - 1, -1, -1, dtype=torch.int32, device=device
    )


def codebook_entries(idxs: torch.Tensor, codebook_dim: int) -> torch.Tensor:
    """Map integer code indices to their float32 `{-1, +1}^d` codewords."""
    bits = (idxs[..., None] & bit_mask(codebook_dim, idxs.device)) != 0
    return 2.0 * bits.float() - 1.0


def pack_bits(pos: torch.Tensor) -> torch.Tensor:
    """`(..., d)` bool -> `(...)` int32 index, first feature most significant."""
    mask = bit_mask(pos.shape[-1], pos.device)
    return (pos.to(torch.int32) * mask).sum(-1, dtype=torch.int32)


def lfq_quantize(
    x: torch.Tensor, codebook_dim: int, training: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign quantization of `(..., d)` features: `(code, indices)`.

    `x > 0` decides, never `sign`: `sign(0) = 0` would emit a codeword
    outside `{-1, +1}^d` and disagree with the bit convention of the index.
    With `training`, the straight-through estimator passes the gradient
    around the sign: `code = x + detach(quant - x)`.
    """
    assert x.shape[-1] == codebook_dim, (x.shape, codebook_dim)
    pos = x > 0
    quant = torch.where(pos, 1.0, -1.0).to(x.dtype)
    code = x + (quant - x).detach() if training else quant
    return code, pack_bits(pos)


def lfq_sample_entropy(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Exact per-sample codeword entropy in closed form: the softmax over
    the `2^d` codewords factorizes into `d` Bernoullis with
    `p_i = sigmoid(4 beta x_i)`. Mean over the leading axes (scalar)."""
    a = 4.0 * beta * x.float()
    ent_bits = F.softplus(a) - a * torch.sigmoid(a)
    return ent_bits.sum(-1).mean()


def _signed_sums(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """`(n, m)` f32 products `x . c` for `(n, d)` x and `(m, d)` codewords in
    `{-1, +1}`: a broadcast sum, so true f32 whatever the TF32 settings."""
    return (x.float()[:, None, :] * codes[None]).sum(-1)


def lfq_avg_probs_direct(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Batch-averaged codeword distribution `(2^d,)` of `(n, d)` features,
    through the full `(n, 2^d)` softmax (small codebooks only)."""
    n, d = x.shape
    codes = codebook_entries(torch.arange(2 ** d, device=x.device), d)
    probs = torch.softmax(2.0 * beta * _signed_sums(x, codes), dim=-1)
    return probs.mean(0)


def lfq_avg_entropy(
    x: torch.Tensor, beta: float = 100.0, eps: float = 1e-6
) -> torch.Tensor:
    """Entropy of the batch-averaged codeword distribution of `(n, d)`
    features (scalar). Direct path only: more than `DIRECT_MAX_CODES` codes
    need kernel K5, which is not ported yet."""
    d = x.shape[-1]
    if 2 ** d > DIRECT_MAX_CODES:
        raise NotImplementedError(
            f"LFQ average entropy over 2^{d} codes needs kernel K5 "
            f"(open_genie_tpu/ops/pallas/lfq_entropy.py), not ported yet"
        )
    q = lfq_avg_probs_direct(x, beta)
    return -(q * torch.log(q.clamp_min(eps))).sum()


def lfq_bit_entropy(x: torch.Tensor) -> torch.Tensor:
    """Codebook-usage monitor `sum_b H(mean(x_b > 0))` in nats (no
    gradient: the rates are step functions of `x`)."""
    p = (x.reshape(-1, x.shape[-1]) > 0).float().mean(0)
    p = p.clamp(1e-6, 1.0 - 1e-6)
    return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p)).sum()


def lfq_bit_balance_loss(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-bit balance plus decorrelation of `y = tanh(x / rms(x))`
    (scalar): `mean_b (mean_n y)^2` plus the mean squared off-diagonal
    correlation of `y`."""
    d = x.shape[-1]
    flat = x.reshape(-1, d).float()
    n = flat.shape[0]
    rms = torch.sqrt((flat * flat).mean() + eps)
    y = torch.tanh(flat / rms)
    mean_b = y.mean(0)
    balance = (mean_b ** 2).mean()
    yc = y - mean_b
    cov = (yc[:, :, None] * yc[:, None, :]).sum(0) / n  # true f32, like HIGHEST
    var = torch.diagonal(cov)
    corr = cov / torch.sqrt(var[:, None] * var[None, :] + eps)
    off = corr - torch.diag(torch.diagonal(corr))
    return balance + (off ** 2).sum() / (d * max(d - 1, 1))


def lfq_loss(
    x: torch.Tensor,
    quant: torch.Tensor,
    beta: float = 100.0,
    commit_weight: float = 0.25,
    entropy_weight: float = 0.1,
    diversity_weight: float = 1.0,
    frac_sample: float = 1.0,
    bit_balance_weight: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The LFQ training loss of `(..., d)` pre-quantization features of one
    codebook: `(loss, aux)`. `quant` is the sign target of the commitment
    MSE (no gradient). The entropy objective is `sample_entropy -
    diversity_weight * avg_entropy`; `frac_sample < 1` strides the tokens
    entering the average entropy. (The JAX package's several codebooks and
    anneal scales wait for tokenizer training.)
    """
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    sample_ent = lfq_sample_entropy(flat, beta)
    commit_loss = ((x.float() - quant.float().detach()) ** 2).mean()
    loss = commit_weight * commit_loss
    aux = {
        "sample_entropy": sample_ent,
        "commit_loss": commit_loss,
        "bit_entropy": lfq_bit_entropy(flat),
    }
    if entropy_weight != 0.0:
        sub = flat
        if frac_sample < 1.0:
            n = flat.shape[0]
            k = max(1, int(n * frac_sample))
            sub = flat[:: max(1, n // k)][:k]
        avg_ent = lfq_avg_entropy(sub, beta)
        loss = loss + entropy_weight * (sample_ent - diversity_weight * avg_ent)
        aux["avg_entropy"] = avg_ent
    if bit_balance_weight != 0.0:
        bal = lfq_bit_balance_loss(flat)
        loss = loss + bit_balance_weight * bal
        aux["bit_balance"] = bal
    return loss, aux
