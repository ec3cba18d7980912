"""Lookup-free quantization (twin of `open_genie_tpu.ops.lfq`).

Bit i of a code index is 1 iff feature i is `> 0`, most significant bit
first. The batch-averaged entropy of a codebook of at most 4096 codes takes
the direct path; above that it streams over the codebook through
`LfqAvgEntropy` (kernels K5/K6 on a CUDA tensor, their plain chunked twins
on a CPU tensor), as the JAX package streams through its Pallas kernels or
`_lfq_avg_entropy_chunked`.

Every batch statistic takes a data-parallel `group` (`parallel.collectives`;
None in one process): its means, the averaged distribution, the bit rates
and correlations are then the global batch's, and each rank's backward
flows into its own rows.

The entropy terms at beta = 100 cancel two large logits against each other,
so their products must be true f32: they are written as broadcast sums of
`+-x` over the codewords, not as matmuls, so that no TF32 setting can reach
them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from open_genie_tpu_torch.ops.kernels.lfq_entropy import LfqAvgEntropy
from open_genie_tpu_torch.parallel import collectives

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


def lfq_sample_entropy(x: torch.Tensor, beta: float = 100.0, group=None) -> torch.Tensor:
    """Exact per-sample codeword entropy in closed form: the softmax over
    the `2^d` codewords factorizes into `d` Bernoullis with
    `p_i = sigmoid(4 beta x_i)`. Mean over the leading axes (scalar)."""
    a = 4.0 * beta * x.float()
    ent_bits = F.softplus(a) - a * torch.sigmoid(a)
    return collectives.mean(ent_bits.sum(-1), group)


def _signed_sums(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """`(n, m)` f32 products `x . c` for `(n, d)` x and `(m, d)` codewords in
    `{-1, +1}`: a broadcast sum, so true f32 whatever the TF32 settings."""
    return (x.float()[:, None, :] * codes[None]).sum(-1)


def lfq_avg_probs_direct(x: torch.Tensor, beta: float = 100.0, group=None) -> torch.Tensor:
    """Batch-averaged codeword distribution `(2^d,)` of `(n, d)` features,
    through the full `(n, 2^d)` softmax (small codebooks only)."""
    n, d = x.shape
    codes = codebook_entries(torch.arange(2 ** d, device=x.device), d)
    probs = torch.softmax(2.0 * beta * _signed_sums(x, codes), dim=-1)
    return collectives.mean(probs, group, dim=0)


def lfq_avg_entropy(
    x: torch.Tensor, beta: float = 100.0, eps: float = 1e-6, group=None
) -> torch.Tensor:
    """Entropy of the batch-averaged codeword distribution of `(n, d)`
    features (scalar): the direct softmax up to `DIRECT_MAX_CODES` codes,
    `LfqAvgEntropy` (K5/K6, or their plain twins on the CPU) above."""
    d = x.shape[-1]
    if 2 ** d > DIRECT_MAX_CODES:
        return LfqAvgEntropy.apply(x, float(beta), float(eps), group)
    q = lfq_avg_probs_direct(x, beta, group)
    return -(q * torch.log(q.clamp_min(eps))).sum()


def lfq_bit_entropy(x: torch.Tensor, group=None) -> torch.Tensor:
    """Codebook-usage monitor `sum_b H(mean(x_b > 0))` in nats (no
    gradient: the rates are step functions of `x`)."""
    p = collectives.mean((x.reshape(-1, x.shape[-1]) > 0).float(), group, dim=0)
    p = p.clamp(1e-6, 1.0 - 1e-6)
    return -(p * torch.log(p) + (1.0 - p) * torch.log1p(-p)).sum()


def lfq_bit_balance_loss(x: torch.Tensor, eps: float = 1e-12, group=None) -> torch.Tensor:
    """Per-bit balance plus decorrelation of `y = tanh(x / rms(x))`
    (scalar): `mean_b (mean_n y)^2` plus the mean squared off-diagonal
    correlation of `y`."""
    d = x.shape[-1]
    flat = x.reshape(-1, d).float()
    n = flat.shape[0]
    rms = torch.sqrt(collectives.mean(flat * flat, group) + eps)
    y = torch.tanh(flat / rms)
    mean_b = collectives.mean(y, group, dim=0)
    balance = (mean_b ** 2).mean()
    yc = y - mean_b
    # true f32, like HIGHEST
    cov = collectives.global_mean((yc[:, :, None] * yc[:, None, :]).sum(0), n, group)
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
    num_codebooks: int = 1,
    entropy_scale=1.0,
    bit_balance_scale=1.0,
    bit_balance_weight: float = 0.0,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The LFQ training loss of `(..., [c,] d)` pre-quantization features:
    `(loss, aux)`. `quant` is the sign target of the commitment MSE (no
    gradient). The entropy objective is `(sample_entropy -
    diversity_weight * avg_entropy) * entropy_scale`; `frac_sample < 1`
    strides the tokens entering the average entropy. With `num_codebooks >
    1` the average entropy and the bit statistics are taken per
    sub-codebook and averaged. `entropy_scale` and `bit_balance_scale`
    (floats or scalar tensors) scale the objective only: the aux terms stay
    unscaled. With a data-parallel `group`, `x` is this rank's rows of the
    global batch (its leading axes), every term is the global batch's, and
    `frac_sample` strides the global rows.
    """
    d = x.shape[-1]
    flat = x.reshape(-1, d)

    def per_codebook_mean(fn):
        if num_codebooks <= 1:
            return fn(flat)
        per_cb = x.reshape(-1, num_codebooks, d)
        return torch.stack([fn(per_cb[:, c]) for c in range(num_codebooks)]).mean()

    def subsample(v):
        if frac_sample >= 1.0:
            return v
        # Global rows 0, s, ..., (k - 1) s of world x n; this rank holds
        # rows [first, first + n).
        n = v.shape[0]
        n_all = n * collectives.world_size(group)
        k = max(1, int(n_all * frac_sample))
        stride = max(1, n_all // k)
        first = collectives.rank(group) * n
        return v[(-first) % stride: max(0, (k - 1) * stride - first + 1): stride]

    sample_ent = lfq_sample_entropy(flat, beta, group)
    commit_loss = collectives.mean((x.float() - quant.float().detach()) ** 2, group)
    loss = commit_weight * commit_loss
    aux = {
        "sample_entropy": sample_ent,
        "commit_loss": commit_loss,
        "bit_entropy": per_codebook_mean(lambda v: lfq_bit_entropy(v, group)),
    }
    if entropy_weight != 0.0:
        avg_ent = per_codebook_mean(lambda v: lfq_avg_entropy(subsample(v), beta, group=group))
        loss = loss + entropy_weight * ((sample_ent - diversity_weight * avg_ent) * entropy_scale)
        aux["avg_entropy"] = avg_ent
    if bit_balance_weight != 0.0:
        bal = per_codebook_mean(lambda v: lfq_bit_balance_loss(v, group=group))
        loss = loss + bit_balance_weight * bal * bit_balance_scale
        aux["bit_balance"] = bal
    return loss, aux
