"""Kernels K5 and K6: the LFQ diversity entropy over all 2^d codewords and
its gradient (`csrc/lfq_entropy.cu`).

K5 replaces `open_genie_tpu/ops/pallas/lfq_entropy.py::_fwd_kernel`
(`_avg_probs_fwd`): the batch-averaged codeword distribution
`q_j = mean_b p_bj`, `p_bj = exp(2 beta <x_b, c_j> - logZ_b)`. K6 replaces
`_bwd_kernel` (`_grad_x`): `2 beta (tanh(2 beta x_bi) S_b - T_bi)` with
`S_b = sum_j p_bj w_j` and `T_bi = sum_j p_bj w_j c_ji`. Codeword j has
feature 0 as its most significant bit. `LfqAvgEntropy` ties them into one
`torch.autograd.Function` (the JAX package's `custom_vjp`).

Both rest on the factorization of each token's distribution over the bits:
`p_bj = prod_i sigmoid(4 beta x_bi c_ji)` exactly, since `logZ_b` is a sum
over the bits. The d bits split into a high half of `dh = ceil(d/2)` bits
(features `0 .. dh-1`) and a low half of `dl = floor(d/2)`; code
`j = h 2^dl + l` has `p_bj = H_b[h] L_b[l]` with `(n, 2^dh)` and `(n, 2^dl)`
tables (`half_tables`). Then `q = H^T L / n`; and with `W` the weights as a
`(2^dh, 2^dl)` matrix, `G = L W^T` and `F = H W`, the sums of `p_bj w_j`
over the codes with bit i set (`P`) or clear (`N`) are sums over one table
axis of `H G` (high bits) or `L F` (low bits).

Nothing cancels. With `a = 2 beta x` and `s_bi = +1` iff `x_bi > 0` (the
index's bit convention), each table entry is the exp of a sum of
non-positive terms,

    log H_b[h] = -sum_{i high: c_hi != s_bi} 2|a_bi| - sum_{i high} log1p(exp(-2|a_bi|)),

the closed-form `logZ_b = sum_i |a_bi| + log1p(exp(-2|a_bi|))` already
subtracted term by term. The Pallas kernels form `2 beta <x, c>` and `logZ`
apart, both thousands at beta = 100, and need f32 HIGHEST dot products to
keep their difference. Likewise `tanh(a_bi) - c_ji` is `s_bi (1 + t)` where
bit i mismatches and `-s_bi (1 - t)` where it matches (`t = tanh|a_bi|`,
`1 - t = 2e / (1 + e)`, `e = exp(-2|a_bi|)`), so K6 combines `P` and `N`
and never subtracts `T` from `tanh(a) S`.

Each wrapper dispatches by device: a CPU tensor goes to the plain PyTorch
twin, a CUDA tensor launches the kernel (or raises), any other device
raises. The kernels take d from 13 to 24. The twins are the kernels'
algorithm: the same split, the same table terms in f32, the same index
order; their products and per-bit sums run in float64 and are cast back to
f32, so no TF32 setting reaches them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from open_genie_tpu_torch.ops import kernels
from open_genie_tpu_torch.parallel import collectives

MIN_BITS, MAX_BITS = 13, 24  # the kernels' codebooks: 2^13 to 2^24 codes


def token_terms(x: torch.Tensor, beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token terms of `(n, d)` features: `(pos, two_abs, rest)` with
    `pos = x > 0`, `two_abs = 2|2 beta x|` and `rest_b = sum_i
    log1p(exp(-two_abs_bi))`, so that `logZ_b = sum_i two_abs_bi / 2 +
    rest_b` (the JAX package's `_log_normalizer`)."""
    xf = x.float()
    two_abs = (4.0 * beta) * xf.abs()
    return xf > 0, two_abs, torch.log1p(torch.exp(-two_abs)).sum(-1)


def halves(d: int) -> Tuple[int, int]:
    """Bits of the high and the low half of a d-bit code."""
    return (d + 1) // 2, d // 2


def _code_bits(count: int, bits: int, device) -> torch.Tensor:
    """`(count, bits)` bool: the bits of codes `0 .. count-1`, MSB first."""
    j = torch.arange(count, device=device, dtype=torch.int64)
    shifts = torch.arange(bits - 1, -1, -1, device=device)
    return ((j[:, None] >> shifts) & 1).bool()


def half_tables(x: torch.Tensor, beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 tables `(H, L)`, `(n, 2^dh)` and `(n, 2^dl)`, of `(n, d)`
    features: `p_bj = H_b[j >> dl] L_b[j & (2^dl - 1)]`. Each entry is the
    exp of minus its half's mismatched `two_abs` and its half's
    `log1p(exp(-two_abs))` terms (`token_terms`)."""
    dh = halves(x.shape[1])[0]
    pos, two_abs, _ = token_terms(x, beta)
    log_terms = torch.log1p(torch.exp(-two_abs))
    tables = []
    for half in (slice(0, dh), slice(dh, None)):
        p, v = pos[:, half], two_abs[:, half]
        mism = _code_bits(2 ** p.shape[1], p.shape[1], x.device)[None] != p[:, None]
        s = torch.where(mism, v[:, None], 0.0).sum(-1)
        tables.append(torch.exp(-s - log_terms[:, half].sum(-1, keepdim=True)))
    return tables[0], tables[1]


def avg_probs_plain(x: torch.Tensor, beta: float, dtype=torch.float64) -> torch.Tensor:
    """Plain twin of K5: `(2^d,)` f32 `q` of `(n, d)` features, `H^T L / n`
    with the product in `dtype` (float64; float32 only to time the same
    algorithm on stock matmuls)."""
    hi, lo = (t.to(dtype) for t in half_tables(x, beta))
    return (hi.T @ lo / x.shape[0]).float().flatten()


def entropy_grad_plain(x: torch.Tensor, w: torch.Tensor, beta: float,
                       dtype=torch.float64) -> torch.Tensor:
    """Plain twin of K6: `(n, d)` f32 `2 beta (tanh(2 beta x) S - T)` for
    `(n, d)` features and `(2^d,)` weights `w`; the products and per-bit sums
    in `dtype`, as `avg_probs_plain`."""
    dh, dl = halves(x.shape[1])
    pos, two_abs, _ = token_terms(x, beta)
    hi, lo = (t.to(dtype) for t in half_tables(x, beta))
    wm = w.to(dtype).view(2 ** dh, 2 ** dl)
    p_sum, n_sum = [], []
    for table, prod, k in ((hi, lo @ wm.T, dh), (lo, hi @ wm, dl)):  # (H, G), (L, F)
        bits = _code_bits(2 ** k, k, x.device).to(dtype)
        v = table * prod
        p_sum.append(v @ bits)        # over codes with the bit set
        n_sum.append(v @ (1.0 - bits))  # and clear
    return 2.0 * beta * _combine(pos, two_abs, torch.cat(p_sum, -1).float(),
                                 torch.cat(n_sum, -1).float())


def _combine(pos, two_abs, p_sum, n_sum) -> torch.Tensor:
    """`sum_j p_bj w_j (tanh(a_bi) - c_ji)` from the per-bit sums."""
    e = torch.exp(-two_abs)
    t = torch.tanh(two_abs / 2.0)
    match, mismatch = torch.where(pos, p_sum, n_sum), torch.where(pos, n_sum, p_sum)
    r = (1.0 + t) * mismatch - (2.0 * e / (1.0 + e)) * match
    return torch.where(pos, r, -r)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"{name} takes (n, d) features, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16 features, got {x.dtype}")


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if not MIN_BITS <= x.shape[1] <= MAX_BITS:
        raise ValueError(f"{name}: the kernel takes d from {MIN_BITS} to {MAX_BITS} "
                         f"(2^{MAX_BITS} codes at most), got d={x.shape[1]}")
    return True


def lfq_avg_probs(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Kernel K5: the `(2^d,)` f32 batch-averaged codeword distribution of
    `(n, d)` features (bf16 or f32, computed in f32)."""
    _check(x, "lfq_avg_probs")
    if not _on_cuda(x, "lfq_avg_probs"):
        return avg_probs_plain(x, beta)
    n, d = x.shape
    lib = kernels.library()
    xf = x.float().contiguous()
    tables = torch.empty(n * sum(2 ** k for k in halves(d)), dtype=torch.float32,
                         device=x.device)
    q = torch.empty(2 ** d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lfq_entropy_fwd(
            xf.data_ptr(), tables.data_ptr(), q.data_ptr(), n, d, float(beta),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "lfq_entropy_fwd")
    lfq_avg_probs.launches += 1
    return q


lfq_avg_probs.launches = 0


def lfq_entropy_grad(x: torch.Tensor, w: torch.Tensor, beta: float) -> torch.Tensor:
    """Kernel K6: `(n, d)` f32 `2 beta (tanh(2 beta x) S - T)` for `(n, d)`
    features and `(2^d,)` f32 code weights `w`. Every sum runs in a fixed
    order, so two calls agree bit for bit."""
    _check(x, "lfq_entropy_grad")
    n, d = x.shape
    if w.shape != (2 ** d,) or w.device != x.device:
        raise ValueError(f"lfq_entropy_grad takes w of shape ({2 ** d},) on x's device")
    if not _on_cuda(x, "lfq_entropy_grad"):
        return entropy_grad_plain(x, w, beta)
    lib = kernels.library()
    xf, wf = x.float().contiguous(), w.float().contiguous()
    # The tables H and L, then the products G and F.
    scratch = torch.empty(2 * n * sum(2 ** k for k in halves(d)), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty(n, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lfq_entropy_bwd(
            xf.data_ptr(), wf.data_ptr(), scratch.data_ptr(), dx.data_ptr(), n, d,
            float(beta), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "lfq_entropy_bwd")
    lfq_entropy_grad.launches += 1
    return dx


lfq_entropy_grad.launches = 0


def entropy_of(q: torch.Tensor, eps: float) -> torch.Tensor:
    """`-sum_j q_j log(max(q_j, eps))` (scalar)."""
    return -(q * torch.log(q.clamp_min(eps))).sum()


class LfqAvgEntropy(torch.autograd.Function):
    """Entropy of the batch-averaged codeword distribution of `(n, d)`
    features, with K5 forward and K6 backward (their plain twins on the
    CPU). Saves only `x`, `q` and the row count.

    With a data-parallel `group` (`parallel.collectives`), `x` is this
    rank's rows of the global batch: K5's local mean times the local rows
    is all-reduced and divided by the global rows, so every rank takes the
    entropy of the global `q`; the backward all-reduces the cotangent of
    `H` (`collectives.backward` seeds each rank with 1/world) and scales
    K6's gradient, with `w` from that `q`, by it over the global rows:
    `dL/dx` for this rank's rows exactly. A rank may hold no rows (a
    strided subsample can miss its block)."""

    @staticmethod
    def forward(ctx, x, beta: float, eps: float, group=None):
        if not collectives.reduces(group):
            q, rows = lfq_avg_probs(x, beta), x.shape[0]
        else:
            n = x.shape[0]
            local = (lfq_avg_probs(x, beta) * n if n
                     else x.new_zeros(2 ** x.shape[1], dtype=torch.float32))
            total, rows = collectives.global_sums([local, n], group)
            q = total / rows
        ctx.save_for_backward(x, q)
        ctx.beta, ctx.eps, ctx.rows, ctx.group = beta, eps, rows, group
        return entropy_of(q, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, q = ctx.saved_tensors
        eps = ctx.eps
        g = collectives.all_reduce_sum(g, ctx.group)
        if x.shape[0] == 0:
            return torch.zeros_like(x), None, None, None
        # dH/dq_j = -w_j: 1 + log q_j above the clamp, log(eps) below it
        # (the clamped log passes no gradient).
        w = torch.where(q > eps, 1.0 + torch.log(q.clamp_min(eps)), math.log(eps))
        dx = lfq_entropy_grad(x, w, ctx.beta) / ctx.rows
        return (g * dx).to(x.dtype), None, None, None
