"""Kernels K5 and K6: the LFQ diversity entropy over all 2^d codewords and
its gradient (`csrc/lfq_entropy.cu`).

K5 replaces `open_genie_tpu/ops/pallas/lfq_entropy.py::_fwd_kernel`
(`_avg_probs_fwd`): the batch-averaged codeword distribution
`q_j = mean_b p_bj`, `p_bj = exp(2 beta <x_b, c_j> - logZ_b)`. K6 replaces
`_bwd_kernel` (`_grad_x`): `2 beta (tanh(2 beta x_bi) S_b - T_bi)` with
`S_b = sum_j p_bj w_j` and `T_bi = sum_j p_bj w_j c_ji`. Codeword j has
feature 0 as its most significant bit. `LfqAvgEntropy` ties them into one
`torch.autograd.Function` (the JAX package's `custom_vjp`).

Both work from per-token terms written so that nothing cancels. With
`a = 2 beta x` and `s_bi = +1` iff `x_bi > 0` (the index's bit convention),

    log p_bj = -sum_{i: c_ji != s_bi} 2|a_bi| - sum_i log1p(exp(-2|a_bi|)),

the closed-form `logZ_b = sum_i |a_bi| + log1p(exp(-2|a_bi|))` already
subtracted term by term: every term is non-positive. The Pallas kernels form
`2 beta <x, c>` and `logZ` apart, both thousands at beta = 100, and need f32
HIGHEST dot products to keep their difference. Likewise
`tanh(a_bi) - c_ji` is `s_bi (1 + t)` where bit i mismatches and
`-s_bi (1 - t)` where it matches (`t = tanh|a_bi|`, `1 - t = 2e / (1 + e)`,
`e = exp(-2|a_bi|)`), so K6 sums `p_bj w_j` per bit over the codes with the
bit set (`P`) and clear (`N`) and never subtracts `T` from `tanh(a) S`.

Each wrapper dispatches by device: a CPU tensor goes to the plain PyTorch
twin, a CUDA tensor launches the kernel (or raises), any other device
raises. The twins are the kernels' algorithm chunked over the codebook in
true f32 (broadcast sums, no matmul, so no TF32 setting reaches them).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from open_genie_tpu_torch.ops import kernels

KERNEL_BITS = (13, 18)  # the codebooks of the tokenizer configurations (LFQ_ENTROPY_BITS)
_CHUNK = 4096  # codes per step of the plain twins
_BWD_TOKENS = 128  # tokens per K6 block (csrc/lfq_entropy.cu kBwdThreads)
_BWD_CODES = 256  # codes K6 stages per pass (kBwdCodes)


def token_terms(x: torch.Tensor, beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token terms of `(n, d)` features: `(pos, two_abs, rest)` with
    `pos = x > 0`, `two_abs = 2|2 beta x|` and `rest_b = sum_i
    log1p(exp(-two_abs_bi))`, so that `logZ_b = sum_i two_abs_bi / 2 +
    rest_b` (the JAX package's `_log_normalizer`)."""
    xf = x.float()
    two_abs = (4.0 * beta) * xf.abs()
    return xf > 0, two_abs, torch.log1p(torch.exp(-two_abs)).sum(-1)


def _code_bits(start: int, count: int, d: int, device) -> torch.Tensor:
    """`(count, d)` bool: bit i of codes `start ...`, MSB first (c = +1)."""
    j = torch.arange(start, start + count, device=device, dtype=torch.int64)
    shifts = torch.arange(d - 1, -1, -1, device=device)
    return ((j[:, None] >> shifts) & 1).bool()


def _chunk_log_p(pos, two_abs, rest, bits) -> torch.Tensor:
    """`(n, chunk)` log p of the codes `bits` from the per-token terms."""
    mism = bits[None] != pos[:, None]
    return -torch.where(mism, two_abs[:, None], 0.0).sum(-1) - rest[:, None]


def avg_probs_plain(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Plain twin of K5: `(2^d,)` f32 `q` of `(n, d)` features."""
    n, d = x.shape
    pos, two_abs, rest = token_terms(x, beta)
    num_codes = 2 ** d
    chunk = min(_CHUNK, num_codes)
    q = torch.empty(num_codes, dtype=torch.float32, device=x.device)
    for start in range(0, num_codes, chunk):
        bits = _code_bits(start, chunk, d, x.device)
        q[start:start + chunk] = torch.exp(_chunk_log_p(pos, two_abs, rest, bits)).sum(0) / n
    return q


def entropy_grad_plain(x: torch.Tensor, w: torch.Tensor, beta: float) -> torch.Tensor:
    """Plain twin of K6: `(n, d)` f32 `2 beta (tanh(2 beta x) S - T)` for
    `(n, d)` features and `(2^d,)` weights `w`."""
    n, d = x.shape
    pos, two_abs, rest = token_terms(x, beta)
    num_codes = 2 ** d
    chunk = min(_CHUNK, num_codes)
    p_sum = torch.zeros(n, d, device=x.device)  # over codes with bit i set
    n_sum = torch.zeros(n, d, device=x.device)  # over codes with bit i clear
    for start in range(0, num_codes, chunk):
        bits = _code_bits(start, chunk, d, x.device)
        pw = torch.exp(_chunk_log_p(pos, two_abs, rest, bits)) * w[start:start + chunk].float()
        p_sum += torch.where(bits[None], pw[:, :, None], 0.0).sum(1)
        n_sum += torch.where(bits[None], 0.0, pw[:, :, None]).sum(1)
    return 2.0 * beta * _combine(pos, two_abs, p_sum, n_sum)


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
    if x.shape[1] not in KERNEL_BITS:
        raise ValueError(
            f"{name}: the kernel takes d in {KERNEL_BITS}, got d={x.shape[1]}")
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
    q = torch.empty(2 ** d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lfq_entropy_fwd(
            xf.data_ptr(), q.data_ptr(), n, d, float(beta),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "lfq_entropy_fwd")
    lfq_avg_probs.launches += 1
    return q


lfq_avg_probs.launches = 0


def grad_splits(n: int, d: int, sms: int) -> int:
    """Code splits of K6: a power of two, so that the grid of token tiles x
    splits fills about four blocks per SM while every split keeps at least
    one staged pass of codes."""
    tiles = -(-n // _BWD_TOKENS)
    splits = 1
    while tiles * splits * 2 <= 4 * sms and (2 ** d) // (splits * 2) >= _BWD_CODES:
        splits *= 2
    return splits


def lfq_entropy_grad(x: torch.Tensor, w: torch.Tensor, beta: float) -> torch.Tensor:
    """Kernel K6: `(n, d)` f32 `2 beta (tanh(2 beta x) S - T)` for `(n, d)`
    features and `(2^d,)` f32 code weights `w`. Partial sums per code split
    are reduced in a fixed order, so two calls agree bit for bit."""
    _check(x, "lfq_entropy_grad")
    n, d = x.shape
    if w.shape != (2 ** d,) or w.device != x.device:
        raise ValueError(f"lfq_entropy_grad takes w of shape ({2 ** d},) on x's device")
    if not _on_cuda(x, "lfq_entropy_grad"):
        return entropy_grad_plain(x, w, beta)
    lib = kernels.library()
    xf, wf = x.float().contiguous(), w.float().contiguous()
    splits = grad_splits(n, d, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty(splits, n, 2 * d, dtype=torch.float32, device=x.device)
    dx = torch.empty(n, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lfq_entropy_bwd(
            xf.data_ptr(), wf.data_ptr(), part.data_ptr(), dx.data_ptr(), n, d,
            float(beta), splits, torch.cuda.current_stream().cuda_stream,
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
    CPU). Saves only `x` and `q`."""

    @staticmethod
    def forward(ctx, x, beta: float, eps: float):
        q = lfq_avg_probs(x, beta)
        ctx.save_for_backward(x, q)
        ctx.beta, ctx.eps = beta, eps
        return entropy_of(q, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, q = ctx.saved_tensors
        eps = ctx.eps
        # dH/dq_j = -w_j: 1 + log q_j above the clamp, log(eps) below it
        # (the clamped log passes no gradient).
        w = torch.where(q > eps, 1.0 + torch.log(q.clamp_min(eps)), math.log(eps))
        dx = lfq_entropy_grad(x, w, ctx.beta) / x.shape[0]
        return (g * dx).to(x.dtype), None, None
