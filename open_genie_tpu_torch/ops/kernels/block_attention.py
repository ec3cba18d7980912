"""Kernel K9: grouped-query attention of one block of queries over a
cached key/value prefix (CUDA, `csrc/block_attention.cu`, one launch a
call).

Replaces no TPU kernel: the JAX package has no grouped-query attention.
A refinement or a commit of block diffusion (`modules/attention.py::
BlockCausalAttention`) has `N` query tokens (one block) that all see the
same keys, the cache's `[0, end)`. A block of the kernel takes one (row,
key/value head): the `G = n_head / n_kv_head` query heads that share that
head, `G x N` query rows (16 a warp, zero-padded, at most 64), and walks
the keys in tiles of 64 on the tensor cores, with an online softmax in f32
and the probabilities rounded to bf16 before the value product, as flash
attention does. Each key and value of the prefix is read once, from the
bf16 cache as it lies (no copy, no cast of the cache); the work is bound
by those bytes.

The wrapper dispatches by device: a CPU tensor goes to the plain twin
(SDPA's grouped-query path), a CUDA tensor launches the kernel (built at
first use, never at import), any other device raises. It counts its
launches in `launches`, and by `(B, n_head, n_kv_head, N, D)` in
`launches_by_shape`.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from open_genie_tpu_torch.ops import kernels

HEADS = (16, 32, 64, 128)  # head sizes the kernel takes
MAX_ROWS = 64  # query rows of a block: G x N


def block_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          end: int, scale: float) -> torch.Tensor:
    """`block_attention` in plain PyTorch (SDPA's grouped-query path)."""
    k, v = k_cache[:, :, :end], v_cache[:, :, :end]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k, v, scale=scale, enable_gqa=True)
    return out.transpose(1, 2)


def _check(q, k_cache, v_cache, end) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"block_attention takes q (B, N, n_head, D) and caches (B, n_kv_head, "
                         f"T, D) of one shape; got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, n, nq, d = q.shape
    bk, nk, t, dk = k_cache.shape
    if bk != b or dk != d or nq % nk or not (n <= end <= t):
        raise ValueError(f"block_attention: q {tuple(q.shape)} and caches {tuple(k_cache.shape)} "
                         f"do not fit, or end {end} is outside [{n}, {t}]")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"block_attention takes q and caches of one dtype, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("block_attention: q and caches on different devices")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()
            and q.stride(3) == 1 and q.stride(2) == d):
        raise ValueError("block_attention takes contiguous caches and q with contiguous heads")


def block_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, end: int,
                    scale: float) -> torch.Tensor:
    """Attention of `q` `(B, N, n_head, D)` (one block of `N` query tokens
    of each row) over keys and values `[0, end)` of the caches `(B,
    n_kv_head, T, D)`, query head `i` reading key/value head `i // (n_head
    / n_kv_head)`: `(B, N, n_head, D)` in q's dtype. q may be a view whose
    heads are contiguous (a slice of the fused projection's heads)."""
    _check(q, k_cache, v_cache, end)
    if q.device.type == "cpu":
        return block_attention_plain(q, k_cache, v_cache, end, scale)
    if q.device.type != "cuda":
        raise ValueError(f"block_attention: no kernel for device {q.device}")
    b, n, nq, d = q.shape
    nk, t = k_cache.shape[1], k_cache.shape[2]
    if q.dtype != torch.bfloat16 or d not in HEADS or nq // nk * n > MAX_ROWS:
        raise ValueError(f"block_attention's kernel takes bfloat16, a head of {HEADS} and at "
                         f"most {MAX_ROWS} query rows a key/value head, got {q.dtype}, {d}, "
                         f"{nq // nk * n}")
    if q.stride(0) % 8 or q.stride(1) % 8 or any(
            x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("block_attention's kernel takes q, k and v rows aligned to 16 bytes")
    out = torch.empty(b, n, nq, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().block_attention(
            q.data_ptr(), q.stride(0), q.stride(1), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), b, n, nq, nk, t, end, d, scale,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "block_attention")
    block_attention.launches += 1
    block_attention.launches_by_shape[(b, nq, nk, n, d)] += 1
    return out


block_attention.launches = 0
block_attention.launches_by_shape = Counter()
