"""Kernel K1: flash-attention forward (`csrc/flash_attention.cu`).

Replaces `open_genie_tpu/ops/pallas/flash_attention.py::_fwd_kernel`. The
wrapper dispatches by device: a CPU tensor goes to the plain PyTorch twin,
a CUDA tensor launches the kernel (or raises), any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from open_genie_tpu_torch.ops import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_BLOCK_M = 64  # query rows per thread block (grid y <= 65535 tiles)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The direct softmax in f32: `(o, lse)` for `(BH, N, D)` inputs."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention takes (BH, N, D) q, k, v of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(
            f"flash_attention takes float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    bh, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if bh < 1 or n < 1 or -(-n // _BLOCK_M) > 65535 or bh > 2 ** 31 - 1:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over contiguous `(BH, N, D)` tensors -> `(o, lse)`.

    `o` has the input dtype, `lse` is float32 `(BH, N)`. With `causal`,
    query i attends to keys `<= i`. Ragged N needs no padding.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    bh, n, d = q.shape
    lib = kernels.library()
    o = torch.empty_like(q)
    lse = torch.empty(bh, n, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, n, d, _DTYPES[q.dtype], float(scale),
            int(causal), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
