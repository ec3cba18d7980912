"""Kernel K2: fused tokenizer head, 1x1 conv + LFQ sign and index (`csrc/lfq_head.cu`).

Replaces `open_genie_tpu/ops/pallas/lfq_head.py::_head_kernel`. The wrapper
dispatches by device: a CPU tensor goes to the plain PyTorch twin, a CUDA
tensor launches the kernel (or raises), any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from open_genie_tpu_torch.ops import kernels
from open_genie_tpu_torch.ops.lfq import pack_bits

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_FLOATS = 232448 // 4  # W and b live in one block's shared memory


def lfq_head_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`z = x @ w + b` in f32, codes `where(z > 0, 1, -1)` in x's dtype,
    and the MSB-first int32 index."""
    z = x.float() @ w.float() + b.float()
    pos = z > 0
    return torch.where(pos, 1.0, -1.0).to(x.dtype), pack_bits(pos)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(
            f"lfq_head takes x (N, C), w (C, d), b (d,), got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}"
        )
    n, c = x.shape
    d = w.shape[1]
    if w.shape[0] != c or b.shape[0] != d:
        raise ValueError(
            f"lfq_head: w {tuple(w.shape)} / b {tuple(b.shape)} do not fit "
            f"x {tuple(x.shape)}"
        )
    if not 1 <= d <= 31:
        raise ValueError(f"lfq_head packs at most 31 bits into int32, got d={d}")
    if n < 1 or c * d + d > _SMEM_FLOATS:
        raise ValueError(f"lfq_head: unsupported shape N={n}, C={c}, d={d}")
    if x.dtype not in _DTYPES or not (w.is_floating_point() and b.is_floating_point()):
        raise ValueError(f"lfq_head takes float32 or bfloat16 x, got {x.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError("lfq_head: x, w, b on different devices")
    if not x.is_contiguous():
        raise ValueError("lfq_head takes a contiguous x")


def lfq_head(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused projection + LFQ: `(codes (N, d), idx (N,) int32)` for x `(N, C)`."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return lfq_head_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"lfq_head: no kernel for device {x.device}")
    n, c = x.shape
    d = w.shape[1]
    lib = kernels.library()
    # The kernel stages W (at its strides) and b as f32 from f32 or bf16.
    w = w if w.dtype in _DTYPES else w.float()
    b = (b if b.dtype in _DTYPES else b.float()).contiguous()
    codes = torch.empty(n, d, dtype=x.dtype, device=x.device)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lfq_head(
            x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1), _DTYPES[w.dtype],
            b.data_ptr(), _DTYPES[b.dtype], codes.data_ptr(), idx.data_ptr(), n, c, d,
            _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "lfq_head")
    lfq_head.launches += 1
    return codes, idx


lfq_head.launches = 0
