"""Kernels K1, K3 and K4: flash attention, forward and backward.

K1 replaces `open_genie_tpu/ops/pallas/flash_attention.py::_fwd_kernel`,
K3 `_bwd_dkv_kernel` and K4 `_bwd_dq_kernel`. Each wrapper dispatches by
device: a CPU tensor goes to the plain PyTorch twin, a CUDA tensor launches
the kernel (or raises), any other device raises.

Each has two variants, chosen by `flash_variant` from the dtype before
launch: bf16 runs on the tensor cores ("mma", `csrc/flash_attention_mma.cu`,
`csrc/flash_attention_bwd_mma.cu`, `csrc/flash_attention_bwd_dq_mma.cu`),
f32 on the CUDA cores with true f32 products ("simt",
`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`). Each wrapper
counts its launches in `launches`, by variant in `launches_by_variant` and
by `(BH, N, D, causal)` in `launches_by_shape`.

`FlashAttention` ties them into one `torch.autograd.Function` (the JAX
package's `custom_vjp`): the forward is K1 and saves only
`q, k, v, o, lse`, so the residuals stay O(N); the backward computes
`delta = rowsum(dO * o)` and runs K3 (dk, dv), then K4 (dq).
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from open_genie_tpu_torch.ops import kernels

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = ("mma", "simt")
_BLOCK_M = 64  # rows per block of the CUDA-core kernels (grid y <= 65535 tiles)
_NEG_BIG = -1e30  # the Pallas kernels' masked logit


def flash_variant(dtype: torch.dtype, d: int) -> str:
    """The variant of K1, K3 and K4 that takes `(BH, N, d)` tensors of `dtype`:
    "mma" (tensor cores) for bfloat16, "simt" (CUDA cores, true f32
    products) for float32. Raises for any other dtype or head dim."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "simt"
    raise ValueError(f"flash_attention takes float32 or bfloat16, got {dtype}")


def _count(fn, variant: str, q: torch.Tensor, causal: bool) -> None:
    fn.launches += 1
    fn.launches_by_variant[variant] += 1
    fn.launches_by_shape[(*q.shape, bool(causal))] += 1


def _aligned(*ts: torch.Tensor) -> None:
    """The tensor-core kernels copy rows in 16-byte pieces."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention: the bf16 kernels take 16-byte aligned tensors")


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


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: float, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit flash-attention gradient in f32: `(dq, dk, dv)` in q's
    dtype. `p` is rounded to dO's dtype before `pT dO` and `ds` to q's
    dtype before its two products, as the kernels do."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_BIG)
    p = torch.exp(s - lse[..., None])
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(q.dtype).float()
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention takes (BH, N, D) q, k, v of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(
            f"flash_attention takes float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    bh, n, d = q.shape
    flash_variant(q.dtype, d)
    if bh < 1 or n < 1 or -(-n // _BLOCK_M) > 65535 or bh > 2 ** 31 - 1:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over contiguous `(BH, N, D)` tensors -> `(o, lse)`.

    `o` has the input dtype, `lse` is float32 `(BH, N)`. With `causal`,
    query i attends to keys `<= i`. Ragged N needs no padding. Not
    differentiable: `FlashAttention` is.
    """
    _check(q, k, v)
    if not _on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, scale, causal)
    bh, n, d = q.shape
    variant = flash_variant(q.dtype, d)
    lib = kernels.library()
    o = torch.empty_like(q)
    lse = torch.empty(bh, n, dtype=torch.float32, device=q.device)
    entry = lib.flash_attention_fwd
    if variant == "mma":
        _aligned(q, k, v)
        entry = lib.flash_attention_fwd_mma
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, n, d, float(scale), int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, f"flash_attention_fwd ({variant})")
    _count(flash_attention, variant, q, causal)
    return o, lse


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention.launches_by_shape = Counter()


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(
            f"flash_attention backward takes a contiguous dO like q, got "
            f"{tuple(do.shape)} {do.dtype}"
        )
    for t in (lse, delta):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("flash_attention backward takes contiguous f32 (BH, N) lse, delta")
    if not (q.device == do.device == lse.device == delta.device):
        raise ValueError("flash_attention backward: tensors on different devices")


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 on CUDA tensors: `(dk, dv)` from the saved forward and
    `delta = rowsum(dO * o)` (f32 `(BH, N)`)."""
    _check_bwd(q, k, v, do, lse, delta)
    if not _on_cuda(q, "flash_attention_bwd_dkv"):
        raise ValueError("flash_attention_bwd_dkv launches on CUDA tensors only")
    bh, n, d = q.shape
    variant = flash_variant(q.dtype, d)
    lib = kernels.library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    entry = lib.flash_attention_bwd_dkv
    if variant == "mma":
        _aligned(q, k, v, do)
        entry = lib.flash_attention_bwd_dkv_mma
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, n, d, float(scale), int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, f"flash_attention_bwd_dkv ({variant})")
    _count(flash_attention_bwd_dkv, variant, q, causal)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd_dkv.launches_by_shape = Counter()


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, causal: bool = False,
) -> torch.Tensor:
    """Kernel K4 on CUDA tensors: `dq`, from the same inputs as K3."""
    _check_bwd(q, k, v, do, lse, delta)
    if not _on_cuda(q, "flash_attention_bwd_dq"):
        raise ValueError("flash_attention_bwd_dq launches on CUDA tensors only")
    bh, n, d = q.shape
    variant = flash_variant(q.dtype, d)
    lib = kernels.library()
    dq = torch.empty_like(q)
    entry = lib.flash_attention_bwd_dq
    if variant == "mma":
        _aligned(q, k, v, do)
        entry = lib.flash_attention_bwd_dq_mma
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, n, d, float(scale), int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, f"flash_attention_bwd_dq ({variant})")
    _count(flash_attention_bwd_dq, variant, q, causal)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_variant = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd_dq.launches_by_shape = Counter()


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: float, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`(dq, dk, dv)` of `flash_attention`: K3 then K4 on a CUDA tensor,
    the plain twin on a CPU tensor."""
    if not _on_cuda(q, "flash_attention_bwd"):
        _check(q, k, v)
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale, causal)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over contiguous `(BH, N, D)` tensors;
    returns `o` only."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = flash_attention(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), ctx.scale, ctx.causal
        )
        return dq, dk, dv, None, None


def flash_attention_autograd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = False,
) -> torch.Tensor:
    """`o` of `flash_attention`, through `FlashAttention` when a gradient
    is wanted; otherwise the forward alone, which saves nothing."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, causal)
    return flash_attention(q, k, v, scale, causal)[0]
