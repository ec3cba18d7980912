"""Kernel K7: one MaskGIT refinement's commit after the noise draw
(`csrc/maskgit_sample.cu`).

Replaces no TPU kernel: XLA fuses the JAX package's sampler. From the
logits, the noise (the uniform draw or Gumbel values) and the frame's mask
and code it gives the new mask and code, each position's token `pred` and
its confidence `conf`, in one read of the logits and the noise. The
wrapper dispatches by device: a CPU tensor goes to the plain PyTorch twin,
a CUDA tensor launches the kernel pair (or raises), any other device
raises. The kernel loads 4 elements at once, so it takes V a multiple of 4
and rows aligned to such a load (every configuration's V is a power of 2);
the wrapper refuses the rest on the card. It counts its kernel launches
(two a call) in `launches`, and by `(B, HW, V)` in `launches_by_shape`.
"""
from __future__ import annotations

from collections import Counter
from functools import lru_cache
from typing import Tuple

import torch

from open_genie_tpu_torch.ops import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_DTYPES = {torch.int32: 0, torch.int64: 1}
THREADS = 256  # a partial block's threads
VEC = 4  # elements a thread loads at once
BLOCKS_PER_SM = 8  # partial blocks resident on an SM
WAVES = 4  # waves of partial blocks that the splits aim for


def splits(rows: int, v: int, sms: int) -> int:
    """Splits of the vocabulary a row takes in the partial kernel: enough
    that `rows * splits` blocks fill the `sms` SMs `WAVES` times, but each
    split at least VEC elements for every thread of its block, so one at
    small V."""
    want = -(-WAVES * BLOCKS_PER_SM * sms // rows)
    return max(1, min(want, v // (VEC * THREADS)))


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1), rounded to bf16 (the
    JAX package draws it in bf16), as float32."""
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(torch.bfloat16).float()


def maskgit_sample_plain(
    logits: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor, code: torch.Tensor,
    num_tokens: int, temp: float = 1.0, uniform: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`maskgit_sample` in plain PyTorch: `(mask, code, pred, conf)`."""
    hw = logits.shape[1]
    logits = logits.float() / temp
    gumbel = gumbel_of_uniform(noise) if uniform else noise.float()
    pred = torch.argmax(logits + gumbel, dim=-1)  # (B, HW)
    logp = torch.gather(logits, -1, pred[..., None])[..., 0]
    conf = logp - torch.logsumexp(logits, dim=-1)
    conf = conf.masked_fill(~mask, float("-inf"))

    sorted_conf = torch.sort(conf, dim=-1, descending=True).values
    idx = min(max(int(num_tokens) - 1, 0), hw - 1)
    thr = sorted_conf[:, idx: idx + 1]  # the num_tokens-th best per row
    commit = (conf >= thr) & mask
    code = torch.where(commit, pred.to(code.dtype), code)
    return mask & ~commit, code, pred, conf


def _check(logits, noise, mask, code, uniform: bool) -> None:
    if logits.dim() != 3 or noise.shape != logits.shape:
        raise ValueError(
            f"maskgit_sample takes logits and noise (B, HW, V) of one shape, got "
            f"{tuple(logits.shape)}, {tuple(noise.shape)}")
    b, hw, v = logits.shape
    if mask.shape != (b, hw) or code.shape != (b, hw):
        raise ValueError(
            f"maskgit_sample: mask {tuple(mask.shape)} / code {tuple(code.shape)} do not fit "
            f"logits {tuple(logits.shape)}")
    if b * hw * v == 0 or v >= 2 ** 31:
        raise ValueError(f"maskgit_sample: unsupported shape {tuple(logits.shape)}")
    if logits.dtype not in _DTYPES or noise.dtype not in _DTYPES:
        raise ValueError(
            f"maskgit_sample takes float32 or bfloat16 logits and noise, got {logits.dtype}, "
            f"{noise.dtype}")
    if uniform and noise.dtype != torch.float32:
        raise ValueError(f"maskgit_sample takes uniforms in float32, got {noise.dtype}")
    if mask.dtype != torch.bool or code.dtype not in _CODE_DTYPES:
        raise ValueError(
            f"maskgit_sample takes a bool mask and an int32 or int64 code, got {mask.dtype}, "
            f"{code.dtype}")
    if not (logits.device == noise.device == mask.device == code.device):
        raise ValueError("maskgit_sample: logits, noise, mask, code on different devices")
    if not all(t.is_contiguous() for t in (logits, noise, mask, code)):
        raise ValueError("maskgit_sample takes contiguous logits, noise, mask and code")


def _check_layout(logits: torch.Tensor, noise: torch.Tensor) -> None:
    """What the kernel's loads need: V a multiple of VEC, and the logits
    and the noise aligned to a VEC-element load."""
    v = logits.shape[-1]
    if v % VEC:
        raise ValueError(f"maskgit_sample's kernel takes V a multiple of {VEC}, got {v}")
    for name, t in (("logits", logits), ("noise", noise)):
        if t.data_ptr() % (VEC * t.element_size()):
            raise ValueError(
                f"maskgit_sample's kernel takes {name} aligned to {VEC * t.element_size()} "
                f"bytes")


def maskgit_sample(
    logits: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor, code: torch.Tensor,
    num_tokens: int, temp: float = 1.0, uniform: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MaskGIT commit after the draw: `(mask, code, pred, conf)`.

    `logits` `(B, HW, V)` float32 or bfloat16, divided by `temp` in f32;
    `noise` of the same shape, uniforms in [0, 1) in float32 that become
    bf16-rounded Gumbel noise (`uniform`), or the Gumbel noise itself in
    float32 or bfloat16; `mask` `(B, HW)` bool, True = still masked;
    `code` `(B, HW)` int32 or int64. `pred` `(B, HW)` int64 is each
    position's argmax of logits / temp + noise, `conf` its log-probability,
    -inf where no longer masked; the `num_tokens` most confident masked
    positions of each row commit `pred` (both, on an exact tie at the
    threshold)."""
    _check(logits, noise, mask, code, uniform)
    if logits.device.type == "cpu":
        return maskgit_sample_plain(logits, noise, mask, code, num_tokens, temp, uniform)
    if logits.device.type != "cuda":
        raise ValueError(f"maskgit_sample: no kernel for device {logits.device}")
    _check_layout(logits, noise)
    b, hw, v = logits.shape
    dev = logits.device
    s = splits(b * hw, v, _sms(dev.index))
    lib = kernels.library()
    part = torch.empty(b * hw * s * 5, dtype=torch.float32, device=dev)
    mask_out, code_out = torch.empty_like(mask), torch.empty_like(code)
    pred = torch.empty(b, hw, dtype=torch.int64, device=dev)
    conf = torch.empty(b, hw, dtype=torch.float32, device=dev)
    noise_kind = 0 if uniform else 1 + _DTYPES[noise.dtype]
    num_tokens = min(max(int(num_tokens), 0), hw)  # the same threshold, in an int32
    with torch.cuda.device(dev):
        err = lib.maskgit_sample(
            logits.data_ptr(), _DTYPES[logits.dtype], noise.data_ptr(), noise_kind, temp,
            b, hw, v, s, part.data_ptr(), mask.data_ptr(), code.data_ptr(),
            _CODE_DTYPES[code.dtype], num_tokens, mask_out.data_ptr(), code_out.data_ptr(),
            pred.data_ptr(), conf.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "maskgit_sample")
    maskgit_sample.launches += 2
    maskgit_sample.launches_by_shape[(b, hw, v)] += 2
    return mask_out, code_out, pred, conf


maskgit_sample.launches = 0
maskgit_sample.launches_by_shape = Counter()
