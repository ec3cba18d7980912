"""Small shared helpers (copies of `open_genie_tpu.utils`, jax-free)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, TypeVar, Union

import torch
from torch import nn

T = TypeVar("T")
D = TypeVar("D")

# A blueprint is a sequence of module names or (name, kwargs) pairs.
Blueprint = Sequence[Union[str, Tuple[str, Dict[str, Any]]]]


def default(var: Optional[T], val: D) -> Union[T, D]:
    return var if var is not None else val


def cast_tuple(val, length: int) -> tuple:
    """Broadcast a scalar to a tuple of `length`, pass tuples through."""
    if isinstance(val, (tuple, list)):
        out = tuple(val)
        assert len(out) == length, f"expected length-{length} tuple, got {out}"
        return out
    return (val,) * length


def enlarge_as(src: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """`src` with singleton axes appended on the right up to `other`'s rank."""
    return src.reshape(*src.shape, *(1,) * (other.dim() - src.dim()))


def enc2dec_name(name: str) -> str:
    return name.replace("downsample", "upsample")


def to_channels_last(video: torch.Tensor) -> torch.Tensor:
    """`(B, C, T, H, W)` -> `(B, T, H, W, C)`."""
    return video.permute(0, 2, 3, 4, 1)


def to_channels_first(video: torch.Tensor) -> torch.Tensor:
    """`(B, T, H, W, C)` -> `(B, C, T, H, W)`."""
    return video.permute(0, 4, 1, 2, 3)


def last_out_channels(blueprint: Blueprint) -> Optional[int]:
    """Last explicit output width in a blueprint (an encoder's output)."""
    out = None
    for desc in blueprint:
        if isinstance(desc, str):
            continue
        for key in ("out_channels", "n_embd", "d_out"):
            if desc[1].get(key) is not None:
                out = desc[1][key]
    return out


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn from `generator` in a fixed order.

    Dense and conv weights are normal with std `fan_in ** -0.5` (the JAX
    package's lecun-normal, untruncated), embeddings standard normal, norm
    scales one, biases zero. A Linear with a `const_init` attribute
    `(weight, bias)` is filled with those constants and draws nothing
    (`AdaptiveGroupNorm`'s heads). Used where no trained checkpoint exists
    (the chip smoke run); parity tests load JAX weights through `bridge.py`.
    """
    for mod in module.modules():
        const = getattr(mod, "const_init", None)
        if const is not None:
            mod.weight.fill_(const[0])
            mod.bias.fill_(const[1])
            continue
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            w = mod.weight  # a transposed conv's is (I, O, *k): fan-in I * k
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(
                mod, nn.ConvTranspose3d) else w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            nn.init.zeros_(mod.bias)
    return module


def module_dtype(module: nn.Module) -> torch.dtype:
    """Dtype of a module's first parameter (its compute dtype)."""
    return next(module.parameters()).dtype


def pick_frames(video: torch.Tensor, frame_idxs: torch.Tensor) -> torch.Tensor:
    """`(B * K, H, W, C)` frames of a `(B, T, H, W, C)` video picked by
    `(B, K)` indices, batch-major."""
    b, k = frame_idxs.shape
    rows = torch.arange(b, device=video.device).repeat_interleave(k)
    return video[rows, frame_idxs.reshape(-1).to(video.device)]


def random_frame_idxs(generator: torch.Generator, batch: int, t: int, k: int,
                      device=None) -> torch.Tensor:
    """`(batch, k)` distinct frame indices per batch element, drawn from
    `generator` (on its device), placed on `device`."""
    idxs = [torch.randperm(t, generator=generator, device=generator.device)[:k]
            for _ in range(batch)]
    return torch.stack(idxs).to(device)
