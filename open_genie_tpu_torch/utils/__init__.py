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


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn from `generator` in a fixed order.

    Dense and conv weights are normal with std `fan_in ** -0.5` (the JAX
    package's lecun-normal, untruncated), embeddings standard normal, norm
    scales one, biases zero. Used where no trained checkpoint exists (the
    chip smoke run); parity tests load JAX weights through `bridge.py`.
    """
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv3d)):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(
                torch.randn(mod.weight.shape, generator=generator) * fan_in ** -0.5
            )
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
