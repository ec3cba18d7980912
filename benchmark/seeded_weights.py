"""Weights from the seed, drawn one parameter at a time on the device.

For a model too large for `weights.make`'s single float32 draw of every
element (30.5 B parameters would take 122 GB). Parameter `name` of shape
`shape` and spec `("normal", std)` is `torch.randn(shape) * std` from a
generator seeded by `param_seed(seed, name)`, drawn in float32 on the
device and rounded to the model's dtype; `("const", v)` is `v`. So any one
parameter can be drawn again alone, as the plain reference does, layer by
layer, and the same seed on the same kind of device gives the same values.
"""
from __future__ import annotations

import zlib

import torch

_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: seeds of nearby runs stay apart


def param_seed(seed: int, name: str) -> int:
    """A generator seed for parameter `name` of run `seed`."""
    return (seed * _MIX + zlib.crc32(name.encode())) % 2 ** 63


def draw(name: str, spec: tuple, seed: int, device, dtype) -> torch.Tensor:
    """Parameter `name` as `spec` (`(shape, (kind, value))`) gives it."""
    shape, (kind, value) = spec
    if kind == "const":
        return torch.full(shape, float(value), device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(param_seed(seed, name))
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            * value).to(dtype)


def fill(module: torch.nn.Module, specs: dict, seed: int) -> None:
    """Draw every parameter of `module` (already on its device and in its
    dtype) in place; `specs` must name exactly its parameters."""
    params = dict(module.named_parameters())
    if set(params) != set(specs):
        raise KeyError(f"weights do not fit the model: extra {sorted(set(specs) - set(params))[:5]}"
                       f", missing {sorted(set(params) - set(specs))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(specs[name][0]):
                raise ValueError(f"{name}: model {tuple(p.shape)}, spec {specs[name][0]}")
            p.copy_(draw(name, specs[name], seed, p.device, p.dtype))
