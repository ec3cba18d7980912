"""Weights from the seed, made on the device in one draw.

`make(specs, seed, device, dtype)` fills every `("normal", std)` parameter
from a single `torch.randn` of all their elements on `device` (scaled per
parameter) and every `("const", v)` one with `v`, in `dtype`. The same
seed on the same kind of device gives the same values, so the program and
the plain reference get the same weights without either making them.
"""
from __future__ import annotations

import math

import torch


def make(specs: dict, seed: int, device, dtype=torch.float32) -> dict:
    total = sum(math.prod(shape) for shape, (kind, _) in specs.values() if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, (kind, value)) in specs.items():
        n = math.prod(shape)
        if kind == "normal":
            out[name] = (flat[at: at + n].view(shape) * value).to(dtype)
            at += n
        else:
            out[name] = torch.full(shape, value, device=device, dtype=dtype)
    return out


def load_into(module: torch.nn.Module, values: dict, unused_prefixes=()) -> None:
    """Copy `values` into `module`'s parameters by name. Every parameter
    must be given, except those under `unused_prefixes` (parts the cell's
    path never runs), which are zeroed; a value the module lacks, or of
    another shape, raises."""
    params = dict(module.named_parameters())
    extra = sorted(set(values) - set(params))
    missing = sorted(n for n in set(params) - set(values)
                     if not n.startswith(tuple(unused_prefixes)))
    if extra or missing:
        raise KeyError(f"weights do not fit the model: extra {extra[:5]}, missing {missing[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if name in values:
                if tuple(p.shape) != tuple(values[name].shape):
                    raise ValueError(f"{name}: model {tuple(p.shape)}, weights "
                                     f"{tuple(values[name].shape)}")
                p.copy_(values[name])
            else:
                p.zero_()
