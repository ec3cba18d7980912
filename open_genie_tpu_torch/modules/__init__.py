"""Blueprint registry and parser (twin of `open_genie_tpu.modules`).

Only the module names the rollout and the Genie joint training step use are
ported; every other name of the JAX registry raises an error saying so.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple, Type

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from open_genie_tpu_torch.modules.attention import SpaceTimeAttention
from open_genie_tpu_torch.modules.video import (
    CausalConv3d,
    DepthToSpaceTimeUpsample,
    SpaceTimeDownsample,
    SpaceTimeUpsample,
)
from open_genie_tpu_torch.utils import Blueprint

_REGISTRY: Dict[str, Type[nn.Module]] = {
    "space-time_attn": SpaceTimeAttention,
    "causal-conv3d": CausalConv3d,
    "spacetime_downsample": SpaceTimeDownsample,
    "depth2spacetime_upsample": DepthToSpaceTimeUpsample,
    "spacetime_upsample": SpaceTimeUpsample,
}

# Names the JAX package's registry resolves that this package does not yet.
_NOT_PORTED = (
    "space_attn", "time_attn", "blur_pool", "space_downsample",
    "image-residual", "video-residual", "causal-conv3d-transpose",
    "depth2space_upsample", "depth2time_upsample",
    "group_norm", "adaptive_group_norm", "gelu", "relu", "leaky_relu", "silu",
)


def get_module(name: str) -> Type[nn.Module]:
    """Resolve a registry name to a module class."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"module {name!r} is not ported to open_genie_tpu_torch yet"
        )
    raise ValueError(f"Unknown module name: {name}")


def _sanitize_kwargs(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """YAML-sourced lists -> tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}


class _Remat:
    """Mixin of `remat_class`: in training with gradients on, the layer's
    intermediates are dropped after the forward and recomputed in the
    backward (`torch.utils.checkpoint`)."""

    def forward(self, *args, **kwargs):
        if self.training and torch.is_grad_enabled():
            return checkpoint(super().forward, *args, use_reentrant=False, **kwargs)
        return super().forward(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def remat_class(cls: Type[nn.Module]) -> Type[nn.Module]:
    """`cls` with activation checkpointing (the JAX package's `nn.remat`).
    A subclass, so parameter names do not change."""
    return type(f"Remat{cls.__name__}", (_Remat, cls), {})


def parse_blueprint(
    blueprint: Blueprint, remat: bool = False
) -> Tuple[nn.ModuleList, List[bool]]:
    """Expand a blueprint into `(layers, has_ext_flags)`.

    String entries mean `(name, {})`; `n_rep` repeats a module; `has_ext`
    marks a layer that takes external conditioning. `remat=True` builds
    every layer with activation checkpointing (`remat_class`).
    """
    layers, ext = [], []
    for desc in blueprint:
        if isinstance(desc, str):
            desc = (desc, {})
        name, kwargs = desc
        kwargs = dict(kwargs)
        has_ext = bool(kwargs.pop("has_ext", False))
        n_rep = int(kwargs.pop("n_rep", 1))
        cls = remat_class(get_module(name)) if remat else get_module(name)
        kwargs = _sanitize_kwargs(kwargs)
        for _ in range(n_rep):
            layers.append(cls(**kwargs))
            ext.append(has_ext)
    return nn.ModuleList(layers), ext


def blueprint_st_factor(blueprint: Blueprint) -> float:
    """Space-time volume factor of a blueprint (the product of its
    resamplers' `st_factor`), from modules built on the meta device."""
    fact = 1.0
    for desc in blueprint:
        name, kwargs = (desc, {}) if isinstance(desc, str) else desc
        kwargs = dict(kwargs)
        kwargs.pop("has_ext", None)
        n_rep = int(kwargs.pop("n_rep", 1))
        with torch.device("meta"):
            layer = get_module(name)(**_sanitize_kwargs(kwargs))
        fact *= getattr(layer, "st_factor", 1.0) ** n_rep
    return fact
