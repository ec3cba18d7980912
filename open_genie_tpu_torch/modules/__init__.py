"""Blueprint registry and parser (twin of `open_genie_tpu.modules`).

Only the four module names the action-conditioned rollout uses are ported;
every other name of the JAX registry raises an error saying so.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Type

from torch import nn

from open_genie_tpu_torch.modules.attention import SpaceTimeAttention
from open_genie_tpu_torch.modules.video import (
    CausalConv3d,
    DepthToSpaceTimeUpsample,
    SpaceTimeDownsample,
)
from open_genie_tpu_torch.utils import Blueprint

_REGISTRY: Dict[str, Type[nn.Module]] = {
    "space-time_attn": SpaceTimeAttention,
    "causal-conv3d": CausalConv3d,
    "spacetime_downsample": SpaceTimeDownsample,
    "depth2spacetime_upsample": DepthToSpaceTimeUpsample,
}

# Names the JAX package's registry resolves that this package does not yet.
_NOT_PORTED = (
    "space_attn", "time_attn", "blur_pool", "space_downsample",
    "image-residual", "video-residual", "causal-conv3d-transpose",
    "depth2space_upsample", "depth2time_upsample", "spacetime_upsample",
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


def parse_blueprint(blueprint: Blueprint) -> Tuple[nn.ModuleList, List[bool]]:
    """Expand a blueprint into `(layers, has_ext_flags)`.

    String entries mean `(name, {})`; `n_rep` repeats a module; `has_ext`
    marks a layer that takes external conditioning.
    """
    layers, ext = [], []
    for desc in blueprint:
        if isinstance(desc, str):
            desc = (desc, {})
        name, kwargs = desc
        kwargs = dict(kwargs)
        has_ext = bool(kwargs.pop("has_ext", False))
        n_rep = int(kwargs.pop("n_rep", 1))
        cls = get_module(name)
        kwargs = _sanitize_kwargs(kwargs)
        for _ in range(n_rep):
            layers.append(cls(**kwargs))
            ext.append(has_ext)
    return nn.ModuleList(layers), ext
