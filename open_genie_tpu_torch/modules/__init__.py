"""Blueprint registry and parser (twin of `open_genie_tpu.modules`).

Only the module names the rollout, the Genie joint training step and the
MAGVIT2 tokenizer use are ported; every other name of the JAX registry
raises an error saying so.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from open_genie_tpu_torch.modules.attention import SpaceTimeAttention
from open_genie_tpu_torch.modules.image import ImageResidualBlock, SpaceDownsample
from open_genie_tpu_torch.modules.misc import ACTIVATIONS, Activation
from open_genie_tpu_torch.modules.norm import AdaptiveGroupNorm, GroupNorm
from open_genie_tpu_torch.modules.video import (
    CausalConv3d,
    DepthToSpaceTimeUpsample,
    SpaceTimeDownsample,
    SpaceTimeUpsample,
    VideoResidualBlock,
)
from open_genie_tpu_torch.utils import Blueprint, cast_tuple

_REGISTRY: Dict[str, Type[nn.Module]] = {
    "space-time_attn": SpaceTimeAttention,
    "space_downsample": SpaceDownsample,
    "image-residual": ImageResidualBlock,
    "video-residual": VideoResidualBlock,
    "causal-conv3d": CausalConv3d,
    "spacetime_downsample": SpaceTimeDownsample,
    "depth2spacetime_upsample": DepthToSpaceTimeUpsample,
    "spacetime_upsample": SpaceTimeUpsample,
    "group_norm": GroupNorm,
    "adaptive_group_norm": AdaptiveGroupNorm,
    **{name: Activation for name in ACTIVATIONS},
}

# Names the JAX package's registry resolves that this package does not yet.
_NOT_PORTED = (
    "space_attn", "time_attn", "blur_pool", "causal-conv3d-transpose",
    "depth2space_upsample", "depth2time_upsample",
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


def _sanitize_kwargs(name: str, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """YAML-sourced lists -> tuples; an activation learns its function."""
    out = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
    if name in ACTIVATIONS:
        out["fn"] = name
    return out


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


# Blueprint kwargs that declare a layer's input width and its output width.
_IN_WIDTH = ("in_channels", "inp_channel", "in_dim", "num_channels", "d_inp", "n_embd")
_OUT_WIDTH = ("out_channels", "out_channel", "d_out", "n_embd")


def _expand(blueprint: Blueprint, width: Optional[int]) -> Tuple[list, Optional[int]]:
    """`([(name, kwargs, has_ext), ...], width)`: one entry per layer, with
    `n_rep` expanded and the kwargs sanitized, and the channel width that
    leaves the blueprint.

    `width` is the width entering the blueprint (None where the caller
    cannot know it). The running width follows each layer's declared input
    width, then its declared output width (norms and activations keep it).
    A `space-time_attn` that sets neither `d_inp` nor `n_embd` takes the
    running width as `d_inp`, as the JAX package takes the width of its
    traced input; where that width is unknown it raises `ValueError`.
    """
    layers = []
    for pos, desc in enumerate(blueprint):
        name, kwargs = (desc, {}) if isinstance(desc, str) else desc
        kwargs = dict(kwargs)
        has_ext = bool(kwargs.pop("has_ext", False))
        n_rep = int(kwargs.pop("n_rep", 1))
        kwargs = _sanitize_kwargs(name, kwargs)
        for _ in range(n_rep):
            kw = dict(kwargs)
            width = next((kw[k] for k in _IN_WIDTH if kw.get(k) is not None), width)
            out = width
            if name == "space-time_attn":
                if width is None:
                    raise ValueError(
                        f"blueprint layer {pos} ({name}): the width entering it is "
                        f"unknown; give it d_inp or n_embd"
                    )
                if kw.get("d_inp") is None and kw.get("n_embd") is None:
                    kw["d_inp"] = width
                out = (cast_tuple(kw.get("n_head", 8), 2)[1]
                       * cast_tuple(kw.get("d_head", 64), 2)[1])
            width = next((kw[k] for k in _OUT_WIDTH if kw.get(k) is not None), out)
            layers.append((name, kw, has_ext))
    return layers, width


def parse_blueprint(
    blueprint: Blueprint, remat: bool = False, width: Optional[int] = None
) -> Tuple[nn.ModuleList, List[bool]]:
    """Expand a blueprint into `(layers, has_ext_flags)`.

    String entries mean `(name, {})`; `n_rep` repeats a module; `has_ext`
    marks a layer that takes external conditioning. `remat=True` builds
    every layer with activation checkpointing (`remat_class`). `width` is
    the channel width entering the blueprint (see `_expand`).
    """
    layers, ext = [], []
    for name, kwargs, has_ext in _expand(blueprint, width)[0]:
        cls = remat_class(get_module(name)) if remat else get_module(name)
        layers.append(cls(**kwargs))
        ext.append(has_ext)
    return nn.ModuleList(layers), ext


def blueprint_out_width(blueprint: Blueprint, width: Optional[int] = None) -> Optional[int]:
    """The channel width leaving a blueprint that `width` channels enter."""
    return _expand(blueprint, width)[1]


def blueprint_st_factor(blueprint: Blueprint, width: Optional[int] = None) -> float:
    """Space-time volume factor of a blueprint (the product of its
    resamplers' `st_factor`), from modules built on the meta device."""
    fact = 1.0
    for name, kwargs, _ in _expand(blueprint, width)[0]:
        with torch.device("meta"):
            layer = get_module(name)(**kwargs)
        fact *= getattr(layer, "st_factor", 1.0)
    return fact
