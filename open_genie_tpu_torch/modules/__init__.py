"""Blueprint registry and parser (twin of `open_genie_tpu.modules`).

Every name of the JAX package's registry resolves to its port; a name
that is in neither raises `ValueError`.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from open_genie_tpu_torch.modules.attention import (
    SpaceTimeAttention,
    SpatialAttention,
    TemporalAttention,
)
from open_genie_tpu_torch.modules.image import BlurPooling2d, ImageResidualBlock, SpaceDownsample
from open_genie_tpu_torch.modules.misc import ACTIVATIONS, Activation
from open_genie_tpu_torch.modules.norm import AdaptiveGroupNorm, GroupNorm
from open_genie_tpu_torch.modules.video import (
    CausalConv3d,
    CausalConvTranspose3d,
    DepthToSpaceTimeUpsample,
    DepthToSpaceUpsample,
    DepthToTimeUpsample,
    SpaceTimeDownsample,
    SpaceTimeUpsample,
    VideoResidualBlock,
)
from open_genie_tpu_torch.utils import Blueprint, cast_tuple

_REGISTRY: Dict[str, Type[nn.Module]] = {
    "space_attn": SpatialAttention,
    "time_attn": TemporalAttention,
    "space-time_attn": SpaceTimeAttention,
    "blur_pool": BlurPooling2d,
    "space_downsample": SpaceDownsample,
    "image-residual": ImageResidualBlock,
    "video-residual": VideoResidualBlock,
    "causal-conv3d": CausalConv3d,
    "causal-conv3d-transpose": CausalConvTranspose3d,
    "depth2space_upsample": DepthToSpaceUpsample,
    "depth2time_upsample": DepthToTimeUpsample,
    "depth2spacetime_upsample": DepthToSpaceTimeUpsample,
    "spacetime_downsample": SpaceTimeDownsample,
    "spacetime_upsample": SpaceTimeUpsample,
    "group_norm": GroupNorm,
    "adaptive_group_norm": AdaptiveGroupNorm,
    **{name: Activation for name in ACTIVATIONS},
}
# Attentions whose input width defaults to the width entering them.
_WIDTH_FROM_INPUT = ("space-time_attn", "space_attn", "time_attn")


def get_module(name: str) -> Type[nn.Module]:
    """Resolve a registry name to a module class."""
    if name in _REGISTRY:
        return _REGISTRY[name]
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


def _layer_descs(blueprint: Blueprint):
    """`(name, kwargs, has_ext)` per layer, `n_rep` expanded and the kwargs
    sanitized."""
    for desc in blueprint:
        name, kwargs = (desc, {}) if isinstance(desc, str) else desc
        kwargs = dict(kwargs)
        has_ext = bool(kwargs.pop("has_ext", False))
        n_rep = int(kwargs.pop("n_rep", 1))
        kwargs = _sanitize_kwargs(name, kwargs)
        for _ in range(n_rep):
            yield name, dict(kwargs), has_ext


def _expand(blueprint: Blueprint, width: Optional[int]) -> Tuple[list, Optional[int]]:
    """`([(name, kwargs, has_ext), ...], width)`: one entry per layer (see
    `_layer_descs`), and the channel width that leaves the blueprint.

    `width` is the width entering the blueprint (None where the caller
    cannot know it). The running width follows each layer's declared input
    width, then its declared output width (norms, activations and blur
    pooling keep it). A `space-time_attn` that sets neither `d_inp` nor
    `n_embd`, or a `space_attn` / `time_attn` without `d_inp`, takes the
    running width as `d_inp`, as the JAX package takes the width of its
    traced input; where that width is unknown it raises `ValueError`
    naming the layer.
    """
    layers = []
    for pos, (name, kw, has_ext) in enumerate(_layer_descs(blueprint)):
        width = next((kw[k] for k in _IN_WIDTH if kw.get(k) is not None), width)
        out = width
        if name in _WIDTH_FROM_INPUT:
            if width is None:
                raise ValueError(
                    f"blueprint layer {pos} ({name}): the width entering it is "
                    f"unknown; give it d_inp" + (" or n_embd" if name == "space-time_attn"
                                                 else "")
                )
            if kw.get("d_inp") is None and kw.get("n_embd") is None:
                kw["d_inp"] = width
            if name == "space-time_attn":
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


def blueprint_layers(blueprint: Blueprint, width: Optional[int] = None) -> list:
    """`(name, kwargs, has_ext)` of each layer that `parse_blueprint` builds
    from `blueprint`, in order (see `_expand`)."""
    return _expand(blueprint, width)[0]


def blueprint_out_width(blueprint: Blueprint, width: Optional[int] = None) -> Optional[int]:
    """The channel width leaving a blueprint that `width` channels enter."""
    return _expand(blueprint, width)[1]


def _blueprint_factor(blueprint: Blueprint, attr: str) -> float:
    """The product over a blueprint's layers of `attr`, read from modules
    built on the meta device, of the names whose class has it."""
    fact = 1.0
    for name, kwargs, _ in _layer_descs(blueprint):
        cls = get_module(name)
        if not hasattr(cls, attr):
            continue
        with torch.device("meta"):
            fact *= getattr(cls(**kwargs), attr)
    return fact


def blueprint_st_factor(blueprint: Blueprint) -> float:
    """Space-time volume factor of a blueprint (the product of its
    resamplers' `st_factor`)."""
    return _blueprint_factor(blueprint, "st_factor")


def blueprint_time_factor(blueprint: Blueprint) -> float:
    """Time-axis length factor of a blueprint (0.25 for an encoder that
    compresses time 4 times), the product of its layers' `t_factor`: what
    `VideoTokenizer.temporal_downsampling` reads."""
    return _blueprint_factor(blueprint, "t_factor")
