"""VGG16 feature extractor for the perceptual loss (twin of `open_genie_tpu.modules.vgg`).

Layers carry torchvision's `vgg16().features` indices (`conv_{i}` for
`features.{i}`), so feature taps are named `features.{i}` and torchvision
weights map one to one. The trunk stops at the deepest wanted tap. Inputs
are channels-last `(B, H, W, 3)` frames in [0, 1] with no ImageNet
normalization, as in the JAX package; the trunk runs NCHW inside and the
taps come back channels-last.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16 `features`: conv widths, 'M' marks a 2x2 max pool.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]


def layer_schedule():
    """`(torchvision index, kind, width)` over the conv stack."""
    idx = 0
    for entry in VGG16_CFG:
        if entry == "M":
            yield idx, "pool", None
            idx += 1
        else:
            yield idx, "conv", entry
            yield idx + 1, "relu", None
            idx += 2


class VGG16Features(nn.Module):
    """VGG16 conv trunk returning the activations at `feat_layers`."""

    def __init__(self, feat_layers: Tuple[str, ...] = (
            "features.6", "features.13", "features.18", "features.25")):
        super().__init__()
        self.feat_layers = tuple(feat_layers)
        self.last = max(int(name.split(".")[1]) for name in self.feat_layers)
        known = {f"features.{idx}" for idx, _, _ in layer_schedule()}
        if not set(self.feat_layers) <= known:
            raise ValueError(f"feat_layers not in the VGG16 trunk: {set(self.feat_layers) - known}")
        width = 3
        for idx, kind, features in layer_schedule():
            if idx > self.last:
                break
            if kind == "conv":
                self.add_module(f"conv_{idx}", nn.Conv2d(width, features, 3, padding=1))
                width = features

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        taps = {}
        for idx, kind, _ in layer_schedule():
            if idx > self.last:
                break
            if kind == "conv":
                h = getattr(self, f"conv_{idx}")(h)
            elif kind == "relu":
                h = F.relu(h)
            else:
                h = F.max_pool2d(h, 2, 2)
            name = f"features.{idx}"
            if name in self.feat_layers:
                taps[name] = h.permute(0, 2, 3, 1)
        return taps


@torch.no_grad()
def load_torch_vgg16_npz(path: str, vgg: VGG16Features) -> VGG16Features:
    """Load converted torchvision VGG16 weights into `vgg` in place.

    The `.npz` holds `features.{i}.weight` (OIHW, as the convs here) and
    `features.{i}.bias` arrays, as `tools/convert_vgg_weights.py` writes
    them. The trunk holds the convs up to its deepest tap, so it loads those
    of the file's 13; a conv missing from the file raises."""
    import numpy as np

    data = np.load(path)
    missing = []
    for idx, kind, _ in layer_schedule():
        if kind != "conv" or idx > vgg.last:
            continue
        conv = getattr(vgg, f"conv_{idx}")
        for name, param in (("weight", conv.weight), ("bias", conv.bias)):
            key = f"features.{idx}.{name}"
            if key not in data:
                missing.append(key)
                continue
            value = torch.from_numpy(np.asarray(data[key]))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{path}: {key} has shape {tuple(value.shape)}, the trunk's "
                                 f"conv_{idx} {tuple(param.shape)}")
            param.copy_(value)
    if missing:
        raise ValueError(f"VGG weight file {path} lacks {missing}")
    return vgg
