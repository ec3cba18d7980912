"""Load the JAX package's parameters into the port's modules.

Takes a flax `params` tree (a nested dict of numpy arrays) of a
`VideoTokenizer`, `LatentAction`, `DynamicsModel` or `Genie` (or of any
ported module) and builds the matching module's `state_dict`. It is the
inverse of the layout table in `open_genie_tpu/utils/torch_import.py`:

  ====================  =========================  ============================
  module                flax                       torch
  ====================  =========================  ============================
  Conv3d                kernel (kt, kh, kw, I, O)  weight (O, I, kt, kh, kw)
  ConvTranspose3d       kernel (kt, kh, kw, I, O)  weight (I, O, kt, kh, kw),
                                                   spatial axes flipped
  Dense                 kernel (I, O)              weight (O, I)
  LayerNorm/GroupNorm   scale (C,)                 weight (C,)
  Embed                 embedding (V, D)           weight (V, D)
  ====================  =========================  ============================

flax's `ConvTranspose` correlates with its kernel where torch's transposed
conv convolves with it, hence the flip. A self-attention's three
`to_q`/`to_k`/`to_v` projections become the one fused `to_qkv` Linear,
stacked `[q | k | v]` along the output features; a cross-attention keeps
them apart, as the module does. A key missing on either side raises.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

SKIPPED_SUBTREES = ()  # every subtree of the JAX Genie is ported
_RENAME = {"tokenizer_": "tokenizer", "dynamics_": "dynamics",
           "latent_action_": "latent_action"}
_LIST = re.compile(r"^(enc_layers|dec_layers|layers)_(\d+)$")
_QKV = ("to_q", "to_k", "to_v")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _module_path(path: Tuple[str, ...]) -> List[str]:
    out = []
    for part in path:
        part = _RENAME.get(part, part)
        m = _LIST.match(part)
        out.append(f"{m.group(1)}.{m.group(2)}" if m else part)
    return out


def _leaf(name: str, arr: np.ndarray, transposed: bool) -> Tuple[str, np.ndarray]:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: torch cannot wrap it
        arr = arr.astype(np.float32)
    if name == "kernel" and arr.ndim == 5 and transposed:
        return "weight", np.ascontiguousarray(arr.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1])
    if name == "kernel" and arr.ndim == 5:
        return "weight", arr.transpose(4, 3, 0, 1, 2)
    if name == "kernel" and arr.ndim == 2:
        return "weight", arr.T
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise KeyError(f"no torch counterpart for flax leaf {name!r} {arr.shape}")


def state_dict_from_flax(
    params: Mapping, module: nn.Module
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """`(state_dict, skipped flax paths)` of a flax `params` tree for
    `module` (which decides where a transposed conv sits and which
    attentions fuse their projections)."""
    owners = dict(module.named_modules())
    expected = set(module.state_dict())
    state, skipped, qkv = {}, [], {}
    for path, arr in _flatten(params):
        if path[0] in SKIPPED_SUBTREES:
            skipped.append("/".join(path))
            continue
        mods = _module_path(path[:-1])
        owner = owners.get(".".join(mods))
        name, val = _leaf(path[-1], arr, isinstance(owner, nn.ConvTranspose3d))
        key = ".".join(mods + [name])
        if mods and mods[-1] in _QKV and key not in expected:
            qkv.setdefault((".".join(mods[:-1] + ["to_qkv", name])), {})[mods[-1]] = val
            continue
        state[key] = torch.tensor(val)
    for key, parts in qkv.items():
        if set(parts) != set(_QKV):
            raise KeyError(
                f"fusing {key} needs to_q, to_k and to_v, got {sorted(parts)}"
            )
        state[key] = torch.tensor(
            np.concatenate([parts[p] for p in _QKV], axis=0)
        )
    return state, skipped


def load_flax_params(module: nn.Module, params: Mapping) -> List[str]:
    """Copy a flax `params` tree into `module` (cast to its dtype and
    device). Raises `KeyError` on any parameter missing on either side;
    returns the skipped flax paths."""
    state, skipped = state_dict_from_flax(params, module)
    expected = set(module.state_dict())
    missing = sorted(expected - set(state))
    unused = sorted(set(state) - expected)
    if missing or unused:
        raise KeyError(f"flax params do not fit: missing {missing}, unused {unused}")
    module.load_state_dict(state, strict=True)
    return skipped
