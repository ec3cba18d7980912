"""Import reference (open-genie, PyTorch Lightning) `VideoTokenizer`
checkpoints into the port's modules.

The reference's `state_dict` keys mirror its blueprints: `enc_layers.{i}.…`,
`dec_layers.{i}.…` and `quant.…`. The port builds its encoder and decoder
stacks from the same blueprint lists, so layer `i` of the reference is
layer `i` of the port, and inside a layer each reference parameter has one
slot in the port. The port's module (its parameter names and shapes) is
the template: it decides which slot a reference key fills, and every slot
must be filled.

The reference is PyTorch, so its weights already have the port's layout,
`(O, I, k…)` for a conv and `(O, I)` for a Linear. Most entries are renames
and nesting:

  ======================  ================================  =========================
  port layer              reference keys                    port keys
  ======================  ================================  =========================
  CausalConv3d            `conv3d.{weight,bias}`            the same
  GroupNorm               `{weight,bias}`                   `gn.{weight,bias}`
  AdaptiveGroupNorm       `std.*`, `avg.*`, `{weight,bias}`  `std.*`, `avg.*`, `gn.*`
  SpaceTimeDownsample     `go_down.conv3d.*`                `down.conv3d.*`
  DepthToSpaceTime…       `go_up.0.conv3d.*`                `conv.conv3d.*`
  SpaceTimeUpsample       `go_up.{weight,bias}`             `up.{weight,bias}`
  CausalConvTranspose3d   `{weight,bias}`                   `conv_transpose3d.*`
  DepthToSpace/Time…      `go_up.0.{weight,bias}`           `proj.{weight,bias}`
  VideoResidualBlock      `main.{j}.…`, `res.{j}.…`          see `_residual_block`
  LookupFree…             `proj_inp.*`, `proj_out.*`         the same
  ======================  ================================  =========================

Two entries change values' layout. A transposed conv is torch's
`ConvTranspose3d` on both sides, so its `(I, O, kt, kh, kw)` weight is
copied as it is: the spatial flip that a flax `ConvTranspose` needs does
not arise between two torch convolutions. The depth-to-space and
depth-to-time upsamplers run a pointwise Conv2d / Conv1d in the reference
and a 1x1x1 `Conv3d` in the port: the `(O, I, 1, 1)` or `(O, I, 1)` weight
is reshaped to `(O, I, 1, 1, 1)`.

Non-parameter buffers (the blur kernels, the LFQ's `bit_mask` and
`codebook`) are recomputed by the port and skipped, as are the loss
modules' subtrees (`gan_crit.…`, `perc_crit.…`): they are returned as
skipped keys. Every case where the mapping does not hold raises
`ReferenceImportError` (a `ValueError`): a template slot with no source, a
reference key left over, a reference group with no slot (a blueprint
mismatch) and a shape mismatch. The same cases as the JAX package's
importer, which this module mirrors without importing it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "ReferenceImportError",
    "SKIPPED_PREFIXES",
    "convert_reference_state_dict",
    "group_reference_keys",
    "load_reference_state_dict",
]

# Loss-module subtrees of a reference Lightning checkpoint, not migrated:
# the discriminator and the VGG restart with the port's own.
SKIPPED_PREFIXES = ("gan_crit.", "perc_crit.")

# Non-parameter buffers, recomputed from the config by the port.
_BUFFER_LEAVES = ("blur", "bit_mask", "codebook")

Template = Dict[str, Any]  # nested {name: {…} or shape}


class ReferenceImportError(ValueError):
    """A reference `state_dict` that does not map onto the port's module."""


def _group_of(key: str) -> Tuple[str, str]:
    """`(group, key within it)`: `enc_layers.3.main.2.weight` ->
    `("enc_layers.3", "main.2.weight")`, `quant.proj_inp.bias` ->
    `("quant", "proj_inp.bias")`."""
    parts = key.split(".")
    if parts[0] in ("enc_layers", "dec_layers") and len(parts) > 1 and parts[1].isdigit():
        return ".".join(parts[:2]), ".".join(parts[2:])
    return parts[0], ".".join(parts[1:])


def group_reference_keys(state_dict: Mapping[str, np.ndarray]
                         ) -> Tuple[Dict[str, Dict[str, np.ndarray]], List[str]]:
    """`(groups, skipped)`: the reference's parameters by layer group
    (`{"enc_layers.3": {"main.2.weight": …}, …}`) and the keys of loss
    modules and buffers, which are not imported."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    skipped: List[str] = []
    for key, val in state_dict.items():
        if key.startswith(SKIPPED_PREFIXES) or key.split(".")[-1] in _BUFFER_LEAVES:
            skipped.append(key)
            continue
        top, rest = _group_of(key)
        groups.setdefault(top, {})[rest] = np.asarray(val)
    return groups, skipped


def _template(module: nn.Module) -> Dict[str, Template]:
    """The module's parameters as `{group: nested {name: shape}}`."""
    out: Dict[str, Template] = {}
    for key, p in module.named_parameters():
        top, rest = _group_of(key)
        node = out.setdefault(top, {})
        *path, leaf = rest.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tuple(p.shape)
    return out


def _dot(prefix: str) -> str:
    return prefix + "." if prefix else ""


def _take(ref: Dict[str, np.ndarray], key: str, ctx: str) -> np.ndarray:
    if key not in ref:
        raise ReferenceImportError(f"{ctx}: expected reference key {key!r}; have {sorted(ref)}")
    return ref.pop(key)


def _prefixed(prefix: str, entries: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in entries.items()}


def _params(ref, prefix: str, tmpl: Template, ctx: str) -> Dict[str, np.ndarray]:
    """A layer whose reference parameters are its own: `weight` and, if the
    port has one, `bias` (a conv, a transposed conv, a Linear, a norm)."""
    out = {"weight": _take(ref, _dot(prefix) + "weight", ctx)}
    if "bias" in tmpl:
        out["bias"] = _take(ref, _dot(prefix) + "bias", ctx)
    return out


def _conv_entry(ref, prefix: str, tmpl: Template, ctx: str) -> Dict[str, np.ndarray]:
    """A conv slot of the port: a `CausalConv3d` (its inner `conv3d`,
    which the reference nests the same way), a `CausalConvTranspose3d`
    (the reference's is the `ConvTranspose3d` itself, keys at `prefix`),
    or a plain conv."""
    if "conv3d" in tmpl:
        return _prefixed("conv3d", _conv_entry(ref, _dot(prefix) + "conv3d", tmpl["conv3d"], ctx))
    if "conv_transpose3d" in tmpl:
        return _prefixed("conv_transpose3d", _params(ref, prefix, tmpl["conv_transpose3d"], ctx))
    return _params(ref, prefix, tmpl, ctx)


def _pointwise(ref, prefix: str, tmpl: Template, ctx: str) -> Dict[str, np.ndarray]:
    """The reference's pointwise Conv2d / Conv1d `(O, I, 1[, 1])` as the
    port's 1x1x1 Conv3d `(O, I, 1, 1, 1)`."""
    out = _params(ref, prefix, tmpl, ctx)
    w = out["weight"]
    if w.ndim < 2 or any(k != 1 for k in w.shape[2:]):
        raise ReferenceImportError(
            f"{ctx}: pointwise conv {_dot(prefix)}weight expected all-ones kernel dims, "
            f"got {w.shape}")
    out["weight"] = w.reshape(*w.shape[:2], 1, 1, 1)
    return out


def _residual_block(ref: Dict[str, np.ndarray], tmpl: Template, ctx: str
                    ) -> Dict[str, np.ndarray]:
    """A reference `VideoResidualBlock` onto the port's.

    The reference holds `main` = [Down?] -> GN -> act -> Conv -> [Down?] ->
    GN -> act -> Conv and `res` = [Down?] -> 1x1 Conv as indexed
    Sequentials whose indices shift with the optional downsamplers, so the
    entries are paired by kind in index order: 1-D `weight`s are the norms
    (`norm1`, `norm2`), the other convs `conv1`, `conv2`; a `go_down` conv
    is `down_main` / `down_res`; the conv under `res` is `res_proj`. A
    submodule's kind is read from all of its keys, never from whichever
    comes first (an `.npz` keeps no registration order)."""

    def idx_of(key: str) -> int:
        return int(key.split(".")[1])

    def heads(branch: str) -> List[str]:
        """The `branch.{j}` submodules, in index order."""
        seen: List[str] = []
        for key in sorted((k for k in ref if k.startswith(branch + ".")), key=idx_of):
            head = ".".join(key.split(".")[:2])
            if head not in seen:
                seen.append(head)
        return seen

    def kind(head: str) -> str:
        subs = {k[len(head) + 1:] for k in ref if k.startswith(head + ".")}
        if any(s.startswith("go_down.") for s in subs):
            return "down"
        if "weight" in subs and ref[head + ".weight"].ndim == 1:
            return "norm"
        return "conv"

    norms, convs, down_main = [], [], None
    for head in heads("main"):
        k = kind(head)
        if k == "norm":
            norms.append(head)
        elif k == "down":
            down_main = head + ".go_down"
        else:
            convs.append(head)
    want_norms = 2 if "norm1" in tmpl else 0  # use_norm=False has none
    if len(norms) != want_norms or len(convs) != 2:
        raise ReferenceImportError(
            f"{ctx}: expected {want_norms} norms + 2 convs in `main`, found "
            f"norms={norms} convs={convs}")
    out: Dict[str, np.ndarray] = {}
    if want_norms:
        out.update(_prefixed("norm1", _params(ref, norms[0], tmpl["norm1"], ctx)))
        out.update(_prefixed("norm2", _params(ref, norms[1], tmpl["norm2"], ctx)))
    out.update(_prefixed("conv1", _conv_entry(ref, convs[0], tmpl["conv1"], ctx)))
    out.update(_prefixed("conv2", _conv_entry(ref, convs[1], tmpl["conv2"], ctx)))
    if "down_main" in tmpl:
        if down_main is None:
            raise ReferenceImportError(f"{ctx}: the port's block has down_main, the reference not")
        out.update(_prefixed("down_main.down",
                             _conv_entry(ref, down_main, tmpl["down_main"]["down"], ctx)))

    down_res = res_conv = None
    for head in heads("res"):
        if kind(head) == "down":
            down_res = head + ".go_down"
        else:
            res_conv = head
    if res_conv is None:
        raise ReferenceImportError(f"{ctx}: no shortcut conv under `res`")
    out.update(_prefixed("res_proj", _conv_entry(ref, res_conv, tmpl["res_proj"], ctx)))
    if "down_res" in tmpl:
        if down_res is None:
            raise ReferenceImportError(f"{ctx}: the port's block has down_res, the reference not")
        out.update(_prefixed("down_res.down",
                             _conv_entry(ref, down_res, tmpl["down_res"]["down"], ctx)))
    return out


def _convert_group(ref: Dict[str, np.ndarray], tmpl: Template, ctx: str
                   ) -> Dict[str, np.ndarray]:
    """One layer group, directed by the port's template of it."""
    keys = set(tmpl)
    if keys == {"gn"}:  # GroupNorm: the reference's nn.GroupNorm itself
        return _prefixed("gn", _params(ref, "", tmpl["gn"], ctx))
    if "std" in keys:  # AdaptiveGroupNorm: the std/avg Linears over the condition
        out = _prefixed("std", _params(ref, "std", tmpl["std"], ctx))
        if "avg" in tmpl:
            out.update(_prefixed("avg", _params(ref, "avg", tmpl["avg"], ctx)))
        if "gn" in tmpl:
            out.update(_prefixed("gn", _params(ref, "", tmpl["gn"], ctx)))
        return out
    if "res_proj" in keys:
        return _residual_block(ref, tmpl, ctx)
    if keys in ({"conv3d"}, {"conv_transpose3d"}):
        return _conv_entry(ref, "", tmpl, ctx)
    if keys == {"down"}:  # SpaceTimeDownsample: the reference's `go_down` CausalConv3d
        return _prefixed("down", _conv_entry(ref, "go_down", tmpl["down"], ctx))
    if keys == {"conv"}:  # DepthToSpaceTimeUpsample: `go_up.0`, a CausalConv3d
        return _prefixed("conv", _conv_entry(ref, "go_up.0", tmpl["conv"], ctx))
    if keys == {"up"}:  # SpaceTimeUpsample: `go_up`, a ConvTranspose3d
        return _prefixed("up", _params(ref, "go_up", tmpl["up"], ctx))
    if keys == {"proj"}:  # DepthToSpace / DepthToTime: `go_up.0`, pointwise
        return _prefixed("proj", _pointwise(ref, "go_up.0", tmpl["proj"], ctx))
    if keys <= {"proj_inp", "proj_out"}:  # LFQ's projections, same names
        out: Dict[str, np.ndarray] = {}
        for name in sorted(keys):
            out.update(_prefixed(name, _params(ref, name, tmpl[name], ctx)))
        return out
    raise ReferenceImportError(
        f"{ctx}: unsupported layer with parameters {sorted(keys)} "
        f"(reference keys: {sorted(ref)})")


def convert_reference_state_dict(state_dict: Mapping[str, Any], module: nn.Module
                                 ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """`(state_dict, skipped keys)`: a reference `VideoTokenizer`'s
    `state_dict` (tensors or arrays) as the `state_dict` of the port's
    `module` (a `VideoTokenizer` built from the same blueprints), in
    float32. Raises `ReferenceImportError` where a parameter of `module`
    has no source, a reference parameter has no slot, or a shape differs."""
    groups, skipped = group_reference_keys(
        {k: v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
         for k, v in state_dict.items()})
    template = _template(module)
    out: Dict[str, np.ndarray] = {}
    for top, tmpl in template.items():
        if top not in groups:
            raise ReferenceImportError(
                f"no reference parameters for the port's layer group {top!r}; "
                f"reference groups: {sorted(groups)}")
        ref = groups.pop(top)
        out.update(_prefixed(top, _convert_group(ref, tmpl, ctx=top)))
        if ref:
            raise ReferenceImportError(f"{top}: unconsumed reference keys {sorted(ref)}")
    if groups:
        raise ReferenceImportError(
            f"reference groups with no slot in the port: {sorted(groups)} (is the config "
            "the same blueprint the checkpoint was trained with?)")
    want = {k: tuple(p.shape) for k, p in module.named_parameters()}
    if set(out) != set(want):
        raise ReferenceImportError(
            f"parameters do not fit: missing {sorted(set(want) - set(out))}, "
            f"extra {sorted(set(out) - set(want))}")
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise ReferenceImportError(f"{key}: shape {tuple(out[key].shape)} != the port's {shape}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}, skipped


def load_reference_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint as `{key: array}`: an `.npz`, a raw
    `torch.save`d `state_dict`, or a Lightning `.ckpt` (its `state_dict`).

    A `weights_only` load comes first. A Lightning checkpoint's metadata
    (its hyper-parameter container, the optimizer's `functools.partial`)
    fails it, and Lightning need not be installed, so the load is retried
    with every class the unpickler cannot resolve stubbed out (printing a
    warning: only for files one trusts); the tensors are unaffected."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        print("# weights-only load failed (Lightning metadata in the checkpoint); "
              "retrying with unknown classes stubbed -- only do this with checkpoint "
              "files you trust")
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_tolerant_pickle())
    if isinstance(obj, dict) and "state_dict" in obj:  # Lightning .ckpt
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in obj.items()}


def _tolerant_pickle():
    """A pickle module whose Unpickler turns classes it cannot resolve
    into inert dict-like stubs (checkpoint metadata); tensors load as
    they are."""
    import io
    import pickle
    import types

    class _Opaque(dict):
        def __init__(self, *a, **k):
            super().__init__()

        def __setstate__(self, state):
            return None

        def __call__(self, *a, **k):
            return self

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_Opaque,), {})

    shim = types.ModuleType("tolerant_pickle")
    shim.Unpickler = _Unpickler
    shim.load = lambda f, **kw: _Unpickler(f, **kw).load()
    shim.loads = lambda b, **kw: _Unpickler(io.BytesIO(b), **kw).load()
    return shim
