"""Tensor parallelism over the mesh's `model` axis: each rank's slices of
the weights, the splits the modules run, and the state in one-process
layout.

`shard_module` takes a module built whole on every rank (from one seed,
`utils.init_weights`, or from one checkpoint) and keeps this rank's
slices, so a run of `n_model` ranks and one process start from the same
weights. Which axis a parameter splits is the JAX package's `TP_RULES`
(`mesh.param_shardings`, its specs unchanged) and, on top of them, the
splits that follow from those specs (`DERIVED_SPLITS`): a column-split
layer's bias, the input axis of the FFN's row partner, the vocabulary
head's bias. The modules then run Megatron's splits:

  * `Attention` holds `n_head / n_model` heads: `to_qkv` (each of q, k, v)
    or `to_q`/`to_k`/`to_v` split by output, `to_out` by input and
    followed by `collectives.reduce_from_model`; its bias (if any) is
    added once, after the reduce, and dropout after that. An attention
    whose heads do not divide by `n_model` runs replicated, though the
    JAX rule would split its weights' storage: the same numbers in
    another layout.
  * The space-time block's FFN (`ForwardBlock` under `ffn`) splits
    `block_0` by output channel: its output is gathered
    (`gather_from_model`) where `block_0` is the only layer, or meets a
    row-split `block_1` and one reduce where the FFN has a hidden layer.
  * `DynamicsModel` splits the embeddings' width (each lookup gathered)
    and the vocabulary head; its loss is vocabulary-parallel
    (`vocab_parallel_log_prob`, `vocab_parallel_argmax`).

A rule that does not divide leaves its weight replicated, as JAX's
`param_shardings` skips it. A split parameter carries `tp_split = (axis,
blocks)`: `blocks` equal parts of the axis, each split over the ranks
(the fused `[q | k | v]` projection has 3). The optimizer's moments and
the EMA, made from the split parameters, are split alike;
`gather_state` / `local_state` turn a rank's state into the one-process
`state_dict` layout and back, so checkpoints move between meshes.

The KV-cached decode paths are not split: the JAX package runs no
tensor-parallel rollout. A split model raises there.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.parallel.mesh import TP_RULES, Mesh, param_shardings

Split = Tuple[int, int]  # (axis, blocks)

# The splits that follow from TP_RULES' specs: (regex of the parameter's
# name, the name of the ruled weight it follows, made by `re.sub` of the
# regex, the axis it splits, blocks). It splits where that weight splits
# and its owner runs the split (see `tp_layout`).
DERIVED_SPLITS: Tuple[Tuple[str, str, int, int], ...] = (
    (r"to_qkv\.bias$", "to_qkv.weight", 0, 3),              # column-split bias, per q | k | v
    (r"(to_q|to_k|to_v)\.bias$", r"\1.weight", 0, 1),       # column-split biases
    (r"ffn\.block_0\.bias$", "ffn.block_0.weight", 0, 1),   # column-split bias
    (r"ffn\.block_1\.weight$", "ffn.block_0.weight", 1, 1),  # the row partner's input
    (r"head\.bias$", "head.weight", 0, 1),                  # the vocabulary head's bias
)


def _rule_blocks(name: str) -> int:
    for pattern, _, _, blocks in TP_RULES:
        if re.search(pattern, name):
            return blocks
    return 1


def tp_layout(module: nn.Module, mesh: Mesh) -> Dict[str, Optional[Split]]:
    """`{parameter name: (axis, blocks) or None}`: what `shard_module`
    splits on `mesh`. `param_shardings`' axes where the owning module runs
    the split (an attention only at head boundaries), the derived splits
    beside them; every other parameter replicated. A ruled split that no
    module can run raises."""
    from open_genie_tpu_torch.models.dynamics import DynamicsModel
    from open_genie_tpu_torch.modules.attention import Attention
    from open_genie_tpu_torch.modules.misc import ForwardBlock

    ruled = param_shardings(module, mesh)
    layout: Dict[str, Optional[Split]] = {name: None for name in ruled}
    claimed = set()

    def take(name: str, axis: int, blocks: int = 1) -> None:
        layout[name] = (axis, blocks)

    def derived(prefix: str, sub: nn.Module) -> None:
        for local, _ in sub.named_parameters(recurse=True):
            name = f"{prefix}.{local}" if prefix else local
            for pattern, source, axis, blocks in DERIVED_SPLITS:
                if re.search(pattern, name):
                    if layout.get(re.sub(pattern, source, name)) is not None:
                        take(name, axis, blocks)
                    break

    for prefix, sub in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(sub, Attention):
            projections = (("to_qkv",) if sub.key_dim is None else ("to_q", "to_k", "to_v"))
            weights = [f"{dot}{w}.weight" for w in projections + ("to_out",)]
            claimed.update(weights)
            if sub.n_head % mesh.n_model or any(ruled[w] is None for w in weights):
                continue  # replicated: heads (or a rule) do not divide
            for w in weights:
                take(w, ruled[w], _rule_blocks(w))
            derived(prefix, sub)
        elif isinstance(sub, ForwardBlock):
            w = f"{dot}block_0.weight"
            if w in ruled:
                claimed.add(w)
                if ruled[w] is not None:
                    take(w, ruled[w])
                    derived(prefix, sub)
        elif isinstance(sub, DynamicsModel):
            for part in ("tok_emb", "act_emb", "head"):
                w = f"{dot}{part}.weight"
                claimed.add(w)
                if ruled[w] is not None:
                    take(w, ruled[w])
            derived(prefix, sub)
    stray = [n for n, axis in ruled.items() if axis is not None and n not in claimed]
    if stray:
        raise ValueError(f"TP_RULES split {stray[:3]}, which no module runs split")
    return layout


def slice_of(full: torch.Tensor, split: Optional[Split], index: int, n: int) -> torch.Tensor:
    """Rank `index`'s slice (of `n`) of a whole tensor: its part of each
    block of the split axis; the tensor itself where it is not split."""
    if split is None or n == 1:
        return full
    axis, blocks = split
    moved = full.movedim(axis, 0)
    part = moved.reshape(blocks, n, -1, *moved.shape[1:])[:, index]
    return part.reshape(-1, *moved.shape[1:]).movedim(0, axis).contiguous()


def gather_split(part: torch.Tensor, split: Optional[Split], group) -> torch.Tensor:
    """The whole tensor of the model group's slices (all-gathered; 16-bit
    floats moved as f32); `part` itself where it is not split."""
    if split is None or not collectives.reduces(group):
        return part
    axis, blocks = split
    moved = [p.movedim(axis, 0) for p in collectives.all_gather_wide(part, group)]
    chunk = moved[0].shape[0] // blocks
    pieces = [m[b * chunk:(b + 1) * chunk] for b in range(blocks) for m in moved]
    return torch.cat(pieces).movedim(0, axis).to(part.dtype)


def shard_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's slices of `module`'s weights (built whole, the same
    on every rank) and make the split modules run their splits over
    `mesh.model_group`; in place, returns `module`. Nothing changes on a
    mesh without a model axis."""
    if mesh.n_model == 1:
        return module
    if mesh.model_group is None:
        raise ValueError(f"a {mesh.n_data}x{mesh.n_model} mesh without its model group: "
                         "make it with make_mesh() inside the run")
    from open_genie_tpu_torch.models.dynamics import DynamicsModel
    from open_genie_tpu_torch.modules.attention import Attention
    from open_genie_tpu_torch.modules.misc import ForwardBlock

    layout = tp_layout(module, mesh)
    owners = dict(module.named_modules())
    for name, split in layout.items():
        if split is None:
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = owners[owner_name]
        old = getattr(owner, attr)
        new = nn.Parameter(slice_of(old.detach(), split, mesh.model_index, mesh.n_model),
                           requires_grad=old.requires_grad)
        new.tp_split = split
        setattr(owner, attr, new)
    for prefix, sub in owners.items():
        dot = f"{prefix}." if prefix else ""
        if isinstance(sub, Attention):
            if layout.get(dot + "to_out.weight") is not None:
                sub.tp_group = mesh.model_group
        elif isinstance(sub, ForwardBlock):
            if layout.get(dot + "block_0.weight") is not None:
                sub.tp_group = mesh.model_group
        elif isinstance(sub, DynamicsModel):
            parts = frozenset(p for p in ("tok_emb", "act_emb", "head")
                              if layout[f"{dot}{p}.weight"] is not None)
            if parts:
                sub.tp_group, sub.tp_parts = mesh.model_group, parts
    return module


def split_of(p: torch.Tensor) -> Optional[Split]:
    """A parameter's `(axis, blocks)` split, None where it is replicated."""
    return getattr(p, "tp_split", None)


def _map_state(state, params: Mapping[str, torch.Tensor], train_state: Mapping[str, Any],
               fn) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """`fn(tensor, split)` over the parameters of a `state_dict` and the
    per-parameter tensors of a train state (AdamW's moments, the
    accumulation buffers, the EMA); a new pair of dicts."""
    named = dict(state.module.named_parameters())
    splits = {n: split_of(p) for n, p in named.items()}
    out_params = {n: fn(t, splits.get(n)) for n, t in params.items()}
    opt = dict(train_state["optimizer"])
    trainable = state.optimizer.params
    adamw = dict(opt["adamw"])
    adamw["state"] = {
        i: {k: fn(v, split_of(trainable[i])) if k in ("exp_avg", "exp_avg_sq") else v
            for k, v in s.items()}
        for i, s in adamw["state"].items()}
    opt["adamw"] = adamw
    if opt.get("acc") is not None:
        opt["acc"] = [fn(a, split_of(p)) for a, p in zip(opt["acc"], trainable)]
    if opt.get("ema") is not None:
        opt["ema"] = {n: fn(t, splits[n]) for n, t in opt["ema"].items()}
    return out_params, {**train_state, "optimizer": opt}


def gather_state(state, mesh: Mesh) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """`(params, train_state)` of a `TrainState` (`loop.TrainState`) in the
    one-process layout: each split tensor all-gathered over the model
    group. Every rank of the mesh must call it."""
    return _map_state(state, state.module.state_dict(), state.train_state_dict(),
                      lambda t, split: gather_split(t, split, mesh.model_group))


def gather_params(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The module's `state_dict` in the one-process layout: each split
    parameter all-gathered over the model group (the sample video's whole
    weights). Every rank of the mesh must call it."""
    splits = {n: split_of(p) for n, p in module.named_parameters()}
    return {n: gather_split(t.detach(), splits.get(n), mesh.model_group)
            for n, t in module.state_dict().items()}


def local_state(state, params: Mapping[str, torch.Tensor], train_state: Mapping[str, Any],
                mesh: Mesh) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """This rank's slices of a one-process `(params, train_state)`, for
    the split `state` to load."""
    return _map_state(state, params, train_state,
                      lambda t, split: slice_of(t, split, mesh.model_index, mesh.n_model))


# --------------------------------------------------------------------- #
# The vocabulary-parallel loss of the dynamics head
# --------------------------------------------------------------------- #

def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    return t


class _VocabParallelLogProb(torch.autograd.Function):
    """`log_softmax(logits)[target]` of f32 logits whose last axis is this
    rank's block `[start, start + V_local)` of the vocabulary: the row
    max and the sum of exponentials all-reduced over the model group, the
    target's logit taken on the rank that owns it and all-reduced. The
    backward needs no collective: the cotangent is the same on every rank
    and each gets `g * (onehot - softmax)` on its own block."""

    @staticmethod
    def forward(ctx, logits, target, start: int, group):
        m = _all_reduce(logits.detach().amax(-1), group, dist.ReduceOp.MAX)
        shifted = logits - m[..., None]
        e = shifted.exp()
        s = _all_reduce(e.sum(-1), group)
        local = target.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)
        picked = torch.gather(shifted, -1, idx[..., None])[..., 0]
        picked = _all_reduce(torch.where(inside, picked, torch.zeros_like(picked)), group)
        ctx.save_for_backward(e / s[..., None], idx, inside)
        return picked - torch.log(s)

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax * -g[..., None]
        own = torch.where(inside, g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], own[..., None])
        return grad, None, None, None


def vocab_parallel_log_prob(logits: torch.Tensor, target: torch.Tensor, group) -> torch.Tensor:
    """`log_softmax(logits, -1)` at `target`, for logits split over the
    model group by vocabulary block (rank `i` holds `[i V_local, (i + 1)
    V_local)`), in f32; the one-process gather where nothing splits."""
    logits = logits.float()
    if not collectives.reduces(group):
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, target.long()[..., None])[..., 0]
    start = collectives.rank(group) * logits.shape[-1]
    return _VocabParallelLogProb.apply(logits, target, start, group)


def vocab_parallel_argmax(logits: torch.Tensor, group) -> torch.Tensor:
    """`argmax(logits, -1)` over the whole vocabulary of logits split by
    vocabulary block: the largest value all-reduced by max, then the lowest
    index among the ranks that hold it (`jnp.argmax`'s and torch's
    first-index rule)."""
    idx = logits.argmax(-1)
    if not collectives.reduces(group):
        return idx
    with torch.no_grad():
        best = torch.gather(logits, -1, idx[..., None])[..., 0].float()
        top = _all_reduce(best.clone(), group, dist.ReduceOp.MAX)
        start = collectives.rank(group) * logits.shape[-1]
        first = torch.where(best == top, idx + start, torch.full_like(idx, torch.iinfo(
            torch.int64).max))
        return _all_reduce(first, group, dist.ReduceOp.MIN)
