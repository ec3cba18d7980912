"""The train step and its state (twin of `open_genie_tpu.train.loop`).

`make_optimizer` is the JAX package's optax chain: AdamW with gradient
clipping by global norm over the trainable parameters, a learning-rate
schedule, a parameter EMA and gradient accumulation with
`optax.MultiSteps` semantics. `make_train_step` runs one forward, backward
and update under the bf16 compute policy of "16-mixed" (f32 master weights
and optimizer state, each f32 parameter cast to bf16 through autograd for
the forward, float batch leaves cast to bf16), on a `TrainState` that
counts its calls. Checkpoints are torch files under `<ckpt_dir>/<step>/`,
each written atomically.

Data parallel (`make_train_step(mesh=)`): each rank runs the step on its
rows of the global batch, the losses reduce their batch statistics across
the ranks (`parallel.collectives`), and the trainable gradients are summed
over the ranks once per applied update, before the clip: the update of
the JAX package's step on an `n_data` mesh.

Tensor parallel (`make_train_step(mesh=)` on a mesh with a `model` axis,
its module split by `parallel.tensor.shard_module`): the losses reduce
over the data group, the gradients are summed over the data group only
(a split parameter's within its slice), and the clip's global norm sums
each split gradient's squares over the model group and each replicated
one's once. AdamW's moments and the EMA are split like their parameters
(the JAX package replicates them; the numbers are the same).
"""
from __future__ import annotations

import inspect
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.parallel.mesh import Mesh
from open_genie_tpu_torch.parallel.tensor import local_state, split_of
from open_genie_tpu_torch.utils.debug import span

Schedule = Union[float, Callable[[int], float]]


class AdamW:
    """The JAX package's `make_optimizer` chain over `module`'s parameters.

    Per call of `step()` (after a backward): with `accum_steps > 1` the
    trainable gradients join a running mean (`optax.MultiSteps`), and only
    every `accum_steps`-th call applies an update, with the mean. An update
    scales the gradients by `grad_clip / norm` when their global norm
    reaches `grad_clip` (optax's rule; torch's `clip_grad_norm_` adds 1e-6
    to the norm), then `torch.optim.AdamW` steps with decoupled weight
    decay at the rate `lr(updates)`, `updates` counting the applied updates
    before it (optax's schedule count). Then the EMA, if any, takes
    `decay * ema + (1 - decay) * param` over every parameter, frozen ones
    too (optax chains it after the freeze). A trainable parameter without a
    gradient steps as with a zero one, as optax's would.

    With a data-parallel `group`, an applied call first sums the gradients
    it applies (after accumulation) over the ranks, in flat buckets: each
    rank's gradients are its share of the global loss's, so the sum is the
    global gradient, and its norm is the one clipped and returned. With a
    `model_group` as well, the norm adds the split gradients' squares of
    every model rank (`_global_norm`).
    """

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 trainable: Mapping[str, bool], lr: Schedule, weight_decay: float,
                 b1: float, b2: float, grad_clip: Optional[float],
                 ema_decay: Optional[float] = None, accum_steps: int = 1):
        named = list(named_params)
        self.params = [p for n, p in named if trainable[n]]
        self.lr = lr if callable(lr) else (lambda step, lr=lr: lr)
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.lr(0), betas=(b1, b2), eps=1e-8, weight_decay=weight_decay
        )
        self.updates = 0
        self.last_lr: Optional[float] = None
        self.accum_steps = max(1, int(accum_steps or 1))
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.accum_steps > 1 else None)
        self.ema_decay = ema_decay
        self.named = named  # every parameter, frozen ones too: the EMA's
        self.ema = ({n: p.detach().clone() for n, p in named}
                    if ema_decay is not None else None)

    @torch.no_grad()
    def step(self, group=None, model_group=None) -> Optional[torch.Tensor]:
        """Accumulate and, on an applied call, reduce over `group`, clip
        and apply the gradients; returns this call's gradient norm before
        clipping. With accumulation on more than one rank, a call that
        applies nothing reduces nothing and returns None, and an applied
        one returns the norm of the reduced mean it applies."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        split = [split_of(p) is not None for p in self.params]

        def global_norm(tensors):
            return _global_norm(tensors, split, model_group)

        if self.acc is not None:
            norm = None if collectives.reduces(group) else global_norm(grads)
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < self.accum_steps - 1:
                self.mini_step += 1
                return norm
            for a, g in zip(self.acc, grads):
                g.copy_(a)
                a.zero_()
            self.mini_step = 0
            collectives.all_reduce_tensors_(grads, group)
            clip_norm = global_norm(grads)
            norm = clip_norm if norm is None else norm
        else:
            collectives.all_reduce_tensors_(grads, group)
            norm = clip_norm = global_norm(grads)
        if self.grad_clip:
            scale = torch.where(clip_norm < self.grad_clip, 1.0, self.grad_clip / clip_norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        self.last_lr = float(self.lr(self.updates))
        for group in self.adamw.param_groups:
            group["lr"] = self.last_lr
        self.adamw.step()
        self.updates += 1
        if self.ema is not None:
            for n, p in self.named:
                self.ema[n].mul_(self.ema_decay).add_(p.detach(), alpha=1.0 - self.ema_decay)
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "updates": self.updates,
                "last_lr": self.last_lr, "mini_step": self.mini_step, "acc": self.acc,
                "ema": self.ema}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.updates, self.last_lr = state["updates"], state["last_lr"]
        self.mini_step = state["mini_step"]
        for name in ("acc", "ema"):
            mine, saved = getattr(self, name), state[name]
            if (mine is None) != (saved is None):
                raise ValueError(f"checkpoint {name} is {'absent' if saved is None else 'present'}"
                                 f" but this optimizer's is not")
            if mine is not None:
                pairs = zip(mine, saved) if name == "acc" else (
                    (mine[k], saved[k]) for k in mine)
                for dst, src in pairs:
                    dst.copy_(src)


def _global_norm(tensors, split=None, model_group=None) -> torch.Tensor:
    """optax's `global_norm`: the 2-norm of every element, in f32. With a
    `model_group`, the tensors flagged in `split` are this rank's slices:
    their squares are summed over the group, the others' counted once."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    if not collectives.reduces(model_group):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square()
    mine = torch.tensor(split, device=sq.device)
    parts = torch.stack([sq[mine].sum(), sq[~mine].sum()])
    return (collectives.all_reduce_f32(parts[:1], model_group)[0] + parts[1]).sqrt()


def make_optimizer(
    module: nn.Module,
    lr: Schedule = 1e-3,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    grad_clip: Optional[float] = 1.0,
    frozen_mask: Optional[Mapping[str, bool]] = None,
    ema_decay: Optional[float] = None,
    accum_steps: int = 1,
) -> AdamW:
    """AdamW over `module`'s trainable parameters (`frozen_mask`:
    `{name: trainable}`, see `train.losses.frozen_param_mask`); `lr` a
    float or a schedule `lr(step) -> float` (`OptimizerConfig.schedule()`).
    Frozen parameters get `requires_grad=False` and never change."""
    named = list(module.named_parameters())
    trainable = {n: True if frozen_mask is None else bool(frozen_mask[n]) for n, _ in named}
    for n, p in named:
        p.requires_grad_(trainable[n])
    return AdamW(named, trainable, lr, weight_decay, b1, b2, grad_clip, ema_decay, accum_steps)


@dataclass
class TrainState:
    """What a training run carries from step to step: the module, its
    optimizer (which holds the EMA and the accumulation buffers), the
    generator that the stochastic losses draw from, and `step`, the count
    of train-step calls (micro-steps included, as JAX's `state.step`).

    On more than one rank, `generator` is this rank's own and
    `shared_generator`, in the same state on every rank, draws what is one
    draw per global batch (the dynamics' mask rate); `rank_generators`, the
    states of every rank's `generator` gathered before a save, go into the
    checkpoint that rank 0 writes."""

    module: nn.Module
    optimizer: AdamW
    generator: Optional[torch.Generator] = None
    step: int = 0
    shared_generator: Optional[torch.Generator] = None
    rank_generators: Optional[list] = None

    @property
    def ema(self) -> Optional[Dict[str, torch.Tensor]]:
        return self.optimizer.ema

    @property
    def accum(self) -> Optional[list]:
        return self.optimizer.acc

    def train_state_dict(self) -> Dict[str, Any]:
        """Everything but the parameters."""
        out = {"step": self.step, "optimizer": self.optimizer.state_dict(),
               "generator": None if self.generator is None else self.generator.get_state()}
        if self.shared_generator is not None:
            out["shared_generator"] = self.shared_generator.get_state()
        if self.rank_generators is not None:
            out["rank_generators"] = self.rank_generators
        return out


def _cast_batch(batch: Any, dtype: torch.dtype) -> Any:
    """Cast the float tensors of a batch (a tensor, or any nesting of
    dicts, lists and tuples of them) to `dtype`; integer tensors (token and
    action ids) pass through."""
    if isinstance(batch, Mapping):
        return {k: _cast_batch(v, dtype) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_cast_batch(v, dtype) for v in batch)
    if isinstance(batch, torch.Tensor) and batch.is_floating_point():
        return batch.to(dtype)
    return batch


def compute_params(module: nn.Module, compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """`module`'s parameters with each f32 one cast to `compute_dtype`
    (through autograd where gradients are on), for `functional_call`."""
    return {n: p.to(compute_dtype) if p.dtype == torch.float32 else p
            for n, p in module.named_parameters()}


def takes_kwarg(module: nn.Module, name: str) -> bool:
    return name in inspect.signature(module.forward).parameters


class _LossAndBackward(nn.Module):
    """Runs `module(batch, **kwargs)` and the backward of its loss in one
    call, so that under `functional_call` the bf16 parameter copies are
    still in place when activation checkpointing recomputes a layer during
    the backward. With a data-parallel `group` the loss is the global
    batch's, held by every rank (`collectives.backward`)."""

    def __init__(self, module: nn.Module, group=None):
        super().__init__()
        self.module = module
        self.group = group

    def forward(self, batch, kwargs):
        with span("train.forward"):
            loss, metrics = self.module(batch, **kwargs)
            loss = loss.float()
        with span("train.backward"):
            collectives.backward(loss, self.group)
        return loss.detach(), metrics


def make_train_step(
    state: Union[TrainState, nn.Module],
    optimizer: Optional[AdamW] = None,
    compute_dtype: Optional[torch.dtype] = None,
    loss_kwargs: Optional[Dict[str, Any]] = None,
    mesh: Mesh = Mesh(1),
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build `step(batch, **kwargs) -> metrics`: one forward, backward and
    optimizer call of `module(batch, **loss_kwargs, **kwargs)`, which
    returns `(loss, metrics)`, on `state` (or on a new `TrainState` of a
    module and its optimizer); the state is `step.state`.

    Callable `loss_kwargs` values are step schedules, evaluated on
    `state.step` before the call (an LFQ weight anneal, the GAN branch of
    alternating steps). A module whose forward takes `generator` gets the
    state's generator unless the call passes one. With
    `compute_dtype=torch.bfloat16` ("16-mixed"), the forward runs on bf16
    copies of the f32 parameters, made through autograd so the gradients
    arrive in f32, on a batch whose float leaves are cast to bf16. Metrics
    are detached tensors: the module's, plus `loss` (f32) and `grad_norm`
    (this call's global norm over the trainable parameters, before
    clipping; see `AdamW.step` for accumulation on several ranks).

    On a `mesh` of several ranks (`parallel.mesh.make_mesh` inside the
    run), every rank calls the step on its data shard's rows of the global
    batch: the module gets the mesh's data group as `group` (its losses
    and metrics are then the global batch's) and, where the state has
    one, `rate_generator=state.shared_generator`; the optimizer sums the
    gradients over the data group. Building the step broadcasts the first
    data shard's parameters, buffers and EMA to the other shards (rank
    `model_index`, whose slices match). On a mesh with a `model` axis the
    module is split (`parallel.tensor.shard_module`) and the gradient norm
    spans the model group (`AdamW.step`).
    """
    if not isinstance(state, TrainState):
        state = TrainState(state, optimizer)
    module, optimizer = state.module, state.optimizer
    loss_kwargs = dict(loss_kwargs or {})
    group, model_group = mesh.data_group, mesh.model_group
    run = _LossAndBackward(module, group)
    pass_generator = takes_kwarg(module, "generator")
    pass_group = group is not None and takes_kwarg(module, "group")
    pass_rate = takes_kwarg(module, "rate_generator")
    if group is not None:
        with torch.no_grad():
            collectives.broadcast_tensors_(
                [t.detach() for t in (*module.parameters(), *module.buffers())]
                + list((optimizer.ema or {}).values()), group, mesh.model_index)

    def step(batch, **kwargs) -> Dict[str, torch.Tensor]:
        kwargs = {**{k: v(state.step) if callable(v) else v for k, v in loss_kwargs.items()},
                  **kwargs}
        if pass_generator and state.generator is not None:
            kwargs.setdefault("generator", state.generator)
        if pass_group:
            kwargs.setdefault("group", group)
        if pass_rate and state.shared_generator is not None:
            kwargs.setdefault("rate_generator", state.shared_generator)
        if compute_dtype is None:
            loss, metrics = run(batch, kwargs)
        else:
            params = {f"module.{n}": p for n, p in compute_params(module, compute_dtype).items()}
            loss, metrics = functional_call(
                run, params, (_cast_batch(batch, compute_dtype), kwargs)
            )
        with span("train.optimizer"):
            grad_norm = optimizer.step(group, model_group)
            optimizer.zero_grad()
        state.step += 1
        out = {k: v.detach() if isinstance(v, torch.Tensor) else torch.tensor(v)
               for k, v in metrics.items()}
        out["loss"] = loss
        if grad_norm is not None:
            out["grad_norm"] = grad_norm
        return out

    step.state = state
    return step


# --------------------------------------------------------------------- #
# Checkpoints: <ckpt_dir>/<step>/{params.pt, train_state.pt}
# --------------------------------------------------------------------- #

PARAMS_FILE, STATE_FILE = "params.pt", "train_state.pt"


def all_steps(ckpt_dir: str) -> list:
    """The steps checkpointed under `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> float:
    """One-shot save; returns its seconds."""
    writer = CheckpointWriter(ckpt_dir)
    try:
        return writer.save(state, step)
    finally:
        writer.close()


class CheckpointWriter:
    """Writes a run's checkpoints into one directory.

    Each save writes `<step>/params.pt` (the module's `state_dict`) and
    `<step>/train_state.pt` (step, optimizer with EMA and accumulation,
    generator) into a temporary directory, then renames it into place, so
    a reader never sees half a checkpoint. A save replaces an existing
    checkpoint of the same step (a stale one from an earlier run must not
    survive), and `max_to_keep` removes the oldest steps after it. The
    write blocks the caller; `close()` has nothing pending."""

    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        self.dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep

    def save(self, state: TrainState, step: Optional[int] = None,
             payload: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None) -> float:
        """Write `state` as step `step` (default `state.step`), or the
        `(params, train_state)` of `payload` in its place (a split state
        gathered into the one-process layout, `parallel.tensor.gather_state`);
        returns the seconds the write took."""
        t0 = time.perf_counter()
        step = state.step if step is None else int(step)
        os.makedirs(self.dir, exist_ok=True)
        final = os.path.join(self.dir, str(step))
        tmp = os.path.join(self.dir, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        params, train_state = payload or (state.module.state_dict(), state.train_state_dict())
        torch.save(params, os.path.join(tmp, PARAMS_FILE))
        torch.save(train_state, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(final):
            old = os.path.join(self.dir, f".old-{step}")
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        if self.max_to_keep:
            for s in all_steps(self.dir)[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.dir, str(s)))
        return time.perf_counter() - t0

    def purge(self) -> int:
        """Delete every step in the directory; returns the count (a fresh
        run must not leave an earlier run's later steps to be restored)."""
        steps = all_steps(self.dir)
        for s in steps:
            shutil.rmtree(os.path.join(self.dir, str(s)))
        return len(steps)

    def close(self) -> None:
        """Writes are synchronous: nothing to drain."""


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, params_only: bool = False
                    ) -> Tuple[Dict[str, Any], int]:
    """`({"params": state_dict[, "train_state": ...]}, step)` of step
    `step` (default the latest) on the CPU; raises `FileNotFoundError`
    when there is none."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(step))
    out = {"params": torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                                weights_only=True)}
    if not params_only:
        out["train_state"] = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                                        weights_only=True)
    return out, step


def restore_params(ckpt_dir: str, module: nn.Module) -> Tuple[nn.Module, int]:
    """Load the latest checkpoint's parameters (only) into `module`;
    `(module, step)`, step 0 and the module untouched when there is none.
    For inference and evaluation: the optimizer's layout need not match."""
    if latest_step(ckpt_dir) is None:
        return module, 0
    ckpt, step = load_checkpoint(ckpt_dir, params_only=True)
    module.load_state_dict(ckpt["params"])
    return module, step


def restore_checkpoint(ckpt_dir: str, state: TrainState, mesh: Mesh = Mesh(1)
                       ) -> Tuple[TrainState, int]:
    """Restore the latest checkpoint into `state` in place: parameters,
    optimizer (EMA, accumulation), generator and step; `(state, step)`,
    step 0 and the state untouched when there is none. Rank `mesh.rank`
    takes its own generator's state from a checkpoint of a run as wide; a
    mesh of one data shard (one process, or one row of model ranks) takes
    rank 0's, whose stream is one process's; any other keeps the one it
    has. A state split over the mesh's model axis loads its slices of the
    checkpoint, which holds the one-process layout whatever mesh wrote
    it."""
    if latest_step(ckpt_dir) is None:
        return state, 0
    ckpt, step = load_checkpoint(ckpt_dir)
    params, saved = local_state(state, ckpt["params"], ckpt["train_state"], mesh)
    state.module.load_state_dict(params)
    state.optimizer.load_state_dict(saved["optimizer"])
    gens = saved.get("rank_generators")
    mine = (gens[mesh.rank] if gens is not None and len(gens) == mesh.world
            else saved["generator"] if mesh.n_data == 1 else None)
    if state.generator is not None and mine is not None:
        state.generator.set_state(mine)
    if state.shared_generator is not None and saved.get("shared_generator") is not None:
        state.shared_generator.set_state(saved["shared_generator"])
    state.step = saved["step"]
    return state, step
