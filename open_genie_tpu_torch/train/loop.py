"""The train step (twin of `open_genie_tpu.train.loop`'s `make_optimizer`
and `make_train_step`).

AdamW with optax's gradient clipping by global norm over the trainable
parameters, and the bf16 compute policy of "16-mixed": f32 master weights
and optimizer state, each f32 parameter cast to bf16 through autograd for
the forward, float batch leaves cast to bf16. The trainer loop, EMA,
gradient accumulation, LR schedules and checkpoints are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn
from torch.func import functional_call


class AdamW:
    """`optax.chain(clip_by_global_norm(grad_clip), adamw(...))` over the
    trainable parameters: gradients are scaled by `grad_clip / norm` when
    their global norm reaches `grad_clip` (optax's rule; torch's
    `clip_grad_norm_` adds 1e-6 to the norm), then `torch.optim.AdamW`
    steps with decoupled weight decay on every trainable parameter. A
    trainable parameter without a gradient steps as with a zero one, as
    optax's would."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float, weight_decay: float,
                 b1: float, b2: float, grad_clip: Optional[float]):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay
        )

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip and apply the gradients; returns their global norm before
        clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(  # optax's global_norm
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        if self.grad_clip:
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        self.adamw.step()
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


def make_optimizer(
    module: nn.Module,
    lr: float = 1e-3,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    grad_clip: Optional[float] = 1.0,
    frozen_mask: Optional[Mapping[str, bool]] = None,
) -> AdamW:
    """AdamW over `module`'s trainable parameters (`frozen_mask`:
    `{name: trainable}`, see `train.losses.frozen_param_mask`). Frozen
    parameters get `requires_grad=False` and never change."""
    params = []
    for name, p in module.named_parameters():
        trainable = True if frozen_mask is None else bool(frozen_mask[name])
        p.requires_grad_(trainable)
        if trainable:
            params.append(p)
    return AdamW(params, lr, weight_decay, b1, b2, grad_clip)


def _cast_batch(batch: Any, dtype: torch.dtype) -> Any:
    """Cast the float tensors of a batch (a tensor or a dict of them) to
    `dtype`; integer tensors (token and action ids) pass through."""
    if isinstance(batch, Mapping):
        return {k: _cast_batch(v, dtype) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) and batch.is_floating_point():
        return batch.to(dtype)
    return batch


class _LossAndBackward(nn.Module):
    """Runs `module(batch, **kwargs)` and the backward of its loss in one
    call, so that under `functional_call` the bf16 parameter copies are
    still in place when activation checkpointing recomputes a layer during
    the backward."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, batch, kwargs):
        loss, metrics = self.module(batch, **kwargs)
        loss = loss.float()
        loss.backward()
        return loss.detach(), metrics


def make_train_step(
    module: nn.Module,
    optimizer: AdamW,
    compute_dtype: Optional[torch.dtype] = None,
    loss_kwargs: Optional[Dict[str, Any]] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build `step(batch, **kwargs) -> metrics`: one forward, backward and
    optimizer update of `module(batch, **loss_kwargs, **kwargs)`, which
    returns `(loss, metrics)`.

    With `compute_dtype=torch.bfloat16` ("16-mixed"), the forward runs on
    bf16 copies of the f32 parameters, made through autograd so the
    gradients arrive in f32, on a batch whose float leaves are cast to bf16.
    Metrics are detached tensors: the module's, plus `loss` (f32) and
    `grad_norm` (the global norm before clipping).
    """
    loss_kwargs = dict(loss_kwargs or {})
    run = _LossAndBackward(module)

    def step(batch, **kwargs) -> Dict[str, torch.Tensor]:
        kwargs = {**loss_kwargs, **kwargs}
        if compute_dtype is None:
            loss, metrics = run(batch, kwargs)
        else:
            params = {
                f"module.{n}": p.to(compute_dtype) if p.dtype == torch.float32 else p
                for n, p in module.named_parameters()
            }
            loss, metrics = functional_call(
                run, params, (_cast_batch(batch, compute_dtype), kwargs)
            )
        grad_norm = optimizer.step()
        optimizer.zero_grad()
        out = {k: v.detach() if isinstance(v, torch.Tensor) else torch.tensor(v)
               for k, v in metrics.items()}
        out["loss"] = loss
        out["grad_norm"] = grad_norm
        return out

    return step
