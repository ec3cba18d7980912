"""Tracing, timing and NaN-debug utilities (twin of `open_genie_tpu.utils.debug`).

  * `profile_trace`: context manager around `torch.profiler`, writing a
    Chrome trace (`*.pt.trace.json`, readable by TensorBoard's profiler
    plugin and Perfetto) into `log_dir`; CUDA activity is traced where the
    card is present.
  * `step_timer`: wall-clock timer that synchronizes the devices of the
    tensors it is given before it stops, so asynchronous launches are
    counted.
  * `enable_nan_debug`: autograd's anomaly mode, which raises at the first
    backward op that produces a NaN (the counterpart of `jax_debug_nans`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "logs/profile") -> Iterator[torch.profiler.profile]:
    """Profile the block; its trace lands in `log_dir` on exit."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def step_timer(sync_on=None) -> Iterator[dict]:
    """Time a block into `out["seconds"]`; every CUDA device holding a
    tensor of `sync_on` (a tensor, or dicts, lists and tuples of them) is
    synchronized before the stop timestamp."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if sync_on is not None:
        for dev in {t.device for t in _tensors(sync_on) if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
