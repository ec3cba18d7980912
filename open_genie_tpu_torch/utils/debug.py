"""Tracing and NaN-debug utilities (twin of `open_genie_tpu.utils.debug`).

  * `profile_trace`: context manager around `torch.profiler`, writing a
    Chrome trace (`*.pt.trace.json`, readable by TensorBoard's profiler
    plugin and Perfetto) into `log_dir`; CUDA activity is traced where the
    card is present.
  * `span`: a named range inside the program, on the profiler's clock.
    While a `torch.profiler` records, it opens a `record_function` range
    (so the range sits in the same timeline as the device ops), times the
    block on the current CUDA stream with an event pair and appends it to
    a bounded in-memory record; `span_record` reads that record. With no
    profiler recording it is a shared no-op after one check.
  * `enable_nan_debug`: autograd's anomaly mode, which raises at the first
    backward op that produces a NaN (the counterpart of `jax_debug_nans`).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
from typing import Iterator, List, Optional

import torch
from torch._C._autograd import _profiler_enabled


@contextlib.contextmanager
def profile_trace(log_dir: str = "logs/profile") -> Iterator[torch.profiler.profile]:
    """Profile the block; its trace lands in `log_dir` on exit, after the
    device has finished what the block queued."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()


# Spans: every entry is a dict of `id`, `name`, `parent` (the enclosing
# span's id, None for a root), `step` (its root's id, shared by the spans
# of one step) and the CUDA event pair `start`, `end` (None off CUDA).
_RECORD: collections.deque = collections.deque(maxlen=4096)
_IDS = itertools.count()
_OPEN: list = []  # the entries of the spans open now, outermost first
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """Context manager naming a block of the program for the profiler;
    records nothing unless a `torch.profiler` is recording."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _recorded(name)


def _event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def _recorded(name: str):
    parent = _OPEN[-1] if _OPEN else None
    sid = next(_IDS)
    entry = {"id": sid, "name": name, "parent": None if parent is None else parent["id"],
             "step": sid if parent is None else parent["step"], "start": None, "end": None}
    with torch.profiler.record_function(name):
        entry["start"] = _event()
        _RECORD.append(entry)
        _OPEN.append(entry)
        try:
            yield
        finally:
            _OPEN.pop()
            entry["end"] = _event()


def span_record(last: Optional[int] = None) -> List[dict]:
    """The recorded spans of the `last` latest roots (of all with None),
    oldest first: dicts of `id`, `name`, `parent`, `step` and `device_ms`,
    the event-timed device milliseconds from the span's entry to its exit
    on the stream it entered on (None off CUDA or while it is open). Waits
    for the device where events are pending."""
    entries = list(_RECORD)
    if last is not None:
        roots = [e["id"] for e in entries if e["parent"] is None]
        keep = set(roots[-last:]) if last > 0 else set()
        entries = [e for e in entries if e["step"] in keep]
    if any(e["end"] is not None for e in entries):
        torch.cuda.synchronize()
    return [{"id": e["id"], "name": e["name"], "parent": e["parent"], "step": e["step"],
             "device_ms": None if e["start"] is None or e["end"] is None
             else e["start"].elapsed_time(e["end"])}
            for e in entries]


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
