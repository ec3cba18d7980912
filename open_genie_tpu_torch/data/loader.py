"""Prefetching batch loader: host decode threads -> pinned batches -> device
(twin of `open_genie_tpu.data.loader`).

Worker threads decode items into a bounded window of host batches, served
in order as torch tensors (in pinned memory when asked, so the copy to the
card is asynchronous). `device_prefetch` keeps the next batches' copies in
flight on a side CUDA stream while the current step computes, where the JAX
package calls `device_put`.
"""
from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
import torch


class DatasetShard:
    """Strided per-process view of a dataset: process p of N sees items
    p, p+N, p+2N, ... -- the multi-host equivalent of DDP's per-rank
    sampler split. Wraps any map-style dataset."""

    def __init__(self, dataset, shard: int, num_shards: int) -> None:
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} not in [0, {num_shards})")
        self.dataset = dataset
        self.shard = shard
        self.num_shards = num_shards

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n - self.shard + self.num_shards - 1) // self.num_shards

    def __getitem__(self, i: int):
        return self.dataset[i * self.num_shards + self.shard]


def _to_tensor(array: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(array)
    return t.pin_memory() if pin else t


class BatchLoader:
    """Iterate `(B, T, H, W, C)` float32 batches (or dicts of stacked item
    fields, as token shards give) from a map-style dataset, in the JAX
    package's order: epoch `e` (1 on the first pass) shuffles with
    `np.random.default_rng(seed + e)`."""

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        shuffle: bool = True,
        num_workers: int = 2,
        prefetch: int = 2,
        drop_last: bool = True,
        seed: int = 0,
        pin_memory: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.pin_memory = pin_memory
        self._epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def seek(self, batches: int) -> None:
        """Position the loader as if `batches` batches had been served
        from its first epoch on: the next pass is the epoch they end in,
        from the batch after them (a resumed run continues the data order
        of the run it resumes)."""
        self._epoch, self._skip = divmod(batches, len(self))

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        for i in range(len(self)):
            yield order[i * self.batch_size : (i + 1) * self.batch_size]

    def _collate(self, items):
        if isinstance(items[0], dict):  # token shards etc.
            return {k: _to_tensor(np.stack([it[k] for it in items]), self.pin_memory)
                    for k in items[0]}
        return _to_tensor(np.stack(items), self.pin_memory)

    def __iter__(self) -> Iterator:
        """Bounded in-order prefetch: at most `prefetch + num_workers`
        decoded batches exist at any time (a worker claims an index only
        when its slot is within the window), so host memory is bounded by
        construction rather than by the epoch length. A condition variable
        coordinates workers and the consumer -- no polling. A worker's
        exception is raised to the consumer."""
        self._epoch += 1
        skip, self._skip = self._skip, 0
        pending = list(enumerate(self._batch_indices()))[skip:]
        pending.reverse()  # pop() from the front of the epoch
        window = max(1, self.prefetch) + self.num_workers
        results: dict = {}
        cond = threading.Condition()
        state = {"served": skip, "abort": False, "error": None}

        def worker():
            try:
                while True:
                    with cond:
                        # Claim the next index only once it is inside the
                        # prefetch window; blocks the *claim*, not the
                        # decode, so decoded batches stay bounded.
                        while (
                            pending
                            and pending[-1][0] >= state["served"] + window
                            and not state["abort"]
                        ):
                            cond.wait()
                        if state["abort"] or not pending:
                            return
                        bi, idxs = pending.pop()
                    batch = self._collate([self.dataset[int(i)] for i in idxs])
                    with cond:
                        results[bi] = batch
                        cond.notify_all()
            except Exception as e:  # propagate decode errors to the consumer
                with cond:
                    state["error"] = e
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for served in range(skip, len(self)):
                with cond:
                    while served not in results and state["error"] is None:
                        cond.wait()
                    if state["error"] is not None:
                        raise state["error"]
                    batch = results.pop(served)
                    state["served"] = served + 1
                    cond.notify_all()
                yield batch
        finally:
            with cond:
                state["abort"] = True
                cond.notify_all()


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def device_prefetch(iterator, device, size: int = 2):
    """Keep `size` batches' copies to `device` in flight ahead of the
    consumer: on a CUDA device each copy is issued on a side stream, and a
    batch is handed over once the consumer's stream waits for that stream
    (its tensors recorded on the consumer's stream, so their memory is not
    reused while the step reads them). On the CPU the batches pass
    through."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device)
    buf = []

    def issue(batch):
        with torch.cuda.stream(copy_stream):
            buf.append(_tree_map(lambda t: t.to(device, non_blocking=True), batch))

    it = iter(iterator)
    for batch in it:
        issue(batch)
        if len(buf) >= size:
            break
    while buf:
        nxt = buf.pop(0)
        consumer = torch.cuda.current_stream(device)
        consumer.wait_stream(copy_stream)
        _tree_map(lambda t: t.record_stream(consumer), nxt)
        batch = next(it, None)
        if batch is not None:
            issue(batch)
        yield nxt

