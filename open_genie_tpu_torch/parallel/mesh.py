"""The mesh, batch placement and tensor-parallel rules (twin of
`open_genie_tpu.parallel.mesh`).

The JAX package runs one program over a `(data, model)` mesh of devices
and lets GSPMD insert the collectives. The port runs one process per
device, as the reference's Lightning DDP does: a rank holds its rows of
the global batch (the ranks' local batches concatenated in rank order, as
`make_array_from_process_local_data` assembles JAX's global array), and
`collectives.py` reduces what the loss needs across the ranks.

  * data parallel: `init_distributed` joins the ranks, `make_mesh` names
    the axes, the loaders feed each rank a disjoint stride of the data
    (`trainer.build_loader`), the train step all-reduces the gradients by
    sum (`train.loop.make_train_step(mesh=)`).
  * tensor parallel: `TP_RULES` / `param_shardings` say which axis of each
    parameter the `model` axis splits (the JAX package's rules in the
    port's names and layouts); `parallel/tensor.py` places each rank's
    slices and the split modules run them with the `model` group's
    collectives (`collectives.copy_to_model` and its kin).

Rank `r` of an `(n_data, n_model)` mesh sits at `(r // n_model, r %
n_model)`, as the JAX package's `reshape(n_data, n_model)` of its
devices: the ranks of one data shard are consecutive.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join this process to a run of `num_processes` ranks.

    The arguments, or the JAX package's variables `OGT_COORDINATOR`
    (`host:port` of rank 0's rendezvous), `OGT_NUM_PROCESSES` and
    `OGT_PROCESS_ID`, name the run; `torch.distributed.init_process_group`
    joins it over `tcp://<coordinator>`. `backend` defaults to NCCL
    for a CUDA `device` (the default) and gloo for the CPU. Returns False when nothing is configured: one process, as the
    JAX package's own single-process meaning. True when the process is
    in a run (this call joined it, or an earlier one did).
    """
    coordinator_address = coordinator_address or os.environ.get("OGT_COORDINATOR")
    if num_processes is None and os.environ.get("OGT_NUM_PROCESSES"):
        num_processes = int(os.environ["OGT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("OGT_PROCESS_ID"):
        process_id = int(os.environ["OGT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        if num_processes is not None and dist.get_world_size() != num_processes:
            raise RuntimeError(f"this process is in a run of {dist.get_world_size()} ranks, "
                               f"not {num_processes}")
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a distributed run needs the coordinator address, the number of "
                         "processes and this process's id (OGT_COORDINATOR, "
                         "OGT_NUM_PROCESSES, OGT_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


@dataclass(frozen=True)
class Mesh:
    """A `(data, model)` mesh of ranks, one device each. `rank` is this
    process's; `group` the process group of the run, None in one process
    (a mesh of several ranks without one describes a rank of it, as a
    one-process reference of a run rebuilds each rank's loader).

    `data_group` joins the ranks that hold the same slices of the weights
    and different rows of the batch (this rank's column of the mesh: the
    gradients and the losses' batch statistics reduce over it);
    `model_group` the ranks of this rank's data shard, which split the
    weights (its row). Each is None where it would hold one rank."""

    n_data: int
    n_model: int = 1
    rank: int = 0
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def world(self) -> int:
        """The mesh's ranks."""
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        """This rank's data shard: its row of the mesh."""
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        """This rank's slice of the split weights: its column."""
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              world: Optional[int] = None) -> Mesh:
    """A `(data, model)` mesh over the run's ranks (`world`, default the
    run's size, 1 outside a run), one device a rank; `n_data=None` takes
    every rank. More ranks than the run has raises; fewer take the leading
    ranks, as the JAX package takes the leading devices (a `model` axis
    above 1 must then span the whole run).

    In a run, every rank creates every data and model group, in the same
    order (`torch.distributed.new_group` is collective); a group that
    spans the run is the run's own group."""
    joined = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if joined else 1
    if n_data is None:
        n_data = world // n_model
    want = n_data * n_model
    if want > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {want} devices, have {world}")
    if not joined:
        return Mesh(n_data, n_model)
    rank = dist.get_rank()
    if n_model == 1:  # data parallel: the run's group is the data group
        return Mesh(n_data, 1, rank, dist.group.WORLD, dist.group.WORLD)
    if want != world:
        raise ValueError(f"a mesh {n_data}x{n_model} with a model axis must span the run's "
                         f"{world} ranks")
    grid = np.arange(want).reshape(n_data, n_model)
    model_groups = [_group(row.tolist(), world) for row in grid]
    data_groups = [_group(col.tolist(), world) for col in grid.T]
    return Mesh(n_data, n_model, rank, dist.group.WORLD,
                data_groups[rank % n_model], model_groups[rank // n_model])


def _group(ranks, world: int):
    """The process group of `ranks` (created on every rank); None for one
    rank, the run's own group for all of them."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def rank_device(device, mesh: Mesh) -> torch.device:
    """This rank's device: rank `r` of a run takes `cuda:{r % device_count}`
    when `device` names no card, and makes it current; otherwise `device`."""
    device = torch.device(device)
    if mesh.group is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", mesh.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def rank_seed(seed: int, mesh: Mesh) -> int:
    """The seed of this rank's per-sample noise (frame picks, Gumbel,
    Bernoulli masks, dropout): one stream a data shard, all apart from
    `seed`'s, and `seed` itself where the mesh has one data shard (one
    process, or one row of model ranks, whose noise is then one
    process's). Keyed on the data index, so the model ranks of a shard
    draw the same noise for the same rows and their replicated
    activations stay equal."""
    if mesh.n_data == 1:
        return seed
    return int(np.random.SeedSequence([seed, mesh.data_index]).generate_state(
        1, np.uint64)[0] >> 1)


@dataclass(frozen=True)
class BatchSharding:
    """Rank `index` of `count` holds the `index`-th of `count` equal blocks
    of rows of a global batch."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a global batch of {n} does not divide over {self.count} ranks")
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """The leading (batch) axis split over `data`."""
    return BatchSharding(mesh.data_index, mesh.n_data)


def replicated(mesh: Mesh) -> BatchSharding:
    """Every rank holds the whole batch."""
    return BatchSharding(0, 1)


Batch = Union[torch.Tensor, Mapping, Sequence]


def _tree_map(fn, batch):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, Mapping):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return type(batch)(_tree_map(fn, v) for v in batch)


def place_batch(batch: Batch, sharding: BatchSharding, device=None) -> Batch:
    """The rows of a global `batch` (a tensor, or dicts / lists / tuples of
    them) that `sharding` gives this rank, on `device`."""
    return _tree_map(lambda t: t[sharding.rows(t.shape[0])].to(device), batch)


def global_batch(local_batches: Sequence[Batch]) -> Batch:
    """The global batch of the ranks' local batches, given in rank order:
    their rows concatenated."""
    first = local_batches[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(list(local_batches))
    if isinstance(first, Mapping):
        return {k: global_batch([b[k] for b in local_batches]) for k in first}
    return type(first)(global_batch(parts) for parts in zip(*local_batches))


# Tensor-parallel rules on the port's parameter names, the JAX package's
# `TP_RULES` in torch's layouts (an nn.Linear weight is (out, in), a conv3d
# weight (out, in, kt, kh, kw), an embedding (vocab, dim)): (regex, the
# weight's rank, the axis the `model` axis splits, blocks). First match
# wins; no match is replicated. `blocks` > 1 splits each of that many equal
# blocks of the axis (the fused [q | k | v] projection of a self-attention,
# whose three JAX kernels each split their output).
TP_RULES: Tuple[Tuple[str, int, int, int], ...] = (
    (r"(to_q|to_k|to_v)\.weight$", 2, 0, 1),   # column
    (r"to_qkv\.weight$", 2, 0, 3),             # column, per q | k | v
    (r"to_out\.weight$", 2, 1, 1),             # row
    (r"ffn\.block_0\.weight$", 5, 0, 1),       # the FFN's first conv, output
    (r"head\.weight$", 2, 0, 1),               # big vocab head
    (r"tok_emb\.weight$", 2, 1, 1),
    (r"act_emb\.weight$", 2, 1, 1),
)


def param_shardings(params: Union[nn.Module, Mapping[str, torch.Tensor]], mesh: Mesh,
                    rules=TP_RULES) -> Dict[str, Optional[int]]:
    """`{parameter name: the axis the model axis splits, or None}` for a
    module's parameters (or a `{name: tensor}` map), by the first rule
    whose regex matches the name; a rule applies only where the weight has
    the rule's rank and each block of the axis divides by `n_model`, as
    the JAX package's `param_shardings` skips what does not divide."""
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    out = {}
    for name, p in named:
        axis = None
        for pattern, ndim, ax, blocks in rules:
            if re.search(pattern, name):
                if p.ndim >= ndim and p.shape[ax] % (blocks * mesh.n_model) == 0:
                    axis = ax
                break
        out[name] = axis
    return out
