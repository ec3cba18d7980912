"""Experiment entry points: config + data + loop for each training stage
(twin of `open_genie_tpu.train.trainer`), called by `open_genie_tpu_torch.cli`.

`train_tokenizer`, `train_action`, `train_dynamics` and `train_genie` take
an `ExperimentConfig` and run on `device` ("cuda" unless the caller asks
for the CPU). Launched once per rank with the `OGT_*` variables
(`parallel.mesh.init_distributed`), they train over a `(trainer.n_data,
trainer.n_model)` mesh of ranks, one device each (`cuda:{rank %
device_count}`): each data shard loads its stride of the data and the
step is the global batch's; with `n_model` above 1 the ranks of a shard
split the weights (`parallel.tensor.shard_module`: tensor parallelism).
Rank 0 alone logs and writes checkpoints, in the one-process layout.
Weights start from `trainer.seed` (`utils.init_weights`), then from the
warm-start checkpoints the config names, whole on every rank, before
each rank keeps its slices. Checkpoints, validation, logging and the
profiler window follow the JAX package's loop (`_run_loop`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from open_genie_tpu_torch.data.loader import BatchLoader, DatasetShard, device_prefetch
from open_genie_tpu_torch.data.video import Platformer2D, SyntheticVideo
from open_genie_tpu_torch.parallel import collectives
from open_genie_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    rank_device,
    rank_seed,
    replicated,
)
from open_genie_tpu_torch.parallel.tensor import gather_params, gather_state, shard_module
from open_genie_tpu_torch.train.config import (
    DynamicsModelConfig,
    ExperimentConfig,
    GenieModelConfig,
    TokenizerModelConfig,
)
from open_genie_tpu_torch.train.loop import (
    CheckpointWriter,
    TrainState,
    _cast_batch,
    compute_params,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
    restore_params,
    takes_kwarg,
)
from open_genie_tpu_torch.train.losses import (
    ActionTrainModule,
    DynamicsTrainModule,
    GenieTrainModule,
    TokenizerTrainModule,
    frozen_param_mask,
)
from open_genie_tpu_torch.train.metrics import MetricLogger
from open_genie_tpu_torch.utils import debug, init_weights

def resolve_device(device, what: str = "training") -> torch.device:
    """`device` as a `torch.device`; a CUDA device without CUDA raises (no
    silent fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA is not available; pass device='cpu' "
                           "(cli: --device cpu) to run on the CPU")
    return device


def setup_mesh(tcfg, device) -> Tuple[Mesh, torch.device]:
    """`(mesh, this rank's device)`: the run the `OGT_*` variables name
    joined (none: one process), as the JAX trainer's `init_distributed()`
    and `make_mesh(n_data, n_model)`. One process a rank of the mesh:
    `n_data x n_model` (`n_data` None: every rank over `n_model`) above the
    run's ranks raises JAX's oversubscription message, below them raises.
    On more than one data shard the global RNG (dropout) is seeded per
    shard, the same on the model ranks of one; with one data shard it is
    left as one process leaves it."""
    n_model = tcfg.n_model or 1
    init_distributed(device=device)
    mesh = make_mesh(tcfg.n_data, n_model)
    ranks = collectives.world_size(mesh.group)
    if mesh.world != ranks:
        raise ValueError(f"trainer.n_data={tcfg.n_data} x n_model={n_model} on {ranks} "
                         "processes: the port runs one process a rank of the mesh (launch "
                         "n_data x n_model, or unset n_data)")
    if mesh.n_data > 1:
        torch.manual_seed(rank_seed(tcfg.seed, mesh))
    return mesh, rank_device(device, mesh)


def build_dataset(cfg, split: str = "train") -> object:
    if cfg.source == "synthetic" or not cfg.root:
        return SyntheticVideo(
            num_videos=cfg.num_videos if split == "train"
            else max(1, cfg.num_videos // 8),
            num_frames=cfg.num_frames,
            height=cfg.height,
            width=cfg.width,
            seed=0 if split == "train" else 1,
        )
    if cfg.source == "gvid":
        from open_genie_tpu_torch.data.native import GVidDataset

        # <root>/<split>.gvid, or a single file that serves both splits
        path = cfg.root
        if os.path.isdir(path):
            path = os.path.join(path, f"{split}.gvid")
        return GVidDataset(path, num_frames=cfg.num_frames)
    if cfg.source == "tokens":
        from open_genie_tpu_torch.data.tokens import TokenClipDataset

        return TokenClipDataset(cfg.root, split=split)
    if cfg.source == "kinetics":
        from open_genie_tpu_torch.data.kinetics import KineticsFolder

        return KineticsFolder(
            root=cfg.root,
            split=split if split != "valid" else "val",
            frames_per_clip=cfg.num_frames,
            step_between_clips=cfg.step_between_clips,
            frame_rate=cfg.frame_rate,
            num_classes=cfg.num_classes,
            randomize=cfg.randomize,
        )
    return Platformer2D(
        root=cfg.root,
        env_name=cfg.env_name,
        split=split,
        padding=cfg.padding,
        randomize=cfg.randomize,
        num_frames=cfg.num_frames,
    )


def _sample_batch_shape(dataset, cfg) -> tuple:
    """Batch shape `(B, T, H, W, C)` from a REAL dataset item (file-backed
    sources yield whatever resolution is on disk); the config's shape when
    the dataset cannot be peeked."""
    try:
        item = dataset[0]
        t, h, w, c = item.shape[-4:]
        return (cfg.data.batch_size, t, h, w, c)
    except (IndexError, NotImplementedError):
        pass  # expected: empty/peek-less sources honor the config
    except Exception as e:  # noqa: BLE001 -- fall back, but say why
        print(
            f"# WARNING: dataset peek failed ({type(e).__name__}: {e}); "
            "falling back to config shapes -- a corrupt source will "
            "resurface as a shape error on the first real batch",
            file=sys.stderr,
        )
    return (
        cfg.data.batch_size, cfg.data.num_frames,
        cfg.data.height, cfg.data.width, 3,
    )


def _check_action_frames(latent_action: dict, dataset, cfg) -> None:
    """The port sizes the latent action's `to_act` from `inp_shape` (flax
    infers it from the first batch): frames of another size cannot train
    it, so say so before any step."""
    shape = _sample_batch_shape(dataset, cfg)[2:4]
    want = tuple(latent_action.get("inp_shape", (64, 64)))
    if tuple(shape) != want:
        raise ValueError(f"latent_action.inp_shape {want} does not match the data's "
                         f"{tuple(shape)} frames")


def build_loader(cfg, dataset, device, split: str = "train", mesh: Mesh = Mesh(1)):
    """Batch loader for a dataset: the C++ prefetcher for a .gvid source
    (`data/native.py`, `data.num_workers` threads), `BatchLoader`'s decode
    threads otherwise; shuffled train batches, validation batches of
    `min(batch_size, len(dataset))` in order, pinned host memory for a
    CUDA device.

    On a `mesh` of more than one rank (the JAX package's multi-process
    loader): validation batches round down to a multiple of `n_data` (a
    val set smaller than `n_data` gives every rank the same whole batches,
    JAX's small-val-set branch); the global batch must divide over the
    ranks, and each rank loads its share of it from its stride of the
    dataset (`DatasetShard`), over the longest prefix that divides by the
    ranks, so that every rank serves as many batches. A sharded `.gvid`
    source is no `GVidDataset` and takes `BatchLoader`, as JAX's does."""
    from open_genie_tpu_torch.data.native import GVidDataset, NativeBatchLoader

    train = split == "train"
    batch_size = cfg.data.batch_size
    sharding = batch_sharding(mesh)
    if not train:
        batch_size = min(batch_size, len(dataset))
        rounded = batch_size - batch_size % mesh.n_data
        if rounded == 0:
            sharding = replicated(mesh)  # val set smaller than the data axis
        else:
            batch_size = rounded
    ranks = sharding.count
    if ranks > 1:
        if batch_size % ranks:
            raise ValueError(f"global batch {batch_size} must divide over {ranks} processes")
        even = len(dataset) - len(dataset) % ranks
        if even < len(dataset):
            dataset = torch.utils.data.Subset(dataset, range(even))
        dataset = DatasetShard(dataset, sharding.index, ranks)
        batch_size //= ranks
    pin = torch.device(device).type == "cuda"
    if isinstance(dataset, GVidDataset):
        return NativeBatchLoader(dataset, batch_size=batch_size, shuffle=train,
                                 num_threads=cfg.data.num_workers, seed=cfg.trainer.seed,
                                 pin_memory=pin)
    return BatchLoader(
        dataset,
        batch_size=batch_size,
        shuffle=train,
        num_workers=cfg.data.num_workers,
        seed=cfg.trainer.seed,
        pin_memory=pin,
    )


def _opt_kwargs(ocfg) -> dict:
    """OptimizerConfig -> make_optimizer kwargs (schedule resolved)."""
    return dict(
        lr=ocfg.schedule(),
        weight_decay=ocfg.weight_decay,
        b1=ocfg.b1,
        b2=ocfg.b2,
        grad_clip=ocfg.grad_clip,
        ema_decay=ocfg.ema_decay,
        accum_steps=ocfg.accum_steps,
    )


def _compute_dtype(precision: str) -> Optional[torch.dtype]:
    return torch.bfloat16 if str(precision).startswith("16") else None


def _entropy_anneal_kwargs(mcfg) -> dict:
    """loss_kwargs for the LFQ anneals (empty dict = no anneal):
    `entropy_scale` ramps 1 -> 0 linearly over `lfq_entropy_anneal_steps`
    from `lfq_entropy_anneal_start`, `bit_balance_scale` 1 -> its floor
    (not 0: keep a weak restoring force) over
    `lfq_bit_balance_anneal_steps` from `lfq_bit_balance_anneal_start`.
    `make_train_step` evaluates each on the train state's step."""
    kwargs = {}
    start = getattr(mcfg, "lfq_entropy_anneal_start", None)
    if start is not None:
        ramp = max(int(getattr(mcfg, "lfq_entropy_anneal_steps", 1000)), 1)

        def entropy_scale(step, start=start, ramp=ramp):
            return min(max(1.0 - (step - float(start)) / float(ramp), 0.0), 1.0)

        kwargs["entropy_scale"] = entropy_scale

    b_start = getattr(mcfg, "lfq_bit_balance_anneal_start", None)
    if b_start is not None:
        b_ramp = max(int(getattr(mcfg, "lfq_bit_balance_anneal_steps", 1000)), 1)
        floor = float(getattr(mcfg, "lfq_bit_balance_anneal_floor", 0.05))

        def bit_balance_scale(step, start=b_start, ramp=b_ramp, floor=floor):
            return min(max(1.0 - (step - float(start)) / float(ramp), floor), 1.0)

        kwargs["bit_balance_scale"] = bit_balance_scale

    return kwargs


def build_tokenizer_module(mcfg: TokenizerModelConfig) -> TokenizerTrainModule:
    return TokenizerTrainModule(**mcfg.module_kwargs())


def genie_model_kwargs(mcfg: GenieModelConfig) -> dict:
    """The Genie constructor kwargs shared by training, tokenize-data and
    inference."""
    return dict(
        tokenizer=mcfg.tokenizer,
        latent_action=mcfg.latent_action,
        dynamics=mcfg.dynamics,
    )


def init_module(module: nn.Module, seed: int, device) -> nn.Module:
    """`module` with weights drawn from `seed` (on the CPU, so a seed gives
    the same weights on every device), moved to `device`."""
    return init_weights(module, torch.Generator().manual_seed(seed)).to(device)


def checkpoint_ema(ckpt: Dict[str, Any]) -> Optional[Dict[str, torch.Tensor]]:
    """The parameter EMA of a loaded checkpoint (`loop.load_checkpoint`),
    None when it has none or it does not mirror the parameters."""
    ema = ckpt["train_state"]["optimizer"]["ema"]
    if ema is None:
        return None
    want = {k: tuple(v.shape) for k, v in ckpt["params"].items()}
    if {k: tuple(v.shape) for k, v in ema.items()} != want:
        print("# WARNING: the checkpoint's EMA does not mirror its parameters -- "
              "ignoring it and loading raw params instead")
        return None
    return ema


def restore_ema_params(ckpt_dir: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """`(ema_params, step)` of the latest checkpoint, which must carry an
    EMA (trained with `optimizer.ema_decay`)."""
    ckpt, step = load_checkpoint(ckpt_dir)
    ema = checkpoint_ema(ckpt)
    if ema is None:
        raise ValueError(f"the checkpoint in {ckpt_dir} carries no parameter EMA "
                         "(train with model.optimizer.ema_decay set)")
    return ema, step


def load_genie_params(cfg: ExperimentConfig, ckpt: Optional[str] = None, device="cuda",
                      use_ema: bool = False) -> Tuple[dict, GenieTrainModule, int]:
    """A `GenieTrainModule` of the config with weights from `trainer.seed`,
    then the checkpoint's parameters (its EMA with `use_ema`), for
    inference: `(genie_kwargs, module, step)` (the Genie is `module.model`).
    `use_ema` without a checkpoint, or on one that carries no EMA, raises."""
    if use_ema and not ckpt:
        raise ValueError("--ema requires --ckpt (there is no EMA without a checkpoint)")
    genie_kwargs = genie_model_kwargs(cfg.model)
    module = init_module(GenieTrainModule(genie_kwargs), cfg.trainer.seed,
                         resolve_device(device, "load_genie_params"))
    step = 0
    if ckpt and use_ema:
        ema, step = restore_ema_params(ckpt)
        module.load_state_dict(ema)
    elif ckpt:
        module, step = restore_params(ckpt, module)
    return genie_kwargs, module, step


def _model_subtree(ckpt_dir: str, prefer_ema: bool = False) -> Tuple[dict, int, bool]:
    """The `model.` parameters of the latest checkpoint of a stage module
    (its EMA where `prefer_ema` and it has one), with the prefix taken off;
    `(params, step, from_ema)`."""
    ckpt, step = load_checkpoint(ckpt_dir, params_only=not prefer_ema)
    ema = checkpoint_ema(ckpt) if prefer_ema else None
    params = ema if ema is not None else ckpt["params"]
    sub = {k[len("model."):]: v for k, v in params.items() if k.startswith("model.")}
    return sub, step, ema is not None


def _load_into(target: nn.Module, params: dict, what: str, ckpt: str) -> None:
    """Load `params` into `target` with every name and shape matching."""
    want = {k: tuple(v.shape) for k, v in target.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if want.keys() != got.keys():
        raise ValueError(f"{what} checkpoint {ckpt} does not match the config's {what}: "
                         f"missing {sorted(want.keys() - got.keys())[:5]}, "
                         f"unexpected {sorted(got.keys() - want.keys())[:5]}")
    bad = [k for k in want if want[k] != got[k]]
    if bad:
        raise ValueError(f"{what} checkpoint {ckpt} parameter shapes do not match the "
                         f"config (check tok_vocab/act_vocab against the genie "
                         f"codebooks): {bad[:5]}")
    target.load_state_dict(params)


def _load_tokenizer_into_genie(module: GenieTrainModule, ckpt: str) -> None:
    """The tokenizer of a `train tokenizer` checkpoint into the Genie's
    frozen tokenizer, its EMA where it has one: the dynamics must learn the
    vocabulary of the weights the tokenizer is judged and served with."""
    params, step, from_ema = _model_subtree(ckpt, prefer_ema=True)
    print(f"# tokenizer_ckpt {ckpt} step {step}: loading "
          + ("EMA params" if from_ema else "raw params (no EMA in checkpoint)"))
    _load_into(module.model.tokenizer, params, "tokenizer", ckpt)


def _load_subtree_into_genie(module: GenieTrainModule, ckpt: str, subtree: str) -> None:
    """The model of a standalone-stage checkpoint (`train action` ->
    `latent_action`, `train dynamics` -> `dynamics`) into that subtree of
    the Genie (warm start; it keeps training)."""
    params, _, _ = _model_subtree(ckpt)
    _load_into(getattr(module.model, subtree), params, subtree, ckpt)


def _load_genie_into_genie(module: GenieTrainModule, ckpt: str) -> None:
    """Every `model.` parameter of a previous `train genie` checkpoint (a
    full warm start: the optimizer and step start fresh)."""
    params, _, _ = _model_subtree(ckpt)
    _load_into(module.model, params, "genie", ckpt)


def perc_weights_status(mcfg) -> str:
    """'disabled' | 'random' | '<npz path>' -- the provenance of the
    perceptual critic's features, recorded in the config snapshot."""
    if getattr(mcfg, "perc_loss_weight", 0) <= 0:
        return "disabled"
    return getattr(mcfg, "perc_weights_npz", None) or "random"


def warn_random_perceptual(mcfg) -> bool:
    """Loud stderr banner when perceptual training will run on a RANDOMLY
    initialized VGG16 (perc_loss_weight > 0 without `perc_weights_npz`).
    The reference trains against pretrained torchvision features; random
    deep features are a usable perceptual metric (LPIPS, Zhang et al.
    2018), but a silent divergence from the reference unless announced.
    Returns True if the warning fired."""
    if perc_weights_status(mcfg) != "random":
        return False
    print(
        "# " + "=" * 68 + "\n"
        "# WARNING: perc_loss_weight > 0 with no model.perc_weights_npz --\n"
        "# the perceptual loss will use a RANDOMLY INITIALIZED VGG16.\n"
        "# Random-feature perceptual distances are a usable metric (LPIPS,\n"
        "# Zhang et al. 2018, Table: untrained nets), but to match the\n"
        "# reference's pretrained-VGG quality, convert torchvision weights\n"
        "# with tools/convert_vgg_weights.py and set model.perc_weights_npz.\n"
        "# The config snapshot records `perc_weights: random`.\n"
        "# " + "=" * 68,
        file=sys.stderr,
    )
    return True


def save_config_snapshot(ckpt_dir: str, cfg: ExperimentConfig) -> None:
    """Write the resolved experiment config as `config.yaml` next to the
    checkpoints, so any checkpoint can be re-instantiated without the
    launch config (the JAX package writes the same file)."""
    import yaml

    def plain(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {f.name: plain(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, dict):
            return {str(k): plain(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [plain(v) for v in o]
        if isinstance(o, (str, int, float, bool)) or o is None:
            return o
        return repr(o)

    snap = plain(cfg)
    if hasattr(cfg, "model"):
        snap["perc_weights"] = perc_weights_status(cfg.model)
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump(snap, f, sort_keys=False)


def _make_val_fn(module: nn.Module, compute_dtype, seed: int, mesh: Mesh) -> Callable:
    """`val_fn(batch, step) -> metrics`: the loss in evaluation mode
    (`train=False` where the module takes it), no gradient and no update,
    in the compute dtype of the train step, drawing its noise from a
    generator of `seed + step` (one a rank, and the mask rate from one
    shared, on a `mesh` of several ranks, whose metrics are the global
    batch's)."""
    kwargs = {"train": False} if takes_kwarg(module, "train") else {}
    if mesh.data_group is not None and takes_kwarg(module, "group"):
        kwargs["group"] = mesh.data_group
    with_gen = takes_kwarg(module, "generator")
    with_rate = mesh.n_data > 1 and takes_kwarg(module, "rate_generator")

    @torch.no_grad()
    def val_fn(batch, step: int) -> Dict[str, torch.Tensor]:
        kw = dict(kwargs)
        device = next(module.parameters()).device
        if with_gen:
            kw["generator"] = torch.Generator(device).manual_seed(rank_seed(seed + step, mesh))
        if with_rate:
            kw["rate_generator"] = torch.Generator(device).manual_seed(seed + step)
        module.eval()
        try:
            if compute_dtype is None:
                _, metrics = module(batch, **kw)
            else:
                _, metrics = functional_call(module, compute_params(module, compute_dtype),
                                             (_cast_batch(batch, compute_dtype),), kw)
        finally:
            module.train()
        return metrics

    return val_fn


def make_eval_video_hook(module: GenieTrainModule, tcfg, size: int = 64,
                         num_frames: int = 8, mesh: Mesh = Mesh(1),
                         genie_kwargs: Optional[dict] = None) -> Callable:
    """Sample-video hook for Genie training: roll out a short
    action-conditioned video from a noise prompt and write it next to the
    logs as an mp4 (only with OpenCV). Every rank of `mesh` calls it; rank
    0 alone rolls out and writes. Under tensor parallelism the rollout
    runs on whole weights: every rank joins the gather of its slices
    (`parallel.tensor.gather_params`), and rank 0 loads them into a
    one-process model built from `genie_kwargs` (under a forked RNG, so
    that rank 0's dropout stream stays its model ranks'). A failure is
    printed, never raised: the hook must not kill training."""
    whole: Dict[str, nn.Module] = {}

    def rollout_module(state: TrainState) -> Optional[nn.Module]:
        """The module to roll out on rank 0 (None on the other ranks)."""
        if mesh.n_model == 1:
            return module if mesh.rank == 0 else None
        params = gather_params(state.module, mesh)
        if mesh.rank != 0:
            return None
        if "module" not in whole:
            with torch.random.fork_rng(devices=[]):
                whole["module"] = GenieTrainModule(genie_kwargs)
            whole["module"].to(next(module.parameters()).device)
        whole["module"].load_state_dict(params)
        return whole["module"]

    def hook(state: TrainState, step: int) -> None:
        from open_genie_tpu_torch.data.video import HAS_CV2, write_mp4

        if not HAS_CV2:
            return
        try:
            target = rollout_module(state)
            if target is None:
                return
            device = next(target.parameters()).device
            g = torch.Generator(device).manual_seed(step)
            prompt = torch.rand(1, 1, size, size, 3, generator=g, device=device)
            actions = torch.randint(0, 2, (1, num_frames + 1), generator=g, device=device)
            target.eval()
            try:
                with torch.no_grad():
                    video = target.generate(prompt, actions, num_frames=num_frames,
                                            steps_per_frame=8, generator=g)
            finally:
                target.train()
            os.makedirs(tcfg.log_dir, exist_ok=True)
            write_mp4(os.path.join(tcfg.log_dir, f"sample_step{step}.mp4"),
                      video[0].clamp(0, 1).float().cpu().numpy())
        except Exception:  # eval must never kill training
            print(f"[eval-hook] sample video failed:\n{traceback.format_exc()}")

    return hook


def _fit(cfg: ExperimentConfig, module: nn.Module, dataset, device, resume: bool,
         frozen: Tuple[str, ...] = (), loss_kwargs: Optional[dict] = None,
         val_dataset=None, eval_hook=None, mesh: Mesh = Mesh(1)) -> TrainState:
    """The part every stage shares: loaders, this rank's slices of the
    module (on a mesh with a model axis), optimizer (with the frozen
    prefixes), train state with its generators, resume, train step (over
    `mesh`'s ranks), validation, config snapshot, then the loop."""
    tcfg = cfg.trainer
    loader = build_loader(cfg, dataset, device, mesh=mesh)
    shard_module(module, mesh)
    mask = frozen_param_mask(module, frozen) if frozen else None
    optimizer = make_optimizer(module, **_opt_kwargs(cfg.model.optimizer), frozen_mask=mask)
    shared = torch.Generator(device).manual_seed(tcfg.seed) if mesh.n_data > 1 else None
    state = TrainState(module, optimizer,
                       torch.Generator(device).manual_seed(rank_seed(tcfg.seed, mesh)),
                       shared_generator=shared)
    start_step = 0
    if resume:
        state, start_step = restore_checkpoint(tcfg.ckpt_dir, state, mesh=mesh)
    compute_dtype = _compute_dtype(tcfg.precision)
    step_fn = make_train_step(state, compute_dtype=compute_dtype, loss_kwargs=loss_kwargs,
                              mesh=mesh)
    val_loader = val_fn = None
    if tcfg.val_check_interval and val_dataset is not None:
        val_loader = build_loader(cfg, val_dataset, device, split="val", mesh=mesh)
        val_fn = _make_val_fn(module, compute_dtype, tcfg.seed + 1, mesh)
    else:
        eval_hook = None
    if mesh.rank == 0:
        save_config_snapshot(tcfg.ckpt_dir, cfg)
    return _run_loop(state, step_fn, loader, tcfg, start_step, device, resume=resume,
                     val_fn=val_fn, val_loader=val_loader, eval_hook=eval_hook, mesh=mesh)


def _val_dataset(cfg, tcfg):
    if not tcfg.val_check_interval:
        return None
    try:
        return build_dataset(cfg.data, split="val")
    except FileNotFoundError:
        return None  # a flat shard dir without a val split


def train_tokenizer(cfg: ExperimentConfig, resume: bool = False, device="cuda") -> TrainState:
    """Stage 1: the tokenizer's full loss (reconstruction, GAN, perceptual,
    LFQ) with the VGG frozen; the LFQ anneals as step schedules;
    `trainer.gan_alternate` trains the generator branch on even steps and
    the discriminator's on odd ones, over one optimizer and step count."""
    mcfg: TokenizerModelConfig = cfg.model
    tcfg = cfg.trainer
    mesh, device = setup_mesh(tcfg, resolve_device(device, "train_tokenizer"))
    dataset = build_dataset(cfg.data)
    module = init_module(build_tokenizer_module(mcfg), tcfg.seed, device)
    warn_random_perceptual(mcfg)
    if mcfg.perc_loss_weight > 0 and mcfg.perc_weights_npz:
        # Pretrained perceptual features: converted torchvision VGG16 weights.
        from open_genie_tpu_torch.modules.vgg import load_torch_vgg16_npz

        load_torch_vgg16_npz(mcfg.perc_weights_npz, module.perc_crit.vgg)
    loss_kwargs = _entropy_anneal_kwargs(mcfg)
    if tcfg.gan_alternate and mcfg.gan_loss_weight > 0:
        loss_kwargs["gan_branch"] = lambda step: "gen" if step % 2 == 0 else "dis"
    frozen = ("perc_crit",) if mcfg.perc_loss_weight > 0 else ()
    return _fit(cfg, module, dataset, device, resume, frozen, loss_kwargs,
                val_dataset=_val_dataset(cfg, tcfg), mesh=mesh)


def train_genie(cfg: ExperimentConfig, resume: bool = False, device="cuda") -> TrainState:
    """Joint Genie training with the tokenizer frozen. Warm starts, in
    order: `genie_ckpt` (everything), `tokenizer_ckpt` (its EMA where it
    has one), `dynamics_ckpt`, `action_ckpt`."""
    mcfg: GenieModelConfig = cfg.model
    tcfg = cfg.trainer
    mesh, device = setup_mesh(tcfg, resolve_device(device, "train_genie"))
    dataset = build_dataset(cfg.data)
    _check_action_frames(mcfg.latent_action, dataset, cfg)
    module = init_module(GenieTrainModule(genie_model_kwargs(mcfg)), tcfg.seed, device)
    if mcfg.genie_ckpt:
        _load_genie_into_genie(module, mcfg.genie_ckpt)
    if mcfg.tokenizer_ckpt:
        _load_tokenizer_into_genie(module, mcfg.tokenizer_ckpt)
    if mcfg.dynamics_ckpt:
        _load_subtree_into_genie(module, mcfg.dynamics_ckpt, "dynamics")
    if mcfg.action_ckpt:
        _load_subtree_into_genie(module, mcfg.action_ckpt, "latent_action")
    hook = make_eval_video_hook(module, tcfg, size=cfg.data.height, num_frames=8, mesh=mesh,
                                genie_kwargs=genie_model_kwargs(mcfg))
    return _fit(cfg, module, dataset, device, resume, ("model/tokenizer",),
                val_dataset=_val_dataset(cfg, tcfg), eval_hook=hook, mesh=mesh)


def train_action(cfg: ExperimentConfig, resume: bool = False, device="cuda") -> TrainState:
    """Stage 2: the latent-action VQ-VAE alone on raw video (pixel
    reconstruction + LFQ); its checkpoint warm-starts `train genie`
    through `model.action_ckpt`."""
    mcfg = cfg.model
    tcfg = cfg.trainer
    mesh, device = setup_mesh(tcfg, resolve_device(device, "train_action"))
    dataset = build_dataset(cfg.data)
    _check_action_frames(mcfg.latent_action, dataset, cfg)
    module = init_module(ActionTrainModule(latent_action=mcfg.latent_action), tcfg.seed, device)
    return _fit(cfg, module, dataset, device, resume, val_dataset=_val_dataset(cfg, tcfg),
                mesh=mesh)


def train_dynamics(cfg: ExperimentConfig, resume: bool = False, device="cuda") -> TrainState:
    """Stage 3: the dynamics' masked-token loss over pre-tokenized clips
    (`data.source: tokens`, shards from `cli tokenize-data`)."""
    mcfg: DynamicsModelConfig = cfg.model
    tcfg = cfg.trainer
    mesh, device = setup_mesh(tcfg, resolve_device(device, "train_dynamics"))
    if cfg.data.source != "tokens":
        raise ValueError("train_dynamics consumes pre-tokenized shards; set data.source: "
                         "tokens and data.root to a tokenize-data output directory")
    dataset = build_dataset(cfg.data)
    module = init_module(DynamicsTrainModule(dynamics=mcfg.dynamics_kwargs()), tcfg.seed, device)
    return _fit(cfg, module, dataset, device, resume, val_dataset=_val_dataset(cfg, tcfg),
                mesh=mesh)


def _run_loop(
    state: TrainState,
    step_fn,
    loader: BatchLoader,
    tcfg,
    start_step: int,
    device,
    resume: bool = False,
    val_fn=None,
    val_loader=None,
    eval_hook=None,
    mesh: Mesh = Mesh(1),
) -> TrainState:
    """Training loop with periodic logging / validation / checkpointing.

    Every `log_every_n_steps` steps it logs the step's metrics, the rate
    of its last update (`lr`) and `steps_per_sec`; every
    `val_check_interval` steps `val_fn` runs over up to
    `limit_val_batches` batches, the best value of `monitor` so far is
    checkpointed under `best/` and `eval_hook(state, step)` runs; every
    `ckpt_every_n_steps` steps, and at the last with `save_last`, the
    state is checkpointed. A fresh run purges an earlier run's steps and
    `best/`; a resumed one keeps them and continues the data order where
    the checkpoint left it.

    On a `mesh` of several ranks every rank steps, validates and takes
    part in each save (the ranks' generator states are gathered into it,
    and a split state into the one-process layout) and calls `eval_hook`
    (which gathers a split model's weights), but only rank 0 logs, purges,
    writes the checkpoint (as orbax's primary host does) and writes the
    sample video; a barrier follows each save."""
    primary = mesh.rank == 0
    if len(loader) == 0:
        raise ValueError(
            "empty train loader: dataset smaller than batch_size "
            f"({len(loader.dataset)} < {loader.batch_size})"
        )
    logger = MetricLogger(tcfg.log_dir) if primary else None
    ckpt_writer = CheckpointWriter(tcfg.ckpt_dir, max_to_keep=tcfg.ckpt_max_keep)
    if not resume and primary:
        # Keyed on the resume FLAG, not `start_step == 0`: a legitimate
        # resume can sit at step 0 and must not be purged.
        n_stale = ckpt_writer.purge()
        best_dir = os.path.join(tcfg.ckpt_dir, "best")
        if os.path.isdir(best_dir):
            shutil.rmtree(best_dir)
            n_stale += 1
        if n_stale:
            print(
                f"# ckpt_dir {tcfg.ckpt_dir} held {n_stale} stale "
                "checkpoint(s) from a previous run -- purged (pass "
                "--resume to continue a previous run instead)"
            )
    best_writer = None
    max_steps = tcfg.max_steps or (tcfg.max_epochs * len(loader))
    # Monitor 'val_loss' means the 'loss' key of the validation metrics.
    monitor = tcfg.monitor or "val_loss"
    monitor_key = monitor[4:] if monitor.startswith("val_") else monitor
    best_val = float("inf")
    prof_n, prof_start = tcfg.profile_num_steps or 0, tcfg.profile_start_step or 0
    profiler = None
    step = start_step
    loader.seek(start_step)

    def save(writer, label):
        if mesh.world > 1:
            state.rank_generators = collectives.gather_objects(state.generator.get_state(),
                                                               mesh.group)
        # Every rank gathers a split state; rank 0 writes it whole.
        payload = gather_state(state, mesh) if mesh.n_model > 1 else None
        if primary:
            seconds = writer.save(state, step, payload=payload)
            print(f"# {label} checkpoint step {step}: {seconds:.3f} s to {writer.dir}/{step}",
                  flush=True)
        collectives.barrier(mesh.group)

    try:
        t0 = time.time()
        while step < max_steps:
            for batch in device_prefetch(loader, device, size=2):
                # >= not ==: a resume past profile_start_step still traces
                # the next prof_n steps.
                if prof_n and profiler is None and prof_start <= step < prof_start + prof_n:
                    profiler = contextlib.ExitStack()
                    profiler.enter_context(
                        debug.profile_trace(os.path.join(tcfg.log_dir, "profile")))
                metrics = step_fn(batch)
                step += 1
                if profiler is not None and step >= prof_start + prof_n:
                    profiler.close()
                    profiler, prof_n = None, 0
                if primary and step % tcfg.log_every_n_steps == 0:
                    values = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t0
                    lr = state.optimizer.last_lr  # None before the first update
                    logger.log(step, {**values, **({} if lr is None else {"lr": lr}),
                                      "steps_per_sec": tcfg.log_every_n_steps / dt})
                    t0 = time.time()
                if (
                    val_fn is not None
                    and val_loader is not None
                    and tcfg.val_check_interval
                    and step % tcfg.val_check_interval == 0
                ):
                    vm = _run_validation(val_fn, val_loader, tcfg.limit_val_batches, step,
                                         device)
                    if primary:
                        logger.log(step, {f"val_{k}": v for k, v in vm.items()})
                    if monitor_key in vm and vm[monitor_key] < best_val:
                        best_val = vm[monitor_key]
                        if best_writer is None:
                            # best-so-far is monotone: keep exactly one.
                            best_writer = CheckpointWriter(
                                os.path.join(tcfg.ckpt_dir, "best"), max_to_keep=1)
                        save(best_writer, "best")
                    if eval_hook is not None:  # every rank: a split model gathers
                        eval_hook(state, step)
                    t0 = time.time()
                if step % tcfg.ckpt_every_n_steps == 0 or (
                    step >= max_steps and tcfg.save_last
                ):
                    save(ckpt_writer, "periodic" if step % tcfg.ckpt_every_n_steps == 0
                         else "last")
                if step >= max_steps:
                    break
    finally:
        if profiler is not None:
            profiler.close()
        ckpt_writer.close()
        if best_writer is not None:
            best_writer.close()
        if logger is not None:
            logger.close()
    return state


def _run_validation(val_fn, val_loader, limit: Optional[int], step: int, device
                    ) -> Dict[str, float]:
    sums: Dict[str, float] = {}
    count = 0
    for i, batch in enumerate(device_prefetch(val_loader, device, size=2)):
        if limit is not None and i >= limit:
            break
        for k, v in val_fn(batch, step).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    return {k: v / max(count, 1) for k, v in sums.items()}
