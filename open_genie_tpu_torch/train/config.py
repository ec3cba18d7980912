"""Config system (copy of `open_genie_tpu.train.config`): dataclass tree +
YAML loader honoring the reference schema.

Loads the same YAML layout as the reference's LightningCLI configs
(the reference's `config/tokenize.yaml`): `model.*` (blueprints, LFQ, loss
weights, optimizer class-path + init_args), `data.*`, `trainer.*`. Blueprint
lists port verbatim. Lightning-specific trainer keys map onto the JAX loop
equivalents; unknown keys are preserved in `extra` rather than rejected.
`OptimizerConfig.schedule()` returns a plain `lr(step) -> float` with
optax's semantics (the JAX package returns the optax schedule itself).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
import math
from typing import Any, Callable, Dict, Optional, Tuple

import yaml

from open_genie_tpu_torch.utils import Blueprint


def _to_blueprint(raw) -> Blueprint:
    """YAML list-of-[name, kwargs] -> canonical blueprint tuple.

    A bare string resolves a stock blueprint by name ('magvit2',
    'repr_tok', 'latent_act_enc', ...), so configs can say
    `enc_desc: magvit2`.
    """
    if raw is None:
        return ()
    if isinstance(raw, str):
        from open_genie_tpu_torch.models import blueprints as bp

        named = {
            "magvit2_enc": bp.MAGVIT2_ENC_DESC,
            "magvit2_dec": bp.MAGVIT2_DEC_DESC,
            "magvit2_stream_dec": bp.MAGVIT2_STREAM_DEC_DESC,
            "repr_tok_enc": bp.REPR_TOK_ENC,
            "repr_tok_dec": bp.REPR_TOK_DEC,
            "latent_act_enc": bp.LATENT_ACT_ENC,
            "latent_act_dec": bp.LATENT_ACT_DEC,
            "dynamics": bp.DYNAMICS_DESC,
        }
        key = raw.lower()
        if key in named:
            return named[key]
        raise ValueError(f"Unknown named blueprint: {raw}")
    out = []
    for entry in raw:
        if isinstance(entry, str):
            out.append((entry, {}))
        elif isinstance(entry, (list, tuple)):
            name = entry[0]
            kwargs = entry[1] if len(entry) > 1 else {}
            out.append((name, dict(kwargs or {})))
        elif isinstance(entry, dict):
            # {name: {kwargs}} form
            (name, kwargs), = entry.items()
            out.append((name, dict(kwargs or {})))
        else:
            raise ValueError(f"Bad blueprint entry: {entry!r}")
    return tuple(out)


@dataclass
class OptimizerConfig:
    lr: float = 1e-3
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: Optional[float] = 1.0
    # LR schedule (the reference trains at constant LR,
    # `config/tokenize.yaml:49-53`; these are production additions):
    # 'constant' | 'cosine' | 'linear', with linear warmup from 0.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: Optional[int] = None  # required for cosine/linear
    end_lr_scale: float = 0.0          # final LR = lr * end_lr_scale
    # Exponential moving average of params (None = off); the EMA tree
    # rides inside the optimizer state (checkpointed automatically).
    ema_decay: Optional[float] = None
    # Gradient accumulation: average grads over N step calls before one
    # optimizer update (effective batch = N * batch_size).
    accum_steps: int = 1

    @classmethod
    def from_raw(cls, raw) -> "OptimizerConfig":
        """Accept the LightningCLI `class_path`/`init_args` form."""
        if raw is None:
            return cls()
        if "init_args" in raw:
            args = raw.get("init_args") or {}
            return cls(
                lr=float(args.get("lr", 1e-3)),
                weight_decay=float(args.get("weight_decay", 0.01)),
            )
        known = {k: v for k, v in raw.items() if k in cls.__dataclass_fields__}
        # YAML parses '3e-4' (no dot) as a STRING; coerce numeric fields so
        # exponent-form literals in configs don't crash the optimizer.
        for k in ("lr", "weight_decay", "b1", "b2", "end_lr_scale"):
            if k in known:
                known[k] = float(known[k])
        for k in ("grad_clip", "ema_decay"):
            if known.get(k) is not None:
                known[k] = float(known[k])
        for k in ("warmup_steps", "accum_steps"):
            if k in known:
                known[k] = int(known[k])
        if known.get("decay_steps") is not None:
            known["decay_steps"] = int(known["decay_steps"])
        return cls(**known)

    def schedule(self) -> Callable[[int], float]:
        """`lr(step) -> float`, the count of applied updates to the rate,
        as optax's `warmup_constant_schedule`, `warmup_cosine_decay_schedule`
        and linear warm-up joined to a linear decay compute it."""
        if self.lr_schedule == "constant" and not self.warmup_steps:
            return lambda step: self.lr
        if self.lr_schedule == "constant":
            return _linear(0.0, self.lr, self.warmup_steps)
        if self.decay_steps is None:
            raise ValueError(
                f"lr_schedule={self.lr_schedule!r} requires decay_steps"
            )
        if self.decay_steps <= self.warmup_steps:
            # decay_steps counts TOTAL schedule length incl. warmup (both
            # forms below); <= warmup silently builds a zero/negative
            # decay segment instead of a schedule.
            raise ValueError(
                f"decay_steps ({self.decay_steps}) must exceed "
                f"warmup_steps ({self.warmup_steps}) for "
                f"lr_schedule={self.lr_schedule!r}"
            )
        end = self.lr * self.end_lr_scale
        warm = _linear(0.0, self.lr, self.warmup_steps)
        span = self.decay_steps - self.warmup_steps
        if self.lr_schedule == "cosine":
            alpha = 0.0 if self.lr == 0.0 else end / self.lr

            def decay(step):
                frac = min(step, span) / span
                return self.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)
        elif self.lr_schedule == "linear":
            decay = _linear(self.lr, end, span)
        else:
            raise ValueError(f"Unknown lr_schedule: {self.lr_schedule!r}")
        return lambda step: warm(step) if step < self.warmup_steps else decay(
            step - self.warmup_steps)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax's `linear_schedule`: `init` to `end` over `steps`, then `end`
    (`init` throughout when `steps` is 0)."""
    if steps <= 0:
        return lambda step: init
    return lambda step: (init - end) * (1 - min(max(step, 0), steps) / steps) + end


@dataclass
class TokenizerModelConfig:
    enc_desc: Blueprint = ()
    dec_desc: Blueprint = ()
    disc_kwargs: Dict[str, Any] = field(default_factory=dict)
    d_codebook: int = 18
    n_codebook: int = 1
    lfq_bias: bool = True
    lfq_frac_sample: float = 1.0
    lfq_commit_weight: float = 0.25
    lfq_entropy_weight: float = 0.1
    lfq_diversity_weight: float = 1.0
    # Saturation-proof anti-collapse regularizer (per-bit balance +
    # decorrelation, `ops/lfq.py::lfq_bit_balance_loss`). The flagship
    # recipe sets this >0 with `lfq_entropy_weight: 0`: the reference's
    # entropy objective has a numerically dead gradient at beta=100, which
    # let the codebook collapse mid-run three times on-chip (PARITY.md).
    lfq_bit_balance_weight: float = 0.0
    # Anneal the LFQ entropy objective to zero once the codebook is
    # established: scale ramps 1 -> 0 linearly over `anneal_steps`
    # starting at `anneal_start` (None = never anneal). The entropy terms
    # exist to establish diversity; kept on indefinitely, the diversity
    # reward pushes the encoder toward logit saturation where the
    # codebook collapses to one code (observed twice on-chip, round 4).
    lfq_entropy_anneal_start: Optional[int] = None
    lfq_entropy_anneal_steps: int = 1000
    # Anneal the bit-balance objective to a FLOOR (not zero: keep a weak
    # restoring force against collapse) once the codebook is established.
    # At convergence the balance term sits 2-3x above the rec loss and its
    # gradient competes with reconstruction (measured r05 flagship:
    # bal~0.02-0.03 vs rec~0.011 at 20k steps, rec flat from 4k on).
    lfq_bit_balance_anneal_start: Optional[int] = None
    lfq_bit_balance_anneal_steps: int = 1000
    lfq_bit_balance_anneal_floor: float = 0.05
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    perceptual_model: str = "vgg16"
    perc_feat_layers: Tuple[str, ...] = (
        "features.6", "features.13", "features.18", "features.25",
    )
    # Converted torchvision weights (tools/convert_vgg_weights.py output);
    # None = random-feature perceptual metric (no egress for downloads).
    perc_weights_npz: Optional[str] = None
    gan_discriminate: str = "frames"
    gan_frames_per_batch: int = 4
    gan_loss_weight: float = 1.0
    perc_loss_weight: float = 1.0
    quant_loss_weight: float = 1.0
    # Activation-checkpointing mode for the enc/dec stacks: True/'full'
    # recomputes everything in backward, 'dots' keeps dot_general
    # (attention/dense) outputs resident (convs still recomputed -- the
    # XLA policy matches only dot_general), False disables.
    remat: Any = True

    def tokenizer_kwargs(self) -> Dict[str, Any]:
        return dict(
            enc_desc=self.enc_desc,
            dec_desc=self.dec_desc,
            d_codebook=self.d_codebook,
            n_codebook=self.n_codebook,
            lfq_bias=self.lfq_bias,
            lfq_frac_sample=self.lfq_frac_sample,
            lfq_commit_weight=self.lfq_commit_weight,
            lfq_entropy_weight=self.lfq_entropy_weight,
            lfq_diversity_weight=self.lfq_diversity_weight,
            lfq_bit_balance_weight=self.lfq_bit_balance_weight,
            remat=self.remat,
        )

    def module_kwargs(self) -> Dict[str, Any]:
        """The `TokenizerTrainModule` kwargs of this config: training,
        evaluation and checkpoint templates must build identical modules."""
        return dict(
            tokenizer=self.tokenizer_kwargs(),
            disc_kwargs=self.disc_kwargs,
            perceptual_model=self.perceptual_model,
            perc_feat_layers=tuple(self.perc_feat_layers),
            gan_discriminate=self.gan_discriminate,
            gan_frames_per_batch=self.gan_frames_per_batch,
            gan_loss_weight=self.gan_loss_weight,
            perc_loss_weight=self.perc_loss_weight,
            quant_loss_weight=self.quant_loss_weight,
        )

    @classmethod
    def from_raw(cls, raw: dict) -> "TokenizerModelConfig":
        raw = dict(raw or {})
        known = {}
        for f in dataclasses.fields(cls):
            if f.name not in raw:
                continue
            v = raw.pop(f.name)
            if f.name in ("enc_desc", "dec_desc"):
                v = _to_blueprint(v)
            elif f.name == "optimizer":
                v = OptimizerConfig.from_raw(v)
            elif f.name == "perc_feat_layers":
                v = tuple(v)
            known[f.name] = v
        return cls(**known)


@dataclass
class GenieModelConfig:
    # Tokenizer (pretrained; checkpoint path to restore from)
    tokenizer: Dict[str, Any] = field(default_factory=dict)
    tokenizer_ckpt: Optional[str] = None
    # Latent action model (optionally pre-trained via `train action`)
    latent_action: Dict[str, Any] = field(default_factory=dict)
    action_ckpt: Optional[str] = None
    # Dynamics model (optionally staged-pretrained via `train dynamics`)
    dynamics: Dict[str, Any] = field(default_factory=dict)
    dynamics_ckpt: Optional[str] = None
    # Full-genie warm start: restore ALL model params (tokenizer, latent
    # action, dynamics) from a previous `train genie` checkpoint before the
    # subtree warm starts above overwrite their pieces. The staged pipeline
    # needs this so the final joint phase keeps the action codebook the
    # staged dynamics was trained against, instead of re-learning actions
    # from scratch against a mismatched conditioning.
    genie_ckpt: Optional[str] = None
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    @classmethod
    def from_raw(cls, raw: dict) -> "GenieModelConfig":
        raw = dict(raw or {})
        tok = dict(raw.get("tokenizer") or {})
        for k in ("enc_desc", "dec_desc"):
            if k in tok:
                tok[k] = _to_blueprint(tok[k])
        act = dict(raw.get("latent_action") or {})
        for k in ("enc_desc", "dec_desc"):
            if k in act:
                act[k] = _to_blueprint(act[k])
        if "inp_shape" in act:
            act["inp_shape"] = tuple(act["inp_shape"])
        dyn = dict(raw.get("dynamics") or {})
        if "desc" in dyn:
            dyn["desc"] = _to_blueprint(dyn["desc"])
        return cls(
            tokenizer=tok,
            tokenizer_ckpt=raw.get("tokenizer_ckpt"),
            latent_action=act,
            action_ckpt=raw.get("action_ckpt"),
            dynamics=dyn,
            dynamics_ckpt=raw.get("dynamics_ckpt"),
            genie_ckpt=raw.get("genie_ckpt"),
            optimizer=OptimizerConfig.from_raw(raw.get("optimizer")),
        )


@dataclass
class DynamicsModelConfig:
    """Dynamics-only training (pre-tokenized clips, `data/tokens.py`)."""

    dynamics: Dict[str, Any] = field(default_factory=dict)
    tok_vocab: int = 1024
    act_vocab: int = 256
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    @classmethod
    def from_raw(cls, raw: dict) -> "DynamicsModelConfig":
        raw = dict(raw or {})
        dyn = dict(raw.get("dynamics") or {})
        if "desc" in dyn:
            dyn["desc"] = _to_blueprint(dyn["desc"])
        return cls(
            dynamics=dyn,
            tok_vocab=int(raw.get("tok_vocab", 1024)),
            act_vocab=int(raw.get("act_vocab", 256)),
            optimizer=OptimizerConfig.from_raw(raw.get("optimizer")),
        )

    def dynamics_kwargs(self) -> Dict[str, Any]:
        dyn = dict(self.dynamics)
        dyn.setdefault("tok_vocab", self.tok_vocab)
        dyn.setdefault("act_vocab", self.act_vocab)
        return dyn


@dataclass
class DataConfig:
    root: str = ""
    env_name: str = "Coinrun"
    padding: str = "none"
    randomize: bool = False
    transform: Any = None
    num_frames: int = 16
    batch_size: int = 8
    output_format: str = "t h w c"  # accepted; pipeline is channels-last
    num_workers: int = 2
    source: str = "platformer"  # 'platformer' | 'synthetic' | 'gvid'
    # kinetics source knobs (official torchvision semantics,
    # `data/kinetics.py`; reference `genie/dataset.py:14-40`)
    step_between_clips: int = 1
    frame_rate: Optional[int] = None
    num_classes: str = "400"
    # synthetic source knobs
    num_videos: int = 256
    height: int = 64
    width: int = 64

    @classmethod
    def from_raw(cls, raw: dict) -> "DataConfig":
        raw = dict(raw or {})
        # `size: N` is accepted as shorthand for square height/width
        # (mirrors `cli make-data --size`).
        if "size" in raw:
            size = int(raw.pop("size"))
            raw.setdefault("height", size)
            raw.setdefault("width", size)
        field_names = {f.name for f in dataclasses.fields(cls)}
        known = {k: raw[k] for k in field_names if k in raw}
        # Reference Lightning YAMLs carry loader knobs this pipeline does
        # not need (pin_memory, sampler, ...); tolerate those but warn so a
        # misspelled key is not silently ignored (a wrong `height` would
        # otherwise surface as an opaque init-vs-batch shape error).
        unknown = sorted(set(raw) - field_names)
        if unknown:
            print(f"[config] ignoring unknown data keys: {unknown}")
        return cls(**known)


@dataclass
class TrainerConfig:
    max_epochs: int = 1
    max_steps: Optional[int] = None
    precision: str = "16-mixed"  # '16-mixed' -> bf16 compute; '32' -> f32
    log_every_n_steps: int = 16
    val_check_interval: Optional[int] = None
    limit_val_batches: Optional[int] = None
    ckpt_dir: str = "checkpoints"
    ckpt_every_n_steps: int = 500
    # Periodic step dirs kept on disk (oldest GC'd at save time; the best
    # checkpoint is separate and always kept). None = keep everything.
    ckpt_max_keep: Optional[int] = 2
    seed: int = 31415
    # Mesh axes (`parallel.mesh.make_mesh`): `n_data` data-parallel shards
    # of `n_model` tensor-parallel ranks, one process and device a rank
    # (n_data None = every rank of the run over n_model; a mesh other than
    # the run's ranks raises).
    n_data: Optional[int] = None
    n_model: int = 1
    gan_alternate: bool = False    # alternating G/D steps vs reference's sum
    log_dir: str = "logs"
    monitor: str = "val_loss"      # best-checkpoint metric (ModelCheckpoint)
    save_last: bool = True         # always checkpoint the final step
    # torch.profiler trace of steps [profile_start_step, +profile_num_steps)
    # written to <log_dir>/profile (TensorBoard viewable); 0 = off.
    profile_start_step: int = 0
    profile_num_steps: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_raw(cls, raw: dict, seed: Optional[int] = None) -> "TrainerConfig":
        raw = dict(raw or {})
        known = {}
        for f in dataclasses.fields(cls):
            if f.name in raw:
                known[f.name] = raw.pop(f.name)
        # Lightning compat mappings
        if "devices" in raw:
            raw.pop("devices")
        # ModelCheckpoint callback (reference config/tokenize.yaml:82-86):
        # monitor/save_last map onto the loop's best-val + final-save knobs.
        for cb in raw.get("callbacks") or []:
            # entries may be bare class-path strings (jsonargparse shorthand)
            if isinstance(cb, dict) and "ModelCheckpoint" in str(cb.get("class_path", "")):
                args = cb.get("init_args") or {}
                known.setdefault("monitor", args.get("monitor", "val_loss"))
                known.setdefault("save_last", bool(args.get("save_last", True)))
        known.setdefault("extra", raw)
        if seed is not None:
            known["seed"] = seed
        return cls(**known)


@dataclass
class ExperimentConfig:
    model: Any  # TokenizerModelConfig | GenieModelConfig
    data: DataConfig
    trainer: TrainerConfig


@dataclass
class ActionModelConfig:
    """Standalone LatentAction VQ-VAE pre-training.

    The reference exposes `LatentAction.forward` as its own pre-training
    objective (SURVEY 3.4, the reference's `genie/action.py:151-176`) but
    ships no entry point for it; `cli train action` is that entry."""

    latent_action: Dict[str, Any] = field(default_factory=dict)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)

    @classmethod
    def from_raw(cls, raw: dict) -> "ActionModelConfig":
        raw = dict(raw or {})
        act = dict(raw.get("latent_action") or {})
        for k in ("enc_desc", "dec_desc"):
            if k in act:
                act[k] = _to_blueprint(act[k])
        if "inp_shape" in act:
            act["inp_shape"] = tuple(act["inp_shape"])
        return cls(
            latent_action=act,
            optimizer=OptimizerConfig.from_raw(raw.get("optimizer")),
        )


def load_config(path: str, kind: str = "tokenizer") -> ExperimentConfig:
    with open(path) as f:
        raw = yaml.safe_load(f)

    seed = raw.get("seed_everything")
    model_cls = {
        "tokenizer": TokenizerModelConfig,
        "genie": GenieModelConfig,
        "dynamics": DynamicsModelConfig,
        "action": ActionModelConfig,
    }[kind]
    return ExperimentConfig(
        model=model_cls.from_raw(raw.get("model")),
        data=DataConfig.from_raw(raw.get("data")),
        trainer=TrainerConfig.from_raw(raw.get("trainer"), seed=seed),
    )
