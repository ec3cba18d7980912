"""One training step of each repo YAML that no other test steps:
`configs/r0{3,4,5,5b}_dynamics.yaml`, `r03_genie.yaml`, `r03_genie_final.yaml`
and `r05_genie_final.yaml`.

Each YAML goes through the port's `load_config` and the trainer's functions
(`DynamicsModelConfig.dynamics_kwargs`, `genie_model_kwargs`, `init_module`
at the YAML's seed, `_opt_kwargs` with its schedule, the Genie's frozen
tokenizer and its warm starts from `tokenizer_ckpt` / `dynamics_ckpt`,
which the test writes). Widths are divided by `NARROW` and every repeat cut
to one layer (`narrow`); every other key is the YAML's, its batch and clip
length and 64x64 frames too, except the precision: the step runs in f32
(bf16 convs take minutes on a CPU). The dynamics YAMLs read token shards
of `cli tokenize-data`; here a batch of the YAML's size is drawn on a
2 x 4 x 4 token grid. Each step's loss and every metric must be finite and
every trainable parameter must get a gradient, finite, as AdamW takes it.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from open_genie_tpu_torch.train import trainer  # noqa: E402
from open_genie_tpu_torch.train.config import load_config  # noqa: E402
from open_genie_tpu_torch.train.loop import (  # noqa: E402
    TrainState,
    make_optimizer,
    make_train_step,
    save_checkpoint,
)
from open_genie_tpu_torch.train.losses import (  # noqa: E402
    DynamicsTrainModule,
    GenieTrainModule,
    frozen_param_mask,
)
from torch import nn  # noqa: E402

torch.set_num_threads(2)
NARROW = 8
KEEP = 32  # widths at or below it are codebook widths, RGB or a key dim: kept
WIDTHS = ("in_channels", "out_channels", "n_embd", "d_inp", "d_out", "num_channels",
          "dim_cond", "embed_dim")
DYNAMICS = ("r03_dynamics", "r04_dynamics", "r05_dynamics", "r05b_dynamics")
GENIES = ("r03_genie", "r03_genie_final", "r05_genie_final")


def _narrow_layer(kw: dict) -> dict:
    out = dict(kw)
    for key in WIDTHS:
        if isinstance(out.get(key), int) and out[key] > KEEP:
            out[key] //= NARROW
    if "n_rep" in out:
        out["n_rep"] = 1
    if "n_head" in out:
        out["n_head"] = max(1, out["n_head"] // NARROW)
        out["d_head"] = max(8, out["d_head"] // NARROW)
    if "num_groups" in out:
        width = out.get("num_channels") or out.get("out_channels") or out.get("in_channels")
        out["num_groups"] = math.gcd(out["num_groups"], width)
    return out


def narrow(model: dict) -> dict:
    """A model's kwargs with its widths divided by `NARROW` and one layer
    a repeat: every blueprint entry and the top-level widths."""
    out = _narrow_layer(model)
    for key in ("enc_desc", "dec_desc", "desc"):
        if key in out:
            out[key] = tuple((name, _narrow_layer(kw)) for name, kw in out[key])
    return out


class _Holder(nn.Module):
    """A module whose `model` is a stage's model: a checkpoint in a stage's
    layout (`model.` parameters) for a warm start."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


def _write_stage_ckpt(path, model: nn.Module, seed: int) -> str:
    module = trainer.init_module(_Holder(model), seed, "cpu")
    save_checkpoint(str(path), TrainState(module, make_optimizer(module)), step=0)
    return str(path)


def _step(module, cfg, frozen, batch):
    """One `make_train_step` step; `(metrics, {trainable name: grad})`."""
    trainable = frozen_param_mask(module, frozen) if frozen else None
    opt = make_optimizer(module, **trainer._opt_kwargs(cfg.model.optimizer),
                         frozen_mask=trainable)
    grads, adamw_step = {}, opt.adamw.step

    def spy(*args, **kwargs):
        grads.update({n: None if p.grad is None else p.grad.clone()
                      for n, p in module.named_parameters() if p.requires_grad
                      and (trainable is None or trainable[n])})
        return adamw_step(*args, **kwargs)

    opt.adamw.step = spy
    state = TrainState(module, opt, torch.Generator().manual_seed(cfg.trainer.seed))
    return make_train_step(state)(batch), grads


def _check(metrics, grads):
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    for k, v in metrics.items():
        assert torch.isfinite(torch.as_tensor(v)).all(), k
    assert grads
    missing = sorted(n for n, g in grads.items() if g is None)
    assert not missing, f"no gradient: {missing[:5]}"
    bad = sorted(n for n, g in grads.items() if not torch.isfinite(g).all())
    assert not bad, f"non-finite gradient: {bad[:5]}"


@pytest.mark.parametrize("name", DYNAMICS)
def test_dynamics_yaml_takes_one_step(name):
    cfg = load_config(f"configs/{name}.yaml", "dynamics")
    dyn = narrow(cfg.model.dynamics_kwargs())
    assert dyn["tok_vocab"] == cfg.model.tok_vocab and dyn["act_vocab"] == cfg.model.act_vocab
    module = trainer.init_module(DynamicsTrainModule(dynamics=dyn), cfg.trainer.seed, "cpu")
    rng = np.random.default_rng(0)
    b = cfg.data.batch_size
    batch = {"tokens": torch.from_numpy(rng.integers(0, dyn["tok_vocab"], (b, 2, 4, 4))),
             "actions": torch.from_numpy(rng.integers(0, dyn["act_vocab"], (b, 2)))}
    _check(*_step(module, cfg, (), batch))


@pytest.mark.parametrize("name", GENIES)
def test_genie_yaml_takes_one_step(name, tmp_path):
    from open_genie_tpu_torch.models.dynamics import DynamicsModel
    from open_genie_tpu_torch.models.tokenizer import VideoTokenizer

    cfg = load_config(f"configs/{name}.yaml", "genie")
    kwargs = {k: narrow(v) for k, v in trainer.genie_model_kwargs(cfg.model).items()}
    module = trainer.init_module(GenieTrainModule(kwargs), cfg.trainer.seed, "cpu")
    assert cfg.model.tokenizer_ckpt, name  # every one warm-starts its frozen tokenizer
    trainer._load_tokenizer_into_genie(module, _write_stage_ckpt(
        tmp_path / "tok", VideoTokenizer(**kwargs["tokenizer"]), cfg.trainer.seed + 1))
    if cfg.model.dynamics_ckpt:
        emb = module.model.dynamics
        dyn = dict(kwargs["dynamics"], tok_vocab=emb.tok_emb.num_embeddings,
                   act_vocab=emb.act_emb.num_embeddings)
        trainer._load_subtree_into_genie(module, _write_stage_ckpt(
            tmp_path / "dyn", DynamicsModel(**dyn), cfg.trainer.seed + 2), "dynamics")
    d = cfg.data
    video = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(d.batch_size, d.num_frames, d.height, d.width, 3)).astype(np.float32))
    _check(*_step(module, cfg, ("model/tokenizer",), video))
