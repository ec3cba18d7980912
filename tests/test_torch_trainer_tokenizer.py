"""`cli train tokenizer` of the port against the JAX package's on the CPU,
then the Genie warm starts from the port's own checkpoints.

The same tiny YAML (written here) runs through both CLIs: 3 steps, then
`--resume` to 5, with validation, periodic and best checkpoints. The runs
must log the same steps with the same metric names (the port adds `lr`),
validate at the same steps, leave the same step directories and `best/`,
and write the same config snapshot. Weights differ (each package draws its
own from the seed), so values are not compared here: the train step is
held to JAX's in `test_torch_trainer.py`.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from open_genie_tpu import cli as jcli  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import loop as tloop  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402

torch.set_num_threads(1)

TOKENIZER = """\
  enc_desc:
    - [spacetime_downsample, {in_channels: 3, kernel_size: 3, out_channels: 8, time_factor: 1, space_factor: 4}]
    - [space-time_attn, {n_rep: 1, n_head: 1, d_head: 16, d_inp: 8, d_out: 8}]
    - [causal-conv3d, {in_channels: 8, out_channels: 4, kernel_size: 1}]
  dec_desc:
    - [causal-conv3d, {in_channels: 4, out_channels: 8, kernel_size: 3}]
    - [depth2spacetime_upsample, {in_channels: 8, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}]
  d_codebook: 4
"""
DATA = """\
data: {source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, num_videos: 24, num_workers: 2}
"""


def _trainer(root, name, **extra):
    lines = dict(max_steps=5, precision='"32"', log_every_n_steps=1, val_check_interval=2,
                 limit_val_batches=2, ckpt_every_n_steps=2, ckpt_max_keep=2, n_data=1,
                 ckpt_dir=os.path.join(root, f"{name}_ckpt"),
                 log_dir=os.path.join(root, f"{name}_logs"))
    lines.update(extra)
    return "trainer:\n" + "".join(f"  {k}: {v}\n" for k, v in lines.items())


def _tokenizer_yaml(root, name):
    return ("seed_everything: 5\nmodel:\n" + TOKENIZER + """\
  disc_kwargs: {inp_size: [16, 16], model_dim: 8, dim_mults: [1, 2], down_step: [null, 2], num_groups: 4, use_attn: false}
  gan_frames_per_batch: 2
  perc_loss_weight: 0.0
  lfq_bit_balance_weight: 1.0
  lfq_bit_balance_anneal_start: 1
  lfq_bit_balance_anneal_steps: 2
  optimizer: {lr: 1e-3, lr_schedule: cosine, warmup_steps: 1, decay_steps: 6, end_lr_scale: 0.1, ema_decay: 0.8}
""" + DATA + _trainer(root, name))


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _records(log_dir):
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], sorted(set(r) - {"step", "time", "lr"})) for r in recs]


def _dirs(ckpt_dir):
    return (sorted(d for d in os.listdir(ckpt_dir) if d.isdigit()),
            sorted(os.listdir(os.path.join(ckpt_dir, "best"))))


def _snapshot(ckpt_dir, name):
    with open(os.path.join(ckpt_dir, "config.yaml")) as f:
        return f.read().replace(f"{name}_ckpt", "CKPT").replace(f"{name}_logs", "LOGS")


@pytest.fixture(scope="module")
def tokenizer_runs(tmp_path_factory):
    """Both CLIs, 3 steps then `--resume` to 5; the cadence after each."""
    root = tmp_path_factory.mktemp("tok")
    out = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        cfg = _write(root / f"{name}.yaml", _tokenizer_yaml(str(root), name))
        main(["train", "tokenizer", "--config", cfg, "--max-steps", "3"] + extra)
        first = (_records(root / f"{name}_logs"), _dirs(root / f"{name}_ckpt"))
        main(["train", "tokenizer", "--config", cfg, "--resume"] + extra)
        out[name] = dict(first=first, second=(_records(root / f"{name}_logs"),
                                              _dirs(root / f"{name}_ckpt")),
                         snapshot=_snapshot(root / f"{name}_ckpt", name),
                         ckpt=str(root / f"{name}_ckpt"), log=str(root / f"{name}_logs"))
    return root, out


def test_tokenizer_cadence_matches_jax(tokenizer_runs):
    _, runs = tokenizer_runs
    jax_run, port = runs["jax"], runs["port"]
    assert port["first"] == jax_run["first"]
    assert port["second"] == jax_run["second"]
    records, (steps, best) = port["second"]
    assert [s for s, keys in records if "val_loss" in keys] == [2, 4]
    assert [s for s, keys in records if "loss" in keys] == [1, 2, 3, 4, 5]
    assert steps == ["4", "5"] and len(best) == 1
    assert port["snapshot"] == jax_run["snapshot"]


def test_tokenizer_run_logs_lr_and_finite_terms(tokenizer_runs):
    """Every logged term is finite, and the logged `lr` of step s is the
    schedule at s - 1 updates, across the resume."""
    _, runs = tokenizer_runs
    with open(os.path.join(runs["port"]["log"], "train_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    sched = tconfig.OptimizerConfig(lr=1e-3, lr_schedule="cosine", warmup_steps=1,
                                    decay_steps=6, end_lr_scale=0.1).schedule()
    train = [r for r in recs if "loss" in r]
    assert [r["lr"] for r in train] == [sched(s - 1) for s in range(1, 6)]
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k != "time")


def test_checkpoint_holds_the_ema(tokenizer_runs):
    """The last checkpoint carries the EMA at decay 0.8, distinct from the
    parameters; `restore_ema_params` reads it."""
    _, runs = tokenizer_runs
    ema, step = ttrainer.restore_ema_params(runs["port"]["ckpt"])
    ckpt, at = tloop.load_checkpoint(runs["port"]["ckpt"])
    assert step == at == 5 and ckpt["train_state"]["step"] == 5
    assert ema.keys() == ckpt["params"].keys()
    assert any(not torch.equal(ema[k], ckpt["params"][k]) for k in ema)


GENIE = """\
  latent_action:
    enc_desc: [[space-time_attn, {n_rep: 1, n_embd: 8, n_head: 1, d_head: 8}]]
    dec_desc: [[space-time_attn, {n_rep: 1, n_embd: 8, n_head: 1, d_head: 8, has_ext: true, time_attn_kw: {key_dim: 2}}]]
    d_codebook: 2
    n_embd: 8
    inp_shape: [16, 16]
  dynamics:
    desc: [[space-time_attn, {n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}]]
    embed_dim: 16
"""


def test_warm_starts_into_genie(tokenizer_runs, monkeypatch):
    """`train action`, then `train genie` with `tokenizer_ckpt` (the port's
    tokenizer run) and `action_ckpt`: after two steps the Genie's frozen
    tokenizer is the tokenizer checkpoint's EMA, bit for bit, and its
    latent action started from the action checkpoint."""
    root, runs = tokenizer_runs
    action = _write(root / "action.yaml", "seed_everything: 6\nmodel:\n" + GENIE.split(
        "  dynamics:")[0] + DATA + _trainer(str(root), "act", max_steps=1))
    act_state = ttrainer.train_action(tconfig.load_config(action, "action"), device="cpu")
    act_ckpt = tloop.load_checkpoint(str(root / "act_ckpt"))[0]["params"]
    genie = _write(root / "genie.yaml", "seed_everything: 7\nmodel:\n  tokenizer:\n" + "".join(
        "  " + line + "\n" for line in TOKENIZER.splitlines())
        + f"  tokenizer_ckpt: {runs['port']['ckpt']}\n  action_ckpt: {root / 'act_ckpt'}\n"
        + GENIE + DATA + _trainer(str(root), "genie", max_steps=2))
    loaded = {}
    real_load = ttrainer._load_subtree_into_genie

    def spy(module, ckpt, subtree):
        real_load(module, ckpt, subtree)
        loaded[subtree] = {k: v.detach().clone()
                           for k, v in getattr(module.model, subtree).state_dict().items()}

    monkeypatch.setattr(ttrainer, "_load_subtree_into_genie", spy)
    state = tcli.main(["train", "genie", "--config", genie, "--device", "cpu"])
    ema, _ = ttrainer.restore_ema_params(runs["port"]["ckpt"])
    tok = state.module.model.tokenizer.state_dict()
    assert tok.keys() == {k[len("model."):] for k in ema if k.startswith("model.")}
    for k, v in tok.items():
        assert torch.equal(v, ema["model." + k]), k
    for k, v in loaded["latent_action"].items():
        assert torch.equal(v, act_ckpt["model." + k]), k
    assert act_state.step == 1 and state.step == 2


def test_gan_alternate_branch_follows_the_step_across_a_resume(tmp_path, monkeypatch):
    """`gan_alternate` trains the generator on even steps and the critic on
    odd ones, by the step count: a run stopped at step 3 and resumed takes
    the branches of an uninterrupted run. (JAX counts the calls of the
    process, so its resumed run starts again at "gen": a known divergence,
    ROADMAP.md.)"""
    import functools

    from open_genie_tpu_torch.train.losses import TokenizerTrainModule

    branches = []
    forward = TokenizerTrainModule.forward

    @functools.wraps(forward)
    def watched(module, video, *args, **kwargs):
        if kwargs.get("train", True):
            branches.append(kwargs.get("gan_branch", "both"))
        return forward(module, video, *args, **kwargs)

    monkeypatch.setattr(TokenizerTrainModule, "forward", watched)
    text = _tokenizer_yaml(str(tmp_path), "alt").replace("trainer:\n",
                                                         "trainer:\n  gan_alternate: true\n")
    cfg = _write(tmp_path / "alt.yaml", text)
    tcli.main(["train", "tokenizer", "--config", cfg, "--max-steps", "3", "--device", "cpu"])
    assert branches == ["gen", "dis", "gen"]
    tcli.main(["train", "tokenizer", "--config", cfg, "--resume", "--device", "cpu"])
    assert branches == ["gen", "dis", "gen", "dis", "gen"]


def test_entry_points_need_cuda_or_an_explicit_cpu(tmp_path):
    """Without CUDA a stage, the CLI and tokenize-data raise unless the
    caller asks for the CPU; more data ranks than processes raise JAX's
    oversubscription message, and so does a model axis wider than the
    processes (tensor parallelism needs n_data x n_model); a gvid source
    with no file for the split raises before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the entry points would run")
    cfg_path = _write(tmp_path / "t.yaml", _tokenizer_yaml(str(tmp_path), "t"))
    cfg = tconfig.load_config(cfg_path, "tokenizer")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.train_tokenizer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["train", "tokenizer", "--config", cfg_path])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["tokenize-data", "--config", cfg_path, "--out", str(tmp_path / "tok"),
                   "--allow-random-params"])
    cfg.trainer.n_data = 2
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        ttrainer.train_tokenizer(cfg, device="cpu")
    cfg.trainer.n_data, cfg.trainer.n_model = 1, 2
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        ttrainer.train_tokenizer(cfg, device="cpu")
    cfg.trainer.n_model = 1
    cfg.trainer.n_data, cfg.data.source, cfg.data.root = 1, "gvid", str(tmp_path)
    with pytest.raises(FileNotFoundError, match="train.gvid"):
        ttrainer.train_tokenizer(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "t_ckpt")
