"""Stage 3 of the port on the CPU: `cli tokenize-data`, then `cli train
dynamics` on its shards against the JAX package's trainer.

`tokenize-data` writes one npz shard per clip that the JAX package's
`TokenClipDataset` reads, equal to `Genie.tokenize_with_actions` of the
same seeded weights. Both CLIs then train the same tiny dynamics YAML on
those shards (4 steps, `--resume` to 6): the same logged steps and metric
names (the port adds `lr`), the same validation steps, step directories,
`best/` and config snapshot.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from open_genie_tpu import cli as jcli  # noqa: E402
from open_genie_tpu.data.tokens import TokenClipDataset as JTokenClipDataset  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch.data.video import SyntheticVideo  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402

torch.set_num_threads(1)

GENIE = """\
seed_everything: 3
model:
  tokenizer:
    enc_desc:
      - [spacetime_downsample, {in_channels: 3, kernel_size: 3, out_channels: 8, time_factor: 1, space_factor: 4}]
      - [space-time_attn, {n_rep: 1, n_head: 1, d_head: 16, d_inp: 8, d_out: 8}]
      - [causal-conv3d, {in_channels: 8, out_channels: 4, kernel_size: 1}]
    dec_desc:
      - [causal-conv3d, {in_channels: 4, out_channels: 8, kernel_size: 3}]
      - [depth2spacetime_upsample, {in_channels: 8, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}]
    d_codebook: 4
  latent_action:
    enc_desc: [[space-time_attn, {n_rep: 1, n_embd: 8, n_head: 1, d_head: 8}]]
    dec_desc: [[space-time_attn, {n_rep: 1, n_embd: 8, n_head: 1, d_head: 8, has_ext: true, time_attn_kw: {key_dim: 2}}]]
    d_codebook: 2
    n_embd: 8
    inp_shape: [16, 16]
  dynamics:
    desc: [[space-time_attn, {n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}]]
    embed_dim: 16
data: {source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, num_videos: 16}
trainer: {precision: "32"}
"""
TRAIN, VAL = 6, 2  # shards written per split


def _dynamics_yaml(root, name, tokens):
    return f"""\
seed_everything: 4
model:
  dynamics:
    desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}}]]
    embed_dim: 16
  tok_vocab: 16
  act_vocab: 4
  optimizer: {{lr: 3e-4, lr_schedule: cosine, warmup_steps: 2, decay_steps: 8}}
data: {{source: tokens, root: {tokens}, batch_size: 4, num_workers: 2}}
trainer:
  max_steps: 6
  precision: "32"
  log_every_n_steps: 1
  val_check_interval: 3
  limit_val_batches: 1
  ckpt_dir: {os.path.join(root, name + "_ckpt")}
  ckpt_every_n_steps: 2
  log_dir: {os.path.join(root, name + "_logs")}
  n_data: 1
"""


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("dyn")
    genie = _write(root / "genie.yaml", GENIE)
    out = root / "tokens"
    for split, n in (("train", TRAIN), ("val", VAL)):
        written = tcli.main(["tokenize-data", "--config", genie, "--allow-random-params",
                             "--out", str(out), "--splits", split, "--limit", str(n),
                             "--device", "cpu"])
        assert written == {split: n}
    return root, genie, out


def test_tokenize_data_writes_jax_readable_shards(shards):
    """Each shard is `tokenize_with_actions` of its clip under the seeded
    weights, read back unchanged by the JAX package's dataset."""
    _, genie_yaml, out = shards
    cfg = tconfig.load_config(genie_yaml, "genie")
    _, module, step = ttrainer.load_genie_params(cfg, device="cpu")
    assert step == 0
    genie = module.model.eval()
    for split, n, seed in (("train", TRAIN, 0), ("val", VAL, 1)):
        ds = JTokenClipDataset(str(out), split=split)
        assert len(ds) == n
        clips = SyntheticVideo(num_videos=16 if split == "train" else 2, num_frames=4,
                               height=16, width=16, seed=seed)
        for i in range(n):
            tokens, acts = genie.tokenize_with_actions(torch.from_numpy(clips[i])[None])
            np.testing.assert_array_equal(ds[i]["tokens"], tokens[0].numpy())
            np.testing.assert_array_equal(ds[i]["actions"], acts[0].numpy())
            assert ds[i]["tokens"].shape == (4, 4, 4) and ds[i]["tokens"].max() < 16


def _records(log_dir):
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _keys(recs):
    return [(r["step"], sorted(set(r) - {"step", "time", "lr"})) for r in recs]


def test_dynamics_cadence_matches_jax(shards):
    root, _, tokens = shards
    out = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        cfg = _write(root / f"{name}.yaml", _dynamics_yaml(str(root), name, tokens))
        main(["train", "dynamics", "--config", cfg, "--max-steps", "4"] + extra)
        first = _keys(_records(root / f"{name}_logs"))
        main(["train", "dynamics", "--config", cfg, "--resume"] + extra)
        ckpt = root / f"{name}_ckpt"
        with open(ckpt / "config.yaml") as f:
            snap = f.read().replace(f"{name}_ckpt", "CKPT").replace(f"{name}_logs", "LOGS")
        out[name] = dict(first=first, second=_keys(_records(root / f"{name}_logs")),
                         dirs=sorted(d for d in os.listdir(ckpt) if d.isdigit()),
                         best=sorted(os.listdir(ckpt / "best")), snapshot=snap)
    assert out["port"] == out["jax"]
    assert out["port"]["dirs"] == ["4", "6"] and len(out["port"]["best"]) == 1
    recs = _records(root / "port_logs")
    assert [r["step"] for r in recs if "val_loss" in r] == [3, 6]
    sched = tconfig.OptimizerConfig(lr=3e-4, lr_schedule="cosine", warmup_steps=2,
                                    decay_steps=8).schedule()
    assert [r["lr"] for r in recs if "loss" in r] == [sched(s - 1) for s in range(1, 7)]
    assert {"dyn_loss", "dyn_masked_acc", "grad_norm", "steps_per_sec"} <= set(recs[0])
