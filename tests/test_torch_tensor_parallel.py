"""Tensor- and data-parallel training of the port on gloo ranks against the
JAX package's step on a `(data 2, model 2)` mesh, on the CPU.

The test process seeds each case's weights in the port, hands them to JAX
through the bridge's mapping (`tests/test_torch_distributed.py`'s cases:
the compact Genie step, the compact tokenizer step with a 13-bit
codebook, so `LfqAvgEntropy`'s q is all-reduced over the data group only,
and the stage-3 dynamics step; beside them the dynamics step with
biases and a hidden FFN layer, `DYNAMICS_BIAS`), and writes what the
ranks run. Four
processes of `tests/torch_tp_worker.py` (no JAX), launched once for the
module as a 2 x 2 mesh, run each step with the weights split over the
model axis (`parallel.tensor.shard_module`) and each data shard on its
rows of the batch and of the noise JAX drew for it; two more, a 1 x 2
mesh, run `cli train genie` with `trainer.n_model: 2`. Meanwhile the test
process computes JAX's references: the train step of
`tests/test_torch_distributed.py` on `make_mesh(n_data=2, n_model=2)`,
its state placed by `shard_state` (as `tests/test_train.py` places it)
and the batch sharded over the data axis.

Tolerances: the loss within 1e-5 relative, every metric within rtol
1e-4 / atol 1e-6, every gradient as AdamW applies it (summed over the
data group, clipped), gathered into the one-process layout, within
`tools/parity_check.py`'s atol 2e-3 / rtol 2e-2, the grad norm within
rtol 2e-2, the update within 2.1 lr. The two controls, on the same
steps, must miss them: `copy_to_model` with an identity backward (a
split layer's input gradient is then this rank's heads' alone) and each
rank's loss seeded with 1/world instead of 1/n_data (the clipped
gradients agree, the norm is halved). The vocabulary-parallel log-softmax
and argmax over 2 ranks at vocab 2^12, with ties planted across the
ranks' blocks, against one process: 1e-6 relative, the argmax exact.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from open_genie_tpu.parallel.mesh import batch_sharding as jbatch_sharding  # noqa: E402
from open_genie_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from open_genie_tpu.train import loop as jloop  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from open_genie_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.train import losses as tlosses  # noqa: E402
from open_genie_tpu_torch.utils import init_weights  # noqa: E402
from tests.test_torch_distributed import (  # noqa: E402
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    METRIC_TOL,
    REPO,
    _cases,
    _flax_params,
    _free_port,
    _jax_mask,
    _np_tree,
)
from tools.parity_check import RTOL  # noqa: E402

torch.set_num_threads(1)
N_DATA, N_MODEL = 2, 2
VOCAB, VOCAB_ROWS = 2 ** 12, 64
VOCAB_RTOL = 1e-6
TRAIN_STEPS, CKPT_AT = 3, 2
# The stage-3 case with biases and a hidden FFN layer: the split biases of
# q | k | v and of the FFN's block_0, to_out's bias after the reduce, and
# the row-split block_1 with its one reduce.
DYNAMICS_BIAS = dict(desc=(("space-time_attn", {"n_rep": 2, "n_embd": 32, "n_head": 2,
                                                 "d_head": 16, "bias": True, "hid_dim": 48}),),
                     tok_vocab=64, act_vocab=16, embed_dim=32)
CASES = ["genie", "tokenizer", "dynamics", "dynamics_bias"]

GENIE_YAML = """\
seed_everything: 6
model:
  tokenizer:
    enc_desc:
      - [spacetime_downsample, {{in_channels: 3, kernel_size: 3, out_channels: 8, time_factor: 1, space_factor: 4}}]
      - [space-time_attn, {{n_rep: 1, n_head: 1, d_head: 16, d_inp: 8, d_out: 8}}]
      - [causal-conv3d, {{in_channels: 8, out_channels: 4, kernel_size: 1}}]
    dec_desc:
      - [causal-conv3d, {{in_channels: 4, out_channels: 8, kernel_size: 3}}]
      - [depth2spacetime_upsample, {{in_channels: 8, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}}]
    d_codebook: 4
  latent_action:
    enc_desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}}]]
    dec_desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8, has_ext: true, time_attn_kw: {{key_dim: 2}}}}]]
    d_codebook: 2
    n_embd: 16
    inp_shape: [16, 16]
  dynamics:
    desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}}]]
    embed_dim: 16
  optimizer: {{lr: 1e-3, ema_decay: 0.9}}
data: {{source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, num_videos: 16}}
trainer:
  max_steps: {steps}
  precision: "32"
  log_every_n_steps: 1
  val_check_interval: {steps}
  limit_val_batches: 1
  ckpt_every_n_steps: {every}
  ckpt_max_keep: 3
  n_data: 1
  n_model: {n_model}
  ckpt_dir: {work}/{name}_ckpt
  log_dir: {work}/{name}_logs
"""


STAGE_STEPS = 2
# `cli train tokenizer`, `action` and `dynamics` on 2 model ranks against
# one process: the tokenizer (2 heads, a frame discriminator with an
# attention of 2 heads), the latent action of GENIE_YAML, and the dynamics
# on the token shards `cli tokenize-data` writes from GENIE_YAML's model.
STAGE_MODELS = {
    "tokenizer": """\
  enc_desc:
    - [spacetime_downsample, {{in_channels: 3, kernel_size: 3, out_channels: 16, time_factor: 1, space_factor: 4}}]
    - [space-time_attn, {{n_rep: 1, n_head: 2, d_head: 8, d_inp: 16, d_out: 16}}]
    - [causal-conv3d, {{in_channels: 16, out_channels: 4, kernel_size: 1}}]
  dec_desc:
    - [causal-conv3d, {{in_channels: 4, out_channels: 16, kernel_size: 3}}]
    - [space-time_attn, {{n_rep: 1, n_head: 2, d_head: 8, d_inp: 16, d_out: 16}}]
    - [depth2spacetime_upsample, {{in_channels: 16, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}}]
  d_codebook: 4
  disc_kwargs: {{inp_size: [16, 16], model_dim: 8, dim_mults: [1, 2], down_step: [null, 2], num_groups: 4, num_heads: 2, dim_head: 8}}
  gan_frames_per_batch: 2
  perc_loss_weight: 0.0
  optimizer: {{lr: 1e-3, ema_decay: 0.8}}
""",
    "action": """\
  latent_action:
    enc_desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}}]]
    dec_desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8, has_ext: true, time_attn_kw: {{key_dim: 2}}}}]]
    d_codebook: 2
    n_embd: 16
    inp_shape: [16, 16]
  optimizer: {{lr: 1e-3}}
""",
    "dynamics": """\
  dynamics:
    desc: [[space-time_attn, {{n_rep: 1, n_embd: 16, n_head: 2, d_head: 8}}]]
    embed_dim: 16
  tok_vocab: 16
  act_vocab: 4
  optimizer: {{lr: 1e-3}}
""",
}
STAGE_DATA = {"tokenizer": "{{source: synthetic, num_frames: 4, batch_size: 2, height: 16, "
                           "width: 16, num_videos: 8}}",
              "action": "{{source: synthetic, num_frames: 4, batch_size: 2, height: 16, "
                        "width: 16, num_videos: 8}}",
              "dynamics": "{{source: tokens, root: {work}/tokens, batch_size: 2}}"}


def _stage_yaml(work, what, n_model):
    name = f"{what}_{n_model}"
    text = (f"seed_everything: 7\nmodel:\n{STAGE_MODELS[what]}data: {STAGE_DATA[what]}\n"
            f"trainer: {{{{max_steps: {STAGE_STEPS}, precision: '32', log_every_n_steps: 1, "
            f"n_data: 1, n_model: {n_model}, ckpt_every_n_steps: 100, "
            f"ckpt_dir: {{work}}/{name}_ckpt, log_dir: {{work}}/{name}_logs}}}}\n")
    (work / f"{name}.yaml").write_text(text.format(work=work))
    return str(work / f"{name}.yaml")


def _jax_tp_step(jm, tm, params, batch, key, frozen):
    """The JAX package's train step on `make_mesh(n_data=2, n_model=2)`,
    the state placed by `shard_state` and the batch over the data axis:
    the loss, metrics, the gradients as the clip scales them in the
    port's names, their norm, and the update."""
    jfrozen = jlosses.frozen_param_mask(params, tuple(
        f.replace("tokenizer", "tokenizer_") for f in frozen)) if frozen else None
    jopt = jloop.make_optimizer(lr=LR, frozen_mask=jfrozen)
    mesh = jmake_mesh(n_data=N_DATA, n_model=N_MODEL)
    state = jloop.shard_state(jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                               opt_state=jopt.init(params), key=key), mesh)
    assert any("model" in tuple(a.sharding.spec) for a in jax.tree.leaves(state.params))

    def step(p, opt_state, b):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jm.apply({"params": q}, b, key), has_aux=True)(p)
        return loss, metrics, grads, jopt.update(grads, opt_state, p)[0]

    loss, metrics, grads, updates = jax.jit(step, in_shardings=(
        None, None, jbatch_sharding(mesh)))(state.params, state.opt_state, batch)
    trainable = tlosses.frozen_param_mask(tm, frozen)
    g, _ = state_dict_from_flax(_np_tree(grads), tm)
    g = {n: v for n, v in g.items() if trainable[n]}
    norm = float(optax.global_norm([v.numpy() for v in g.values()]))
    scale = 1.0 if norm < 1.0 else 1.0 / norm  # make_optimizer's grad_clip 1.0
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: v * scale for n, v in g.items()}, "grad_norm": norm,
            "params": tm.state_dict(), "updates": state_dict_from_flax(_np_tree(updates), tm)[0]}


def _bias_case():
    """`tests/test_torch_distributed.py::_case` of DYNAMICS_BIAS."""
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 64, (4, 3, 4, 4)).astype(np.int32),
             "actions": rng.integers(0, 16, (4, 3)).astype(np.int32)}
    key = jax.random.PRNGKey(9)
    jm, tm = (jlosses.DynamicsTrainModule(dynamics=DYNAMICS_BIAS),
              tlosses.DynamicsTrainModule(DYNAMICS_BIAS))
    init_weights(tm, torch.Generator().manual_seed(4))
    for name, p in tm.named_parameters():  # biases of zero would hide a doubled one
        if name.endswith("bias"):
            with torch.no_grad():
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(len(name)))
    params = _flax_params(jm, tm, batch, {})
    spec = {"kind": "dynamics", "config": DYNAMICS_BIAS, "state_dict": tm.state_dict(),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()}, "lr": LR,
            "frozen": (), "noise": {"mask": torch.from_numpy(
                _jax_mask(key, batch["tokens"].shape))}}
    return spec, (jm, tm, params, batch, key, ())


def _vocab_spec():
    """Logits of 64 rows over 2^12 codes, with the row's maximum planted
    twice in 48 rows, once in each rank's half (the lower index first in
    some, the boundary pair 2047 / 2048 in one), and random targets."""
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((VOCAB_ROWS, VOCAB)).astype(np.float32) * 3
    half = VOCAB // 2
    for r in range(48):
        a = 2047 if r == 0 else int(rng.integers(0, half))
        b = half if r == 0 else int(rng.integers(half, VOCAB))
        logits[r, a] = logits[r, b] = logits[r].max() + 1.0
    return {"logits": torch.from_numpy(logits),
            "target": torch.from_numpy(rng.integers(0, VOCAB, VOCAB_ROWS))}


def _launch(work, mode, world):
    env = {**os.environ, "PYTHONPATH": REPO, "OGT_COORDINATOR": f"localhost:{_free_port()}",
           "OGT_NUM_PROCESSES": str(world)}
    procs = []
    for rank in range(world):
        log = open(work / f"{mode}_rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"), mode, str(work)],
            env={**env, "OGT_PROCESS_ID": str(rank)}, stdout=log, stderr=subprocess.STDOUT,
            cwd=REPO), log))
    return procs


def _finish(procs, work, mode):
    try:
        codes = [p.wait(timeout=600) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = [(work / f"{mode}_rank{r}.log").read_text() for r in range(len(procs))]
    assert codes == [0] * len(procs), f"{mode} rank exit codes {codes}:\n" + "\n".join(
        log[-4000:] for log in logs)
    return [torch.load(work / f"{mode}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))], logs


def _genie_yaml(work, name, n_model, steps=TRAIN_STEPS):
    path = work / f"{name}.yaml"
    path.write_text(GENIE_YAML.format(steps=steps, every=CKPT_AT, n_model=n_model, work=work,
                                      name=name))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, JAX's references (computed while the ranks run)
    and the work dir of the trainer runs."""
    work = tmp_path_factory.mktemp("tp")
    cases = {**_cases(), "dynamics_bias": _bias_case()}
    for name, (spec, _) in cases.items():
        torch.save(spec, work / f"case_{name}.pt")
    torch.save(_vocab_spec(), work / "vocab.pt")
    # The one-process run whose step-2 checkpoint the 1 x 2 mesh resumes.
    one = _genie_yaml(work, "one", 1)
    tcli.main(["train", "genie", "--config", one, "--device", "cpu"])
    (work / "resume_ckpt").mkdir()
    for name in (str(CKPT_AT), "config.yaml"):
        src = work / "one_ckpt" / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, work / "resume_ckpt" / name)
    _genie_yaml(work, "tp", 2)
    _genie_yaml(work, "resume", 2)
    tcli.main(["tokenize-data", "--config", one, "--device", "cpu", "--allow-random-params",
               "--out", str(work / "tokens"), "--splits", "train"])
    for what in STAGE_MODELS:
        _stage_yaml(work, what, 2)
    running = {"cases": _launch(work, "cases", N_DATA * N_MODEL),
               "trainer": _launch(work, "trainer", N_MODEL)}
    try:
        refs = {name: _jax_tp_step(*args) for name, (_, args) in cases.items()}
        for what in STAGE_MODELS:
            tcli.main(["train", what, "--config", _stage_yaml(work, what, 1), "--device", "cpu"])
    finally:
        out = {mode: _finish(procs, work, mode) for mode, procs in running.items()}
    return refs, out["cases"][0], out["trainer"], work


def _misses(got: dict, ref: dict) -> list:
    """What of a rank's step misses the tolerances."""
    out = []
    if not np.isclose(float(got["metrics"]["loss"]), ref["loss"], rtol=LOSS_RTOL, atol=0):
        out.append(f"loss {float(got['metrics']['loss'])} vs {ref['loss']}")
    for k, v in ref["metrics"].items():
        if not np.isclose(float(got["metrics"][k]), v, **METRIC_TOL):
            out.append(f"{k} {float(got['metrics'][k])} vs {v}")
    if not np.isclose(float(got["metrics"]["grad_norm"]), ref["grad_norm"], rtol=RTOL, atol=0):
        out.append(f"grad_norm {float(got['metrics']['grad_norm'])} vs {ref['grad_norm']}")
    for n, g in ref["grads"].items():
        if not np.allclose(got["grads"][n].numpy(), g.numpy(), **GRAD_TOL):
            out.append(f"gradient {n}")
    return out


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_the_jax_mesh_step(runs, case):
    """Loss, every metric, the grad norm, every gathered gradient and every
    parameter after the step, on each of the four ranks, against JAX's
    step on `make_mesh(n_data=2, n_model=2)`."""
    refs, ranks, *_ = runs
    ref = refs[case]
    for rank, out in enumerate(ranks):
        got = out[case]["tp"]
        assert got["split"], f"{case}: nothing split"
        assert set(got["metrics"]) == set(ref["metrics"]) | {"loss", "grad_norm"}, rank
        assert set(got["grads"]) == set(ref["grads"])
        assert _misses(got, ref) == [], (rank, _misses(got, ref))
        for name, p in got["params"].items():
            upd = (p - ref["params"][name]).numpy()
            np.testing.assert_allclose(upd, ref["updates"][name].numpy(), atol=2.1 * LR,
                                       err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_tp_ranks_agree(runs, case):
    """The model ranks of a data shard hold bit-equal replicated
    parameters, and every rank the same metrics and whole parameters."""
    _, ranks, *_ = runs
    first = ranks[0][case]["tp"]
    for out in ranks[1:]:
        got = out[case]["tp"]
        for k in first["metrics"]:
            assert torch.equal(first["metrics"][k], got["metrics"][k]), k
        for name in first["params"]:
            assert torch.equal(first["params"][name], got["params"][name]), name
    for shard in range(N_DATA):
        a, b = (ranks[shard * N_MODEL + m][case]["tp"]["replicated"] for m in range(N_MODEL))
        assert a.keys() == b.keys() and a
        for name in a:
            assert torch.equal(a[name], b[name]), (shard, name)


@pytest.mark.parametrize("control", ["copy_identity", "seed_world"])
@pytest.mark.parametrize("case", CASES)
def test_tp_controls_miss_the_tolerance(runs, case, control):
    """A split layer's input gradient of this rank's heads alone, or each
    rank's loss seeded with 1/world, is another step: it misses the
    tolerance that the real one meets."""
    refs, ranks, *_ = runs
    assert _misses(ranks[0][case][control], refs[case]), f"the {control} {case} step met it"


def test_vocab_parallel_log_softmax_and_argmax(runs):
    """Each model group's vocabulary-parallel log-softmax at the targets
    and its gradient within 1e-6 relative of one process's, the argmax
    exact, ties across the ranks' blocks going to the lower index."""
    from open_genie_tpu_torch.parallel.tensor import vocab_parallel_log_prob

    _, ranks, *_ = runs
    spec = _vocab_spec()
    logits = spec["logits"].clone().requires_grad_()
    logp = vocab_parallel_log_prob(logits, spec["target"], None)
    logp.sum().backward()
    argmax = spec["logits"].argmax(-1)
    assert argmax[0] == 2047  # the boundary pair
    for shard in range(N_DATA):
        outs = [ranks[shard * N_MODEL + m]["vocab"] for m in range(N_MODEL)]
        for out in outs:
            np.testing.assert_allclose(out["logp"].numpy(), logp.detach().numpy(),
                                       rtol=VOCAB_RTOL)
            assert torch.equal(out["argmax"], argmax)
        dlogits = torch.cat([out["dlogits"] for out in outs], dim=-1)
        np.testing.assert_allclose(dlogits.numpy(), logits.grad.numpy(), rtol=VOCAB_RTOL,
                                   atol=VOCAB_RTOL * logits.grad.abs().max().item())


def _checkpoint(work, name, step):
    path = work / f"{name}_ckpt" / str(step)
    return torch.load(path / "params.pt"), torch.load(path / "train_state.pt")


def _losses(work, name):
    with open(work / f"{name}_logs" / "train_metrics.jsonl") as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}


def _close_steps(a, b, what):
    """Two runs' parameters after the same step from the same state: the
    same f32 math summed in another order, within 2.1 lr (Adam's first
    steps move each element by about lr x sign(g))."""
    assert a.keys() == b.keys(), what
    for name in a:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), atol=2.1e-3,
                                   err_msg=f"{what}: {name}")


def test_tp_cli_train_genie_checkpoints(runs):
    """`cli train genie` on a 1 x 2 mesh: rank 0 alone writes the
    checkpoints, in the one-process keys and shapes (EMA and moments
    too); the split covers the latent action, the dynamics' attentions,
    FFNs, embeddings and head, not the 1-head tokenizer's attention."""
    *_, (trainer, logs), work = runs
    assert trainer[1]["written"] == []
    assert sorted(w for w in trainer[0]["written"] if w[0] in ("resume_ckpt", "tp_ckpt")) == [
        ("resume_ckpt", TRAIN_STEPS), ("tp_ckpt", CKPT_AT), ("tp_ckpt", TRAIN_STEPS)]
    assert "[step 1]" in logs[0] and "[step" not in logs[1]
    split = trainer[0]["tp"]["split"]
    assert "model.dynamics.head.weight" in split and "model.dynamics.tok_emb.weight" in split
    assert any(n.startswith("model.latent_action.") for n in split)
    assert not any("tokenizer.enc_layers.1.space_attn" in n for n in split)
    tp, tp_state = _checkpoint(work, "tp", CKPT_AT)
    one, one_state = _checkpoint(work, "one", CKPT_AT)
    assert {k: v.shape for k, v in tp.items()} == {k: v.shape for k, v in one.items()}
    for part in ("ema",):
        a, b = tp_state["optimizer"][part], one_state["optimizer"][part]
        assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    a, b = tp_state["optimizer"]["adamw"]["state"], one_state["optimizer"]["adamw"]["state"]
    assert {i: s["exp_avg"].shape for i, s in a.items()} == {
        i: s["exp_avg"].shape for i, s in b.items()}
    _close_steps(tp, one, "the TP run at step 2 against one process")


def test_tp_checkpoint_resumes_on_one_process_and_back(runs):
    """The TP run's step-2 checkpoint resumed on one process gives the TP
    run's step 3 (loss within 1e-5 relative, parameters as
    `_close_steps`); the one-process step-2 checkpoint resumed on the
    1 x 2 mesh gives the one-process run's step 3."""
    *_, work = runs
    back = work / "back_ckpt"
    back.mkdir(exist_ok=True)
    for name in (str(CKPT_AT), "config.yaml"):
        src = work / "tp_ckpt" / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, back / name)
    text = (work / "one.yaml").read_text().replace("one_ckpt", "back_ckpt").replace(
        "one_logs", "back_logs")
    (work / "back.yaml").write_text(text)
    state = tcli.main(["train", "genie", "--config", str(work / "back.yaml"), "--device", "cpu",
                       "--resume"])
    assert state.step == TRAIN_STEPS
    tp, one = _losses(work, "tp"), _losses(work, "one")
    back_losses, resumed = _losses(work, "back"), _losses(work, "resume")
    assert sorted(back_losses) == sorted(resumed) == [TRAIN_STEPS]
    np.testing.assert_allclose(back_losses[TRAIN_STEPS], tp[TRAIN_STEPS], rtol=LOSS_RTOL)
    np.testing.assert_allclose(resumed[TRAIN_STEPS], one[TRAIN_STEPS], rtol=LOSS_RTOL)
    _close_steps(_checkpoint(work, "back", TRAIN_STEPS)[0],
                 _checkpoint(work, "tp", TRAIN_STEPS)[0], "TP resumed on one process")
    _close_steps(_checkpoint(work, "resume", TRAIN_STEPS)[0],
                 _checkpoint(work, "one", TRAIN_STEPS)[0], "one process resumed under TP")


def test_genie_tp_flagship_config_is_the_dry_runs():
    import __graft_entry__

    from open_genie_tpu_torch.models.configs import genie_tp_flagship_config

    assert genie_tp_flagship_config() == __graft_entry__._GENIE_FLAGSHIP


def test_tp_layout_of_the_flagship_split():
    """On the flagship Genie (built on the meta device) the 2^18 head and
    the token embedding split in two, the derived splits follow their
    weights, and the frozen tokenizer (no attention) stays whole."""
    from open_genie_tpu_torch.models.configs import genie_tp_flagship_config
    from open_genie_tpu_torch.parallel.mesh import Mesh
    from open_genie_tpu_torch.parallel.tensor import tp_layout

    with torch.device("meta"):
        module = tlosses.GenieTrainModule(genie_tp_flagship_config())
    layout = tp_layout(module, Mesh(1, 2))
    dyn = "model.dynamics."
    assert tuple(module.get_parameter(dyn + "head.weight").shape) == (2 ** 18, 512)
    assert layout[dyn + "head.weight"] == layout[dyn + "head.bias"] == (0, 1)
    assert layout[dyn + "tok_emb.weight"] == layout[dyn + "act_emb.weight"] == (1, 1)
    assert layout[dyn + "layers.0.space_attn.attn.to_qkv.weight"] == (0, 3)
    assert layout[dyn + "layers.0.space_attn.attn.to_out.weight"] == (1, 1)
    assert layout[dyn + "layers.0.ffn.block_0.weight"] == (0, 1)
    assert layout[dyn + "layers.0.ffn.norm.weight"] is None
    cross = "model.latent_action.dec_layers.0.temp_attn.attn."
    assert all(layout[cross + f"{w}.weight"] == (0, 1) for w in ("to_q", "to_k", "to_v"))
    assert not any(split for n, split in layout.items() if n.startswith("model.tokenizer."))


def test_tp_layout_replicates_what_does_not_divide():
    """An attention whose heads do not divide by n_model runs replicated
    (JAX's rule would still split its 48-wide projections); the biases
    follow their weights; a rule that no module runs split raises."""
    from open_genie_tpu_torch.modules.attention import SpaceTimeAttention
    from open_genie_tpu_torch.parallel.mesh import Mesh, param_shardings
    from open_genie_tpu_torch.parallel.tensor import tp_layout

    block = SpaceTimeAttention(n_head=3, d_head=16, d_inp=48, bias=True)
    mesh = Mesh(1, 2)
    assert param_shardings(block, mesh)["space_attn.attn.to_qkv.weight"] == 0
    layout = tp_layout(block, mesh)
    assert layout["space_attn.attn.to_qkv.weight"] is None
    assert layout["space_attn.attn.to_qkv.bias"] is None
    # the FFN splits by channel, its bias with it
    assert layout["ffn.block_0.weight"] == layout["ffn.block_0.bias"] == (0, 1)
    layout = tp_layout(SpaceTimeAttention(n_head=2, d_head=16, d_inp=32, bias=True), mesh)
    assert layout["temp_attn.attn.to_qkv.bias"] == (0, 3)
    assert layout["temp_attn.attn.to_out.weight"] == (1, 1)
    assert layout["temp_attn.attn.to_out.bias"] is None  # added once, after the reduce

    class Stray(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.head = torch.nn.Linear(4, 8)

    with pytest.raises(ValueError, match="no module runs split"):
        tp_layout(Stray(), mesh)


def test_slices_of_a_fused_projection():
    """Rank i's slice of a `[q | k | v]` weight holds its rows of each of
    the three blocks; the slices of all ranks cover the weight once."""
    from open_genie_tpu_torch.parallel.tensor import slice_of

    w = torch.arange(12 * 2, dtype=torch.float32).reshape(12, 2)
    parts = [slice_of(w, (0, 3), i, 2) for i in range(2)]
    assert parts[0][:, 0].tolist() == [0, 2, 8, 10, 16, 18]
    assert parts[1][:, 0].tolist() == [4, 6, 12, 14, 20, 22]
    cols = [slice_of(w, (1, 1), i, 2) for i in range(2)]
    assert torch.equal(torch.cat(cols, dim=1), w)


def test_mesh_coordinates_and_noise_streams():
    """Rank r sits at (r // n_model, r % n_model); the model ranks of a
    data shard draw one noise stream, one data shard draws the
    one-process stream."""
    from open_genie_tpu_torch.parallel.mesh import Mesh, batch_sharding, rank_seed

    coords = [(Mesh(2, 2, r).data_index, Mesh(2, 2, r).model_index) for r in range(4)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    seeds = [rank_seed(7, Mesh(2, 2, r)) for r in range(4)]
    assert seeds[0] == seeds[1] != seeds[2] == seeds[3] and 7 not in seeds
    assert seeds[0] == rank_seed(7, Mesh(2, 1, 0)) and seeds[2] == rank_seed(7, Mesh(2, 1, 1))
    assert rank_seed(7, Mesh(1, 2, 1)) == 7
    assert [batch_sharding(Mesh(2, 2, r)).index for r in range(4)] == [0, 0, 1, 1]


def test_trainer_takes_a_model_axis():
    """`trainer.n_model: 2` no longer raises NotImplementedError: outside
    a run of two ranks it asks for them, as JAX's mesh does."""
    from open_genie_tpu_torch.train.config import TrainerConfig
    from open_genie_tpu_torch.train.trainer import setup_mesh

    for name in ("OGT_COORDINATOR", "OGT_NUM_PROCESSES", "OGT_PROCESS_ID"):
        assert name not in os.environ
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        setup_mesh(TrainerConfig(n_data=1, n_model=2), "cpu")


@pytest.mark.parametrize("what", list(STAGE_MODELS))
def test_tp_cli_trains_every_stage(runs, what):
    """`cli train <stage>` with `trainer.n_model: 2` splits the stage's
    weights and logs, at its first step, the loss and every metric of the
    one-process run (1e-5 relative, rtol 1e-4 / atol 1e-6); its second
    step, after an update whose near-zero gradients AdamW may step either
    way, within 1e-3."""
    *_, (trainer, _), work = runs
    assert trainer[0][what]["split"] > 0 and trainer[0][what]["step"] == STAGE_STEPS

    def records(n_model):
        with open(work / f"{what}_{n_model}_logs" / "train_metrics.jsonl") as f:
            return {r["step"]: r for r in map(json.loads, f) if "loss" in r}

    tp, one = records(2), records(1)
    assert sorted(tp) == sorted(one) == list(range(1, STAGE_STEPS + 1))
    first = {k: v for k, v in one[1].items() if k not in ("step", "time", "steps_per_sec")}
    np.testing.assert_allclose(tp[1]["loss"], one[1]["loss"], rtol=LOSS_RTOL)
    for k, v in first.items():
        np.testing.assert_allclose(tp[1][k], v, err_msg=k, **METRIC_TOL)
    np.testing.assert_allclose(tp[STAGE_STEPS]["loss"], one[STAGE_STEPS]["loss"], rtol=1e-3)
