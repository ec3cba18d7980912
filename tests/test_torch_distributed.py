"""Data-parallel training of the port on two gloo ranks against the JAX
package's step on a 2-device mesh, on the CPU.

The test process seeds each case's weights in the port, hands them to JAX
through the bridge's mapping, and writes what the ranks run; two processes
of `tests/torch_dp_worker.py` (no JAX), launched once with the `OGT_*`
variables, run it all (one launch for the module) and write back their
results, while the test process computes JAX's references:

  * the compact Genie step, the compact tokenizer step (13-bit codebook,
    so `LfqAvgEntropy`'s all-reduced q; the bit-balance loss on; the
    diversity entropy over a 0.3 stride of the global tokens, which does
    not divide the ranks' blocks) and the stage-3 dynamics step, each rank
    on its half of the batch with its rows of the noise JAX drew for the
    global batch. The reference is the JAX package's train step on
    `make_mesh(n_data=2)`: `jax.value_and_grad` of the loss and the optax
    update, jitted with the batch sharded over the mesh's data axis
    (`batch_sharding`, as `tests/test_train.py` places it);
  * the naive control on the same data: each rank's local means, the
    gradients averaged over the ranks (plain DDP). It must miss the
    tolerance that the data-parallel step meets;
  * the bit-balance loss alone, and the whole LFQ loss (13 bits, entropy,
    bit balance, a 0.3 stride), on each rank's rows of a batch of
    features: the value and the input gradient of one process within
    LFQ_TOL. The bit balance's statistics nest (the rms inside `tanh`, the
    bit means inside the correlations), so a rank's backward must reach
    every rank's use of them;
  * gradient accumulation (2 micro-steps of the dynamics step): one
    gradient all-reduce per applied update, none for the micro-step that
    applies nothing, and the applied mean equal to one process's on the
    same global batches within 1e-6 / rtol 1e-4 (the same math summed in
    another order);
  * a rollout: each rank's rows of the batch and of the Gumbel noise give
    those rows of the one-process rollout exactly;
  * `cli train tokenizer` with `trainer.n_data: 2`: disjoint strides of
    the data, one checkpoint directory written by rank 0 alone, and a run
    resumed at step 3 ending on the uninterrupted run's parameters;
  * `cli tokenize-data` on two ranks: the shards of one process.

Tolerances: the LFQ losses' input gradients within 1e-5 of their
largest |element|, their values within 1e-6 relative; the loss within 1e-5 relative and every metric within rtol
1e-4 / atol 1e-6 (the one-process tests'); every gradient applied within
`tools/parity_check.py`'s atol 2e-3 / rtol 2e-2; the update within 1e-6
where that check fixes the sign of JAX's applied gradient (|g| > 4e-3),
2.1 lr elsewhere; the grad norm within rtol 2e-2; the ranks' metrics and
parameters bit-equal.
"""
import json
import os
import socket
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
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu.train.loop import make_optimizer as jmake_optimizer  # noqa: E402
from open_genie_tpu.utils import random_frame_idxs as jrandom_frame_idxs  # noqa: E402
from open_genie_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    genie_compact_config,
    tokenizer_compact_train_config,
)
from open_genie_tpu_torch.parallel.mesh import global_batch  # noqa: E402
from open_genie_tpu_torch.train import losses as tlosses  # noqa: E402
from open_genie_tpu_torch.utils import init_weights  # noqa: E402
from open_genie_tpu_torch import cli as tcli  # noqa: E402
from tests.test_torch_trainer_dynamics import GENIE  # noqa: E402
from tests.torch_dp_worker import RESUME_AT  # noqa: E402
from tools.parity_check import ATOL, GENIE_CFG, RTOL  # noqa: E402

torch.set_num_threads(1)
WORLD, LR, STEPS = 2, 1e-4, 6
LOSS_RTOL = 1e-5
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(atol=ATOL, rtol=RTOL)
LFQ_TOL = dict(value=1e-6, grad=1e-5)
LFQ_KWARGS = dict(entropy_weight=0.1, bit_balance_weight=1.0, frac_sample=0.3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DYNAMICS = dict(desc=(("space-time_attn", {"n_rep": 2, "n_embd": 32, "n_head": 2, "d_head": 16}),),
                tok_vocab=64, act_vocab=16, embed_dim=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mask(key, shape):
    """The Bernoulli mask `DynamicsModel.compute_loss` draws from `key`."""
    key_rate, key_mask = jax.random.split(key)
    rate = jax.random.uniform(key_rate, (), minval=0.5, maxval=1.0)
    return np.array(jax.random.bernoulli(key_mask, rate, shape))


def _tokenizer_config():
    cfg = tokenizer_compact_train_config()
    cfg["tokenizer"] = dict(cfg["tokenizer"], lfq_bit_balance_weight=0.05, lfq_frac_sample=0.3)
    return cfg


def _flax_params(jm, module, batch, init_kwargs):
    """`module`'s weights (the port's seeded init) as the flax params of
    `jm`, the bridge's mapping inverted element by element: each flax
    leaf of `jm.init`'s shapes (traced, not compiled) is filled with the
    indices of its elements, and `state_dict_from_flax` says where each
    one lands in the port."""
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(lambda k, b: jm.init(k, b, k, **init_kwargs), key, batch)["params"]
    leaves, tree = jax.tree_util.tree_flatten(template)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    probes = [np.arange(a, a + n, dtype=np.float64).reshape(leaf.shape)
              for a, n, leaf in zip(starts, sizes, leaves)]
    mapped, _ = state_dict_from_flax(jax.tree_util.tree_unflatten(tree, probes), module)
    state = module.state_dict()
    flat = np.full(starts[-1], np.nan, np.float32)
    for name, idx in mapped.items():
        flat[idx.numpy().astype(np.int64).ravel()] = state[name].numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(tree, [
        flat[a:a + n].reshape(leaf.shape) for a, n, leaf in zip(starts, sizes, leaves)])


def _case(kind, jm, tm, batch, key, frozen, init_kwargs, noise_of, seed):
    """What a rank needs to run the port's step, and the arguments of JAX's
    reference (`_jax_step`)."""
    init_weights(tm, torch.Generator().manual_seed(seed))
    params = _flax_params(jm, tm, batch, init_kwargs)
    to_torch = lambda t: torch.from_numpy(np.asarray(t))  # noqa: E731
    spec = {"kind": kind, "config": _port_config(kind), "state_dict": tm.state_dict(),
            "batch": jax.tree.map(to_torch, batch), "lr": LR, "frozen": frozen,
            "noise": {k: to_torch(v) for k, v in noise_of(tm).items()}}
    return spec, (jm, tm, params, batch, key, frozen)


def _jax_step(jm, tm, params, batch, key, frozen):
    """The JAX package's train step on `make_mesh(n_data=2)` (the body of
    `train/loop.py::make_train_step`: `value_and_grad`, the optax update),
    jitted with the batch sharded over the data axis, keeping the
    gradients: the reference of a case."""
    jfrozen = jlosses.frozen_param_mask(params, tuple(
        f.replace("tokenizer", "tokenizer_") for f in frozen)) if frozen else None
    jopt = jmake_optimizer(lr=LR, frozen_mask=jfrozen)

    def step(p, b):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jm.apply({"params": q}, b, key), has_aux=True)(p)
        return loss, metrics, grads, jopt.update(grads, jopt.init(p), p)[0]

    mesh = jmake_mesh(n_data=WORLD)
    loss, metrics, grads, updates = jax.jit(
        step, in_shardings=(None, jbatch_sharding(mesh)))(params, batch)
    trainable = tlosses.frozen_param_mask(tm, frozen)
    g, _ = state_dict_from_flax(_np_tree(grads), tm)
    g = {n: v for n, v in g.items() if trainable[n]}
    norm = float(optax.global_norm([v.numpy() for v in g.values()]))
    scale = 1.0 if norm < 1.0 else 1.0 / norm  # make_optimizer's grad_clip 1.0
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: v * scale for n, v in g.items()}, "grad_norm": norm,
            "params": tm.state_dict(), "updates": state_dict_from_flax(_np_tree(updates), tm)[0]}


def _port_config(kind):
    return {"genie": genie_compact_config, "tokenizer": _tokenizer_config,
            "dynamics": lambda: DYNAMICS}[kind]()


def _cases():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(8)
    cases = {}
    # Genie: 4 clips of the latent action's 32x32 frames, 2 a rank.
    video = rng.uniform(size=(4, 4, 32, 32, 3)).astype(np.float32)
    jm = jlosses.GenieTrainModule(genie=GENIE_CFG)

    def genie_noise(tm):
        _, tok = tm.model.tokenizer.tokenize_frozen(torch.from_numpy(video))
        return {"mask": _jax_mask(key, tuple(tok.shape))}

    cases["genie"] = _case("genie", jm, tlosses.GenieTrainModule(genie_compact_config()), video,
                           key, ("model/tokenizer",), {"method": jm.full_init}, genie_noise, 1)
    # Tokenizer: 2 clips, 1 a rank.
    cfg = _tokenizer_config()
    video = (np.abs(rng.standard_normal((2, 4, 32, 32, 3))) % 1.0).astype(np.float32)
    k = min(cfg["gan_frames_per_batch"], 4)

    def tokenizer_noise(tm):
        k_perc, k_gan = jax.random.split(key)
        return {name: np.array(jrandom_frame_idxs(kk, 2, 4, k))
                for name, kk in (("perc_idxs", k_perc), ("gan_idxs", k_gan))}

    cases["tokenizer"] = _case("tokenizer", jlosses.TokenizerTrainModule(**cfg),
                               tlosses.TokenizerTrainModule(**cfg), video, key, ("perc_crit",),
                               {}, tokenizer_noise, 2)
    # Dynamics on token batches: 4 clips, 2 a rank.
    batch = {"tokens": rng.integers(0, 64, (4, 3, 4, 4)).astype(np.int32),
             "actions": rng.integers(0, 16, (4, 3)).astype(np.int32)}
    cases["dynamics"] = _case("dynamics", jlosses.DynamicsTrainModule(dynamics=DYNAMICS),
                              tlosses.DynamicsTrainModule(DYNAMICS), batch, key, (), {},
                              lambda tm: {"mask": _jax_mask(key, batch["tokens"].shape)}, 3)
    return cases


def _rollout_spec(genie_spec):
    """The compact Genie's weights, a 4-clip token prompt, actions and
    Gumbel noise, and the one-process rollout of them."""
    g = torch.Generator().manual_seed(3)
    module = tlosses.GenieTrainModule(genie_compact_config())
    module.load_state_dict(genie_spec["state_dict"])
    genie = module.model.eval()
    _, tok = genie.tokenizer.tokenize_frozen(genie_spec["batch"])
    frames, steps, vocab = 2, 2, genie.dynamics.head.out_features
    spec = {**{k: genie_spec[k] for k in ("kind", "config", "state_dict")},
            "tokens": tok[:, :2], "num_frames": frames, "steps_per_frame": steps,
            "actions": torch.randint(0, 2 ** genie.latent_action.d_codebook,
                                     (tok.shape[0], 2 + frames), generator=g),
            "gumbel": -torch.log(-torch.log(torch.rand(
                frames, steps, tok.shape[0], tok.shape[2] * tok.shape[3], vocab, generator=g)))}
    whole = genie.rollout_tokens(spec["tokens"], spec["actions"], frames, steps,
                                 gumbel=spec["gumbel"])
    return spec, whole


TOKENIZER_YAML = """\
seed_everything: 5
model:
  enc_desc:
    - [spacetime_downsample, {{in_channels: 3, kernel_size: 3, out_channels: 8, time_factor: 1, space_factor: 4}}]
    - [space-time_attn, {{n_rep: 1, n_head: 1, d_head: 16, d_inp: 8, d_out: 8}}]
    - [causal-conv3d, {{in_channels: 8, out_channels: 4, kernel_size: 1}}]
  dec_desc:
    - [causal-conv3d, {{in_channels: 4, out_channels: 8, kernel_size: 3}}]
    - [depth2spacetime_upsample, {{in_channels: 8, out_channels: 3, kernel_size: 3, time_factor: 1, space_factor: 4}}]
  d_codebook: 4
  disc_kwargs: {{inp_size: [16, 16], model_dim: 8, dim_mults: [1, 2], down_step: [null, 2], num_groups: 4, use_attn: false}}
  gan_frames_per_batch: 2
  perc_loss_weight: 0.0
  lfq_bit_balance_weight: 1.0
  optimizer: {{lr: 1e-3, lr_schedule: cosine, warmup_steps: 1, decay_steps: 6, end_lr_scale: 0.1, ema_decay: 0.8}}
data: {{source: synthetic, num_frames: 4, batch_size: 2, height: 16, width: 16, num_videos: 24, num_workers: 2}}
trainer:
  max_steps: {steps}
  precision: "32"
  log_every_n_steps: 1
  val_check_interval: 3
  limit_val_batches: 1
  ckpt_every_n_steps: 3
  ckpt_max_keep: 3
  n_data: 2
  ckpt_dir: {work}/{name}_ckpt
  log_dir: {work}/{name}_logs
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results and JAX's references (computed while the ranks
    run): `(references, one-process rollout, rank results, work dir, rank
    logs)`."""
    work = tmp_path_factory.mktemp("dp")
    cases = _cases()
    for name, (spec, _) in cases.items():
        torch.save(spec, work / f"case_{name}.pt")
    rollout, whole = _rollout_spec(cases["genie"][0])
    torch.save(rollout, work / "rollout.pt")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 8, 13)).astype(np.float32))
    torch.save({"x": x, "lfq_kwargs": LFQ_KWARGS}, work / "lfq.pt")
    for name in ("A", "B"):
        (work / f"cli_{name}.yaml").write_text(
            TOKENIZER_YAML.format(steps=STEPS, work=work, name=name))
    (work / "genie.yaml").write_text(GENIE)
    env = {**os.environ, "PYTHONPATH": REPO, "OGT_COORDINATOR": f"localhost:{_free_port()}",
           "OGT_NUM_PROCESSES": str(WORLD)}
    procs = []
    try:
        for rank in range(WORLD):
            log = open(work / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"), str(work)],
                env={**env, "OGT_PROCESS_ID": str(rank)}, stdout=log,
                stderr=subprocess.STDOUT, cwd=REPO), log))
        refs = {name: _jax_step(*args) for name, (_, args) in cases.items()}
        tcli.main(["tokenize-data", "--config", str(work / "genie.yaml"), "--device", "cpu",
                   "--allow-random-params", "--out", str(work / "tokens_one"), "--limit", "5"])
        codes = [p.wait(timeout=600) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = [(work / f"rank{r}.log").read_text() for r in range(WORLD)]
    assert codes == [0] * WORLD, f"rank exit codes {codes}:\n" + "\n".join(
        log[-4000:] for log in logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return refs, whole, ranks, work, logs, x


def _misses(got: dict, ref: dict) -> list:
    """What of `got` (`metrics`, `grads`) misses the test's tolerances."""
    out = []
    if not np.isclose(float(got["metrics"]["loss"]), ref["loss"], rtol=LOSS_RTOL, atol=0):
        out.append(f"loss {float(got['metrics']['loss'])} vs {ref['loss']}")
    for k, v in ref["metrics"].items():
        if not np.isclose(float(got["metrics"][k]), v, **METRIC_TOL):
            out.append(f"{k} {float(got['metrics'][k])} vs {v}")
    for n, g in ref["grads"].items():
        if not np.allclose(got["grads"][n].numpy(), g.numpy(), **GRAD_TOL):
            out.append(f"gradient {n}")
    return out


@pytest.mark.parametrize("case", ["genie", "tokenizer", "dynamics"])
def test_dp_step_matches_the_jax_mesh_step(runs, case):
    """Loss, every metric, every applied gradient and every parameter after
    the step on each rank against JAX's step on `make_mesh(n_data=2)`;
    the ranks bit-equal; the naive per-rank step misses the tolerance."""
    refs, _, ranks, *_ = runs
    ref = refs[case]
    for rank, out in enumerate(ranks):
        got = out[case]
        assert set(got["metrics"]) == set(ref["metrics"]) | {"loss", "grad_norm"}, rank
        assert _misses(got, ref) == [], (rank, _misses(got, ref))
        np.testing.assert_allclose(float(got["metrics"]["grad_norm"]), ref["grad_norm"],
                                   rtol=RTOL)
        assert set(got["grads"]) == set(ref["grads"])
        for name, p in got["params"].items():
            upd = (p - ref["params"][name]).numpy()
            want = ref["updates"][name].numpy()
            # Where the gradient check fixes the sign of JAX's applied
            # gradient, AdamW's first step agrees to 1e-6.
            clear = (np.abs(ref["grads"][name].numpy()) > 2 * ATOL if name in ref["grads"]
                     else np.zeros(upd.shape, bool))
            np.testing.assert_allclose(upd[clear], want[clear], atol=1e-6, err_msg=name)
            np.testing.assert_allclose(upd, want, atol=2.1 * LR, err_msg=name)
    first, second = (out[case] for out in ranks)
    for k in first["metrics"]:
        assert torch.equal(first["metrics"][k], second["metrics"][k]), k
    for name in first["params"]:
        assert torch.equal(first["params"][name], second["params"][name]), name
    # Plain DDP (local means, averaged gradients) is another objective.
    assert _misses(ranks[0][case]["naive"], ref), f"the naive {case} step met the tolerance"


@pytest.mark.parametrize("name", ["bit_balance", "lfq_loss"])
def test_dp_lfq_input_gradient_matches_one_process(runs, name):
    """Each rank's input gradient of the LFQ loss on its rows, joined in
    rank order, against one process's on the whole batch (the same f32
    math summed in another order), within LFQ_TOL."""
    from open_genie_tpu_torch.ops.lfq import lfq_bit_balance_loss, lfq_loss

    *_, x = runs
    v = x.clone().requires_grad_()
    loss = (lfq_bit_balance_loss(v) if name == "bit_balance" else
            lfq_loss(v, torch.where(v > 0, 1.0, -1.0), **LFQ_KWARGS)[0])
    loss.backward()
    ranks = [out["lfq"][name] for out in runs[2]]
    for got, _ in ranks:
        np.testing.assert_allclose(got.item(), loss.item(), rtol=LFQ_TOL["value"])
    dx = global_batch([g for _, g in ranks])
    err = ((dx - v.grad).abs().max() / v.grad.abs().max()).item()
    assert err <= LFQ_TOL["grad"], f"{name}: input gradient off by {err:.3g} of its max"


def test_dp_accumulation_reduces_once_per_applied_update(runs):
    _, _, ranks, *_ = runs
    one = ranks[0]["accumulation"]["one"]
    for out in ranks:
        dp = out["accumulation"]["dp"]
        assert dp["reduce_calls"] == [0, 1], dp["reduce_calls"]
        assert "grad_norm" not in dp["metric_keys"][0] and "grad_norm" in dp["metric_keys"][1]
        assert set(dp["grads"]) == set(one["grads"])
        for name, g in one["grads"].items():
            torch.testing.assert_close(dp["grads"][name], g, atol=1e-6, rtol=1e-4, msg=name)


def test_dp_rollout_rows_equal_the_one_process_rollout(runs):
    _, whole, ranks, *_ = runs
    assert torch.equal(global_batch([out["rollout"] for out in ranks]), whole)


def test_cli_train_on_two_ranks(runs):
    """Disjoint strides, rank 0 alone logs and writes one checkpoint
    directory, and the run resumed at step 3 ends on the uninterrupted
    run's parameters and logs its losses."""
    _, _, ranks, work, logs, _ = runs
    train = [{i for n, i in out["cli"]["loaded"] if n == 24} for out in ranks]
    assert train[0] and train[1] and not train[0] & train[1]
    assert all(i % WORLD == r for r, idx in enumerate(train) for i in idx)
    assert ranks[1]["cli"]["written"] == []
    assert sorted(w for w in ranks[0]["cli"]["written"] if w[0] != "best") == [
        ("A_ckpt", RESUME_AT), ("A_ckpt", STEPS), ("B_ckpt", STEPS)]
    assert "[step 1]" in logs[0] and "[step" not in logs[1]
    listing = sorted(os.listdir(work / "A_ckpt"))
    assert listing == sorted([str(RESUME_AT), str(STEPS), "best", "config.yaml"]), listing

    def load(name):
        path = work / f"{name}_ckpt" / str(STEPS)
        return (torch.load(path / "params.pt"), torch.load(path / "train_state.pt"))

    (a, a_state), (b, b_state) = load("A"), load("B")
    assert a_state["step"] == b_state["step"] == STEPS
    assert len(a_state["rank_generators"]) == WORLD
    for name in a:
        assert torch.equal(a[name], b[name]), name

    def losses(name):
        with open(work / f"{name}_logs" / "train_metrics.jsonl") as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f) if "loss" in r}

    la, lb = losses("A"), losses("B")
    assert sorted(la) == list(range(1, STEPS + 1))
    assert sorted(lb) == list(range(RESUME_AT + 1, STEPS + 1))
    assert all(lb[s] == la[s] for s in lb)


def test_tokenize_data_on_two_ranks_writes_the_one_process_shards(runs):
    work = runs[3]
    one = sorted(p.relative_to(work / "tokens_one") for p in (work / "tokens_one").rglob("*.npz"))
    two = sorted(p.relative_to(work / "tokens") for p in (work / "tokens").rglob("*.npz"))
    assert one == two and len(one) == 7  # 5 train clips, the 2 of the validation split
    for rel in one:
        a, b = np.load(work / "tokens_one" / rel), np.load(work / "tokens" / rel)
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files), rel
