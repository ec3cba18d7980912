"""The port's trainer core against the JAX package on the CPU.

Schedules against optax; several `make_train_step` steps (cosine schedule,
EMA, gradient accumulation, a frozen prefix, the LFQ anneals) on a compact
`TokenizerTrainModule` and on a compact `DynamicsTrainModule` against JAX's
`make_optimizer` and `make_train_step` (JAX weights through `bridge.py`,
JAX's Bernoulli masks fed to the port); the three repairs of the train
step; `load_config` of every repo YAML; the data sources and the loader's
batch order; checkpoints, resume and `CheckpointWriter`.
Tolerances: schedules rtol 1e-6 (optax computes in f32); parameters, EMA
and metrics atol 2e-5 in f32; gradient norms rtol 1e-4 (f32 sums in
another order, through the LFQ's beta = 100 logits).
"""
import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from open_genie_tpu.data import loader as jloader  # noqa: E402
from open_genie_tpu.data import tokens as jtokens  # noqa: E402
from open_genie_tpu.data import video as jvideo  # noqa: E402
from open_genie_tpu.train import config as jconfig  # noqa: E402
from open_genie_tpu.train import loop as jloop  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu.train import trainer as jtrainer  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.data import loader as tloader  # noqa: E402
from open_genie_tpu_torch.data import tokens as ttokens  # noqa: E402
from open_genie_tpu_torch.data import video as tvideo  # noqa: E402
from open_genie_tpu_torch.train import config as tconfig  # noqa: E402
from open_genie_tpu_torch.train import loop as tloop  # noqa: E402
from open_genie_tpu_torch.train import trainer as ttrainer  # noqa: E402
from open_genie_tpu_torch.train.losses import DynamicsTrainModule, frozen_param_mask  # noqa: E402
from open_genie_tpu_torch.utils import init_weights  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------- #

SCHEDULES = {
    "constant": dict(),
    "constant_warmup": dict(warmup_steps=4),
    "cosine": dict(lr_schedule="cosine", warmup_steps=3, decay_steps=12, end_lr_scale=0.05),
    "cosine_no_warmup": dict(lr_schedule="cosine", decay_steps=9),
    "linear": dict(lr_schedule="linear", warmup_steps=2, decay_steps=10, end_lr_scale=0.1),
    "linear_to_zero": dict(lr_schedule="linear", warmup_steps=3, decay_steps=7),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    kw = dict(lr=3e-4, **SCHEDULES[name])
    ref, got = jconfig.OptimizerConfig(**kw).schedule(), tconfig.OptimizerConfig(**kw).schedule()
    for step in range(kw.get("decay_steps", 10) + 6):
        want = float(ref(step)) if callable(ref) else ref
        np.testing.assert_allclose(got(step), want, rtol=1e-6, atol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("kw", [dict(lr_schedule="cosine"),
                                dict(lr_schedule="cosine", warmup_steps=5, decay_steps=5),
                                dict(lr_schedule="linear", warmup_steps=6, decay_steps=4),
                                dict(lr_schedule="step", decay_steps=4)])
def test_schedule_raises_as_jax(kw):
    with pytest.raises(ValueError) as ref:
        jconfig.OptimizerConfig(**kw).schedule()
    with pytest.raises(ValueError) as got:
        tconfig.OptimizerConfig(**kw).schedule()
    assert str(got.value) == str(ref.value)


# --------------------------------------------------------------------- #
# load_config of every repo YAML
# --------------------------------------------------------------------- #

def _norm(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


YAMLS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("name", YAMLS)
def test_load_config_matches_jax(name):
    """Every kind that JAX's `load_config` parses the YAML as gives the
    same fields in the port (named blueprints resolved to the port's equal
    copies); a kind JAX refuses the port refuses with the same error."""
    path = os.path.join(REPO, "configs", name)
    parsed = 0
    for kind in ("tokenizer", "genie", "dynamics", "action"):
        try:
            ref = jconfig.load_config(path, kind)
        except Exception as e:  # noqa: BLE001 -- the port must raise the same
            with pytest.raises(type(e)):
                tconfig.load_config(path, kind)
            continue
        got = tconfig.load_config(path, kind)
        assert type(got.model).__name__ == type(ref.model).__name__
        assert _norm(got) == _norm(ref), (name, kind)
        parsed += 1
    assert parsed >= 1


# --------------------------------------------------------------------- #
# The three repairs of the train step
# --------------------------------------------------------------------- #

class _Quadratic(torch.nn.Module):
    """loss = scale * mean((w * x - 1)^2) with a frozen `b`."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((3,), 0.5))
        self.b = torch.nn.Parameter(torch.ones(3))

    def forward(self, x, scale=1.0, seen=None):
        if seen is not None:
            seen.append(scale)
        loss = scale * ((self.w * self.b * x - 1) ** 2).mean()
        return loss, {"loss": loss}


def test_step_schedules_are_evaluated_on_the_state_step():
    """A callable loss kwarg is called with the state's step before each
    call, micro-steps of an accumulation included (JAX's `state.step`);
    the old step passed the function itself on to the module."""
    module = _Quadratic()
    opt = tloop.make_optimizer(module, lr=0.1, accum_steps=2,
                               frozen_mask={"w": True, "b": False})
    state = tloop.TrainState(module, opt)
    step = tloop.make_train_step(state, loss_kwargs={"scale": lambda s: 1.0 + s})
    seen = []
    for _ in range(5):
        metrics = step(torch.ones(3), seen=seen)
    assert seen == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert state.step == 5 and step.state is state
    assert opt.updates == 2 and opt.mini_step == 1
    np.testing.assert_allclose(metrics["loss"].item(), 5.0 * (module.w[0].item() - 1) ** 2,
                               rtol=1e-6)
    assert torch.equal(module.b, torch.ones(3))


def test_cast_batch_casts_lists_and_tuples():
    f32, ids = torch.zeros(2), torch.zeros(2, dtype=torch.int32)
    batch = {"a": [f32, (f32, ids)], "b": (f32,)}
    out = tloop._cast_batch(batch, torch.bfloat16)
    assert out["a"][0].dtype == torch.bfloat16 and isinstance(out["a"][1], tuple)
    assert out["a"][1][0].dtype == torch.bfloat16 and out["a"][1][1].dtype == torch.int32
    assert isinstance(out["b"], tuple) and out["b"][0].dtype == torch.bfloat16
    assert tloop._cast_batch([f32], torch.bfloat16)[0].dtype == torch.bfloat16


# --------------------------------------------------------------------- #
# make_train_step against JAX over several steps
# --------------------------------------------------------------------- #

TOK_ENC = (
    ("spacetime_downsample", {"in_channels": 3, "kernel_size": 3, "out_channels": 8,
                              "time_factor": 1, "space_factor": 4}),
    ("space-time_attn", {"n_rep": 1, "n_head": 1, "d_head": 16, "d_inp": 8, "d_out": 8}),
    ("causal-conv3d", {"in_channels": 8, "out_channels": 6, "kernel_size": 1}),
)
TOK_DEC = (
    ("causal-conv3d", {"in_channels": 6, "out_channels": 8, "kernel_size": 3}),
    ("depth2spacetime_upsample", {"in_channels": 8, "out_channels": 3, "kernel_size": 3,
                                  "time_factor": 1, "space_factor": 4}),
)
OPT = dict(lr=1e-3, lr_schedule="cosine", warmup_steps=1, decay_steps=5, end_lr_scale=0.1,
           ema_decay=0.9, accum_steps=2)
CALLS = 6  # three applied updates


def _tokenizer_cfgs():
    kw = dict(enc_desc=TOK_ENC, dec_desc=TOK_DEC, d_codebook=6, lfq_entropy_weight=0.1,
              lfq_bit_balance_weight=1.0, gan_loss_weight=0.0, perc_loss_weight=0.0,
              lfq_entropy_anneal_start=1, lfq_entropy_anneal_steps=3,
              lfq_bit_balance_anneal_start=2, lfq_bit_balance_anneal_steps=2,
              lfq_bit_balance_anneal_floor=0.3)
    return (jconfig.TokenizerModelConfig(optimizer=jconfig.OptimizerConfig(**OPT), **kw),
            tconfig.TokenizerModelConfig(optimizer=tconfig.OptimizerConfig(**OPT), **kw))


def _jax_run(module, params, batch_of, frozen, loss_kwargs, key, calls=CALLS):
    """JAX's optimizer and step over `calls` calls: per call the metrics,
    the JAX loss's key and (for the divergence pin) its gradients. The step
    donates its state, so it runs on a copy of `params`."""
    params = jax.tree.map(jnp.array, params)
    opt = jloop.make_optimizer(**jtrainer._opt_kwargs(OPT_J), frozen_mask=jlosses.frozen_param_mask(
        params, frozen))
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=opt.init(params), key=key)
    step = jloop.make_train_step(module, opt, loss_kwargs=loss_kwargs)
    grad = jax.jit(jax.grad(lambda p, batch, sub, kw: module.apply(
        {"params": p}, batch, sub, **kw)[0]))
    out = []
    for i in range(calls):
        _, sub, _ = jax.random.split(state.key, 3)
        kw = {k: v(state.step) if callable(v) else v for k, v in loss_kwargs.items()}
        grads = grad(state.params, batch_of(i), sub, kw)
        state, metrics = step(state, batch_of(i))
        out.append((_np_tree(metrics), sub, _np_tree(grads)))
    return state, out, opt


OPT_J = jconfig.OptimizerConfig(**OPT)


def _assert_trainable_norm(metrics, jmetrics, jgrads, frozen: str, call: int) -> bool:
    """The port's `grad_norm` is optax's `global_norm` over JAX's trainable
    gradients; JAX's own also counts the frozen ones. Returns whether the
    frozen gradients were non-zero."""
    leaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    trainable = [g for path, g in leaves if frozen not in jax.tree_util.keystr(path)]
    frozen_norm = float(optax.global_norm(
        [g for path, g in leaves if frozen in jax.tree_util.keystr(path)]))
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(optax.global_norm(trainable)),
                               rtol=1e-4, err_msg=f"call {call}")
    if frozen_norm > 1e-3:
        assert float(jmetrics["grad_norm"]) > float(optax.global_norm(trainable)) * (1 + 1e-6)
    return frozen_norm > 1e-3


def _assert_tree(module, jtree, tensors, prefix=""):
    ref, _ = state_dict_from_flax(_np_tree(jtree), module)
    for name, ref_v in ref.items():
        np.testing.assert_allclose(tensors[prefix + name].detach().numpy(), ref_v.numpy(),
                                   **TOL, err_msg=name)


def test_tokenizer_steps_match_jax():
    """Six calls, three applied updates: cosine with warm-up, EMA 0.9,
    accumulation over 2 calls, the first encoder layer frozen, both LFQ
    anneals (entropy to 0, bit balance to its floor): every metric of every
    call, then the parameters and the EMA, against JAX. `grad_norm` is the
    norm over the trainable parameters (the clip's): JAX's logged norm also
    counts the frozen layer's non-zero gradient (ROADMAP known
    divergences)."""
    jm_cfg, tm_cfg = _tokenizer_cfgs()
    jm = jtrainer.build_tokenizer_module(jm_cfg)
    rng = np.random.default_rng(0)
    videos = rng.uniform(size=(CALLS, 2, 4, 16, 16, 3)).astype(np.float32)
    params = _np_tree(jax.jit(lambda k: jm.init(k, videos[0], k))(jax.random.PRNGKey(1))["params"])
    jstate, jout, _ = _jax_run(jm, params, lambda i: jnp.asarray(videos[i]),
                               ("model/enc_layers_0",),
                               jtrainer._entropy_anneal_kwargs(jm_cfg), jax.random.PRNGKey(2))

    tm = ttrainer.build_tokenizer_module(tm_cfg)
    assert load_flax_params(tm.model, _np_tree(params["model"])) == []
    assert set(params) == {"model"}  # no critic at weights 0
    opt = tloop.make_optimizer(tm, **ttrainer._opt_kwargs(tm_cfg.optimizer),
                               frozen_mask=frozen_param_mask(tm, ("model/enc_layers/0",)))
    frozen_before = {n: p.detach().clone() for n, p in tm.named_parameters()
                     if n.startswith("model.enc_layers.0.")}
    assert frozen_before
    state = tloop.TrainState(tm, opt, torch.Generator().manual_seed(0))
    step = tloop.make_train_step(state, loss_kwargs=ttrainer._entropy_anneal_kwargs(tm_cfg))
    frozen_seen = False
    for i, (jmetrics, _, jgrads) in enumerate(jout):
        metrics = step(torch.from_numpy(videos[i]))
        assert set(metrics) == set(jmetrics)
        for k, v in metrics.items():
            if k != "grad_norm":
                np.testing.assert_allclose(v.item(), float(jmetrics[k]), **TOL,
                                           err_msg=f"call {i}: {k}")
        frozen_seen |= _assert_trainable_norm(metrics, jmetrics, jgrads, "enc_layers_0", i)
    assert frozen_seen
    assert state.step == CALLS and opt.updates == CALLS // 2
    tensors = dict(tm.named_parameters())
    _assert_tree(tm.model, jstate.params["model"], tensors, "model.")
    _assert_tree(tm.model, jloop.get_ema_params(jstate.opt_state)["model"], state.ema, "model.")
    for name, p in tensors.items():
        if name.startswith("model.enc_layers.0."):
            assert torch.equal(p, frozen_before[name]), name


def _jax_mask(key, shape):
    """The Bernoulli mask `DynamicsModel.compute_loss` draws from `key`."""
    key_rate, key_mask = jax.random.split(key)
    rate = jax.random.uniform(key_rate, (), minval=0.5, maxval=1.0)
    return np.array(jax.random.bernoulli(key_mask, rate, shape))


DYN = dict(desc=(("space-time_attn", {"n_rep": 2, "n_embd": 32, "n_head": 2, "d_head": 16}),),
           tok_vocab=64, act_vocab=16, embed_dim=32)


def test_dynamics_steps_match_jax():
    """The same six calls on a compact `DynamicsTrainModule` (the second
    layer's attention frozen), JAX's Bernoulli mask of each call fed to the
    port: metrics, parameters and EMA."""
    jm = jlosses.DynamicsTrainModule(dynamics=DYN)
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, 64, (2, 3, 4, 4)).astype(np.int32),
                "actions": rng.integers(0, 16, (2, 3)).astype(np.int32)} for _ in range(CALLS)]
    params = _np_tree(jm.init(jax.random.PRNGKey(4), batches[0], jax.random.PRNGKey(5))["params"])
    jstate, jout, _ = _jax_run(jm, params, lambda i: batches[i], ("model/layers_1",), {},
                               jax.random.PRNGKey(6))

    tm = DynamicsTrainModule(DYN)
    load_flax_params(tm.model, _np_tree(params["model"]))
    opt = tloop.make_optimizer(tm, **ttrainer._opt_kwargs(tconfig.OptimizerConfig(**OPT)),
                               frozen_mask=frozen_param_mask(tm, ("model/layers/1",)))
    step = tloop.make_train_step(tloop.TrainState(tm, opt))
    frozen_seen = False
    for i, (jmetrics, sub, jgrads) in enumerate(jout):
        batch = {k: torch.from_numpy(v) for k, v in batches[i].items()}
        metrics = step(batch, mask=torch.from_numpy(_jax_mask(sub, batches[i]["tokens"].shape)))
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            if k != "grad_norm":
                np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), **TOL,
                                           err_msg=f"call {i}: {k}")
        frozen_seen |= _assert_trainable_norm(metrics, jmetrics, jgrads, "layers_1", i)
    assert frozen_seen
    tensors = dict(tm.named_parameters())
    _assert_tree(tm.model, jstate.params["model"], tensors, "model.")
    _assert_tree(tm.model, jloop.get_ema_params(jstate.opt_state)["model"], opt.ema, "model.")


# --------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------- #

def test_synthetic_video_items_match_jax():
    for split_seed in (0, 1):
        ref = jvideo.SyntheticVideo(num_videos=3, num_frames=5, height=16, width=24,
                                    seed=split_seed)
        got = tvideo.SyntheticVideo(num_videos=3, num_frames=5, height=16, width=24,
                                    seed=split_seed)
        for i in range(3):
            np.testing.assert_array_equal(got[i], ref[i])


@pytest.mark.parametrize("seed", [0, 31415])
def test_batch_loader_order_matches_jax(seed):
    """Two epochs of shuffled batches (`default_rng(seed + epoch)`), then a
    loader positioned by `seek` continues an uninterrupted run's order."""
    ds = tvideo.SyntheticVideo(num_videos=7, num_frames=2, height=8, width=8)
    ref = jloader.BatchLoader(jvideo.SyntheticVideo(num_videos=7, num_frames=2, height=8,
                                                    width=8), batch_size=2, seed=seed)
    got = tloader.BatchLoader(ds, batch_size=2, seed=seed, num_workers=3)
    assert len(got) == len(ref) == 3
    flat = []
    for _ in range(2):
        for r, g in zip(ref, got, strict=True):
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            flat.append(g)
    for start in (1, 3, 4):
        loader = tloader.BatchLoader(ds, batch_size=2, seed=seed)
        loader.seek(start)
        resumed = [b for _ in range(2) for b in loader][: len(flat) - start]
        for a, b in zip(resumed, flat[start:], strict=True):
            assert torch.equal(a, b)


def test_token_batches_and_errors(tmp_path):
    """Dict batches of token shards the JAX package reads back the same;
    a worker's exception reaches the consumer."""
    rng = np.random.default_rng(0)
    for i in range(5):
        ttokens.write_token_shard(str(tmp_path / "train" / f"{i:06d}.npz"),
                                  rng.integers(0, 9, (3, 2, 2)), rng.integers(0, 4, (3,)))
    ref = jloader.BatchLoader(jtokens.TokenClipDataset(str(tmp_path)), batch_size=2, seed=1)
    got = tloader.BatchLoader(ttokens.TokenClipDataset(str(tmp_path)), batch_size=2, seed=1)
    for r, g in zip(ref, got, strict=True):
        assert set(g) == {"tokens", "actions"} and g["tokens"].dtype == torch.int32
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
    with pytest.raises(FileNotFoundError):
        ttokens.TokenClipDataset(str(tmp_path), split="val")

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError(f"cannot decode item {i}")

    with pytest.raises(RuntimeError, match="cannot decode"):
        list(tloader.BatchLoader(Broken(), batch_size=2))
    shard = tloader.DatasetShard(list(range(7)), 1, 3)
    assert len(shard) == 2 and [shard[i] for i in range(2)] == [1, 4]


def test_device_prefetch_passes_cpu_batches_through():
    batches = [torch.zeros(2), {"a": torch.ones(1)}]
    assert list(tloader.device_prefetch(iter(batches), "cpu")) == batches


# --------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------- #

def _dyn_state(seed=0):
    tm = init_weights(DynamicsTrainModule(DYN), torch.Generator().manual_seed(seed))
    opt = tloop.make_optimizer(tm, **ttrainer._opt_kwargs(tconfig.OptimizerConfig(**OPT)),
                               frozen_mask=frozen_param_mask(tm, ("model/layers/1",)))
    return tloop.TrainState(tm, opt, torch.Generator().manual_seed(7))


def _dyn_batches(n):
    rng = np.random.default_rng(8)
    return [{"tokens": torch.from_numpy(rng.integers(0, 64, (2, 3, 4, 4))),
             "actions": torch.from_numpy(rng.integers(0, 16, (2, 3)))} for _ in range(n)]


def test_resume_mid_accumulation_equals_uninterrupted(tmp_path):
    """Three calls (one update and half an accumulation), a checkpoint, a
    fresh state of other weights restored from it, two more calls: every
    parameter, EMA value, Adam moment, accumulation buffer, generator state
    and the step equal the uninterrupted run's exactly."""
    batches = _dyn_batches(5)
    ref = _dyn_state()
    step = tloop.make_train_step(ref)
    for b in batches:
        step(b)

    first = _dyn_state()
    step = tloop.make_train_step(first)
    for b in batches[:3]:
        step(b)
    assert first.optimizer.mini_step == 1
    tloop.save_checkpoint(str(tmp_path), first)
    resumed = _dyn_state(seed=1)
    assert not all(torch.equal(a, b) for a, b in zip(resumed.module.parameters(),
                                                     first.module.parameters()))
    _, at = tloop.restore_checkpoint(str(tmp_path), resumed)
    assert at == 3 and resumed.step == 3 and resumed.optimizer.mini_step == 1
    step = tloop.make_train_step(resumed)
    for b in batches[3:]:
        step(b)
    assert resumed.step == ref.step == 5
    for (n, a), b in zip(ref.module.named_parameters(), resumed.module.parameters()):
        assert torch.equal(a, b), n
    for n in ref.ema:
        assert torch.equal(ref.ema[n], resumed.ema[n]), n
    for a, b in zip(ref.accum, resumed.accum):
        assert torch.equal(a, b)
    sa, sb = ref.optimizer.adamw.state_dict(), resumed.optimizer.adamw.state_dict()
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert torch.equal(ref.generator.get_state(), resumed.generator.get_state())
    module, at = tloop.restore_params(str(tmp_path), DynamicsTrainModule(DYN))
    assert at == 3
    for a, b in zip(module.parameters(), first.module.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_writer_keeps_replaces_and_purges(tmp_path):
    state = _dyn_state()
    writer = tloop.CheckpointWriter(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        assert writer.save(state, s) >= 0
    assert tloop.all_steps(str(tmp_path)) == [2, 3]
    with torch.no_grad():
        for p in state.module.parameters():
            p.add_(1.0)
    writer.save(state, 3)  # replaces step 3 with the new weights
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]  # no temporary left
    module, at = tloop.restore_params(str(tmp_path), DynamicsTrainModule(DYN))
    assert at == 3
    for a, b in zip(module.parameters(), state.module.parameters()):
        assert torch.equal(a, b)
    assert writer.purge() == 2 and tloop.all_steps(str(tmp_path)) == []
    writer.close()
    fresh = _dyn_state(seed=2)
    assert tloop.restore_checkpoint(str(tmp_path), fresh) == (fresh, 0)
    assert tloop.restore_params(str(tmp_path / "none"), fresh.module) == (fresh.module, 0)
