"""The staged-training objectives of the PyTorch port against JAX on the CPU.

Stage 1: `TokenizerTrainModule` of `configs/tokenize.yaml`
(`tokenize_yaml_config()`, pinned to JAX's `load_config`) at 1/8 of its
widths, whose encoder enters the 10-bit codebook through the LFQ's
projection: loss, every metric and every gradient against `jax.grad`, with
JAX's frame indices fed to the port. Stage 2: `LatentAction.sample`, the
`mask` of `encode`/`forward`, and `ActionTrainModule` (the compact latent
action of `tools/parity_check.py::GENIE_CFG`): loss, metrics, gradients and
one `make_train_step` step against optax. Stage 3: `DynamicsTrainModule`
(`dynamics_yaml_config()`, pinned to `configs/dynamics.yaml`) on token
batches with JAX's Bernoulli mask, the same checks, at compact width here
and at the YAML's full width under `slow`. Weights come from JAX through
`bridge.py`. Tolerances: ids exact; losses within 1e-5 relative; gradients
within atol 2e-3 / rtol 2e-2 (`tools/parity_check.py`); an update of size
lr where JAX's gradient is clearly away from zero within atol 1e-6.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.action import LatentAction as JLatentAction  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu.train.config import load_config  # noqa: E402
from open_genie_tpu.train.loop import make_optimizer as jmake_optimizer  # noqa: E402
from open_genie_tpu.utils import random_frame_idxs as jrandom_frame_idxs  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.action import LatentAction  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    dynamics_yaml_config,
    tokenize_yaml_config,
)
from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402
from open_genie_tpu_torch.train.losses import (  # noqa: E402
    ActionTrainModule,
    DynamicsTrainModule,
    TokenizerTrainModule,
)
from test_torch_quantization import tokenize_yaml_eighth  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402

torch.set_num_threads(1)
GRAD_TOL = dict(atol=2e-3, rtol=2e-2)
LR = 1e-4
B, T = 2, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _norm(x):
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def test_tokenize_yaml_config_is_the_yaml_model():
    """The `TokenizerTrainModule` kwargs that the JAX trainer builds from
    `configs/tokenize.yaml` (`trainer.build_tokenizer_module`)."""
    m = load_config("configs/tokenize.yaml", "tokenizer").model
    ref = dict(
        tokenizer=m.tokenizer_kwargs(), disc_kwargs=m.disc_kwargs,
        perceptual_model=m.perceptual_model, perc_feat_layers=tuple(m.perc_feat_layers),
        gan_discriminate=m.gan_discriminate, gan_frames_per_batch=m.gan_frames_per_batch,
        gan_loss_weight=m.gan_loss_weight, perc_loss_weight=m.perc_loss_weight,
        quant_loss_weight=m.quant_loss_weight,
    )
    assert _norm(tokenize_yaml_config()) == _norm(ref)
    tok = tokenize_yaml_config()["tokenizer"]
    assert (tok["d_codebook"], tok["lfq_commit_weight"], tok["lfq_entropy_weight"],
            tok["lfq_diversity_weight"]) == (10, 0.25, 0.01, 1.0)


def test_dynamics_yaml_config_is_the_yaml_model():
    """The `DynamicsTrainModule` kwargs of `configs/dynamics.yaml`
    (`DynamicsModelConfig.dynamics_kwargs()`): 6 x 512, 8 x 64 heads,
    vocabularies 1024 and 256."""
    m = load_config("configs/dynamics.yaml", "dynamics").model
    assert _norm(dynamics_yaml_config()) == _norm({"dynamics": m.dynamics_kwargs()})
    dyn = dynamics_yaml_config()["dynamics"]
    assert (dyn["embed_dim"], dyn["tok_vocab"], dyn["act_vocab"]) == (512, 1024, 256)


# --------------------------------------------------------------------- #
# Stage 1: the tokenize.yaml tokenizer's full training loss
# --------------------------------------------------------------------- #

def test_tokenize_yaml_train_module_matches_jax():
    """`tokenize_yaml_config()` at 1/8 width (two space-time blocks a
    stack), whose LFQ projections train (K2 is not on this path).

    The full objective's loss and every metric; every gradient of the
    objective without the generator's GAN term (`gan_branch="dis"`: the
    reconstruction, perceptual, LFQ and discriminator losses); and the
    generator term's gradient in its two factors: the discriminator's
    gradient with respect to its input frames, then a gradient on the
    reconstruction (JAX's generator gradient) pulled back through the
    tokenizer. Together they make the gradient of the training objective.
    The generator term is not compared end to end in f32: the frame
    discriminator at 1/8 width amplifies rounding by about 1e7 in its input
    gradient (its leaky ReLUs see pre-activations of a few 1e-8 on this
    reconstruction, and JAX's own jit and eager gradients differ by 0.5%),
    so its input gradient is compared in float64 (`jax.enable_x64`), on
    frames drawn at random, within atol 1e-7."""
    cfg = tokenize_yaml_eighth(n_rep=2)
    video = np.random.default_rng(16).uniform(size=(B, T, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jm = jlosses.TokenizerTrainModule(**cfg)
    params = jax.jit(lambda k, v: jm.init(k, v, k))(jax.random.PRNGKey(1), video)["params"]
    k_perc, k_gan = jax.random.split(key)
    k = min(cfg["gan_frames_per_batch"], T)
    idxs = {name: torch.from_numpy(np.array(jrandom_frame_idxs(kk, B, T, k)))
            for name, kk in (("perc_idxs", k_perc), ("gan_idxs", k_gan))}
    tm = TokenizerTrainModule(**cfg)
    assert load_flax_params(tm, _np_tree(params)) == []
    assert tm.model.quant.project and not tm.model.head_fusable()

    ref, ref_metrics = jax.jit(lambda p, v: jm.apply({"params": p}, v, key))(params, video)
    with torch.no_grad():
        loss, metrics = tm(torch.from_numpy(video), **idxs)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert set(metrics) == set(ref_metrics) and "lfq_avg_entropy" in metrics
    for name, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(ref_metrics[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)

    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p, v: jm.apply({"params": p}, v, key, gan_branch="dis"), has_aux=True))(
        params, video)
    loss, _ = tm(torch.from_numpy(video), gan_branch="dis", **idxs)
    loss.backward()
    ref_grads, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    for name in ("model.quant.proj_inp.weight", "model.quant.proj_out.weight"):
        assert dict(tm.named_parameters())[name].grad.abs().sum() > 0

    def jrec(p):
        return jm.apply({"params": p}, video, method=lambda m, v: m.model(v, train=True)[0])

    def jgen(p, r, v):
        return jm.apply({"params": p}, r, v, k_gan,
                        method=lambda m, r, v, kk: m.gan_crit(r, v, kk, train_gen=True))

    frames = np.random.default_rng(21).uniform(size=video.shape)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        want = np.asarray(jax.grad(jgen, argnums=1)(p64, jnp.asarray(frames),
                                                    jnp.asarray(video, jnp.float64)))
    gan64 = copy.deepcopy(tm.gan_crit).double()
    rt = torch.from_numpy(frames).requires_grad_()
    gan64(rt, torch.from_numpy(video).double(), idxs["gan_idxs"], train_gen=True).backward()
    np.testing.assert_allclose(rt.grad.numpy(), want, atol=1e-7, rtol=0)
    rec_j, pullback = jax.vjp(jrec, params)
    g_j = jax.grad(jgen, argnums=1)(params, rec_j, jnp.asarray(video))
    rec_t, _ = tm.model(torch.from_numpy(video), train=True)
    names = [n for n, _ in tm.model.named_parameters()]
    got = torch.autograd.grad(rec_t, list(tm.model.parameters()),
                              grad_outputs=torch.from_numpy(np.array(g_j)))
    ref_pull, _ = state_dict_from_flax(_np_tree(pullback(g_j)[0]), tm)
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), ref_pull[f"model.{name}"].numpy(), **GRAD_TOL,
                                   err_msg=name)


# --------------------------------------------------------------------- #
# Stage 2: the latent action
# --------------------------------------------------------------------- #

def _latent_actions(kw, video):
    jm, tm = JLatentAction(**kw), LatentAction(**kw)
    params = jax.jit(lambda k, v: jm.init(k, v, training=False))(
        jax.random.PRNGKey(2), video)["params"]
    assert load_flax_params(tm, _np_tree(params)) == []
    return jm, tm, params


def test_latent_action_sample_matches_jax():
    kw = GENIE_CFG["latent_action"]
    video = np.zeros((1, 2, 32, 32, 3), np.float32)
    jm, tm, params = _latent_actions(kw, video)
    idxs = np.arange(2 ** kw["d_codebook"], dtype=np.int32).reshape(4, -1)
    ref = jm.apply({"params": params}, idxs, method=JLatentAction.sample)
    got = tm.sample(torch.from_numpy(idxs))
    assert tuple(got.shape) == (*idxs.shape, kw["d_codebook"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("training", [False, True])
def test_latent_action_mask_matches_jax(training):
    """An attention mask reaches the encoder's spatial and temporal
    attention alike: on 2x2 frames and 4 frames both see 4 positions, so
    one (4, 4) mask serves both. Ids exact, loss and terms within 1e-5
    relative, and the mask changes the result."""
    kw = dict(GENIE_CFG["latent_action"], inp_shape=(2, 2))
    video = np.random.default_rng(17).uniform(size=(B, 4, 2, 2, 3)).astype(np.float32)
    jm, tm, params = _latent_actions(kw, video)
    mask = np.random.default_rng(18).uniform(size=(4, 4)) > 0.5
    np.fill_diagonal(mask, True)
    ref_idxs, ref_loss, ref_aux = jm.apply({"params": params}, video, mask=mask,
                                           training=training)
    tm.train(training)
    idxs, loss, aux = tm(torch.from_numpy(video), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ref_idxs))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for k, v in aux.items():
        v = v.detach() if torch.is_tensor(v) else v
        np.testing.assert_allclose(float(v), float(ref_aux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    _, unmasked, _ = tm(torch.from_numpy(video))
    assert abs(unmasked.item() - loss.item()) > 1e-6


@pytest.fixture(scope="module")
def action_pair():
    cfg = GENIE_CFG["latent_action"]
    jm = jlosses.ActionTrainModule(latent_action=cfg)
    video = np.random.default_rng(19).uniform(size=(B, T, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    params = jax.jit(lambda k, v: jm.init(k, v, k))(key, video)["params"]
    out = jax.jit(jax.value_and_grad(lambda p, v: jm.apply({"params": p}, v, key),
                                     has_aux=True))(params, video)
    tm = ActionTrainModule(cfg)
    assert load_flax_params(tm, _np_tree(params)) == []
    return params, video, out, tm


def _check_loss_and_grads(tm, loss, metrics, ref, ref_metrics, jgrads):
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        v = v.detach() if torch.is_tensor(v) else v
        np.testing.assert_allclose(float(v), float(ref_metrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ref_grads, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


def _check_step(tm, params, jgrads, run_step):
    """One f32 `make_train_step` step against optax's update on JAX's
    gradients."""
    jopt = jmake_optimizer(lr=LR, weight_decay=0.01, grad_clip=1.0)
    updates, _ = jopt.update(jgrads, jopt.init(params), params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm, lr=LR, weight_decay=0.01, grad_clip=1.0)
    metrics = run_step(make_train_step(tm, opt))
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    ref_upd, _ = state_dict_from_flax(_np_tree(updates), tm)
    ref_g, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        upd = (p.detach() - before[name]).numpy()
        clear = np.abs(ref_g[name].numpy()) > 1e-4
        np.testing.assert_allclose(upd[clear], ref_upd[name].numpy()[clear], atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(upd, ref_upd[name].numpy(), atol=2.1 * LR, err_msg=name)


def test_action_train_module_matches_jax(action_pair):
    """Reconstruction MSE plus the LFQ loss: loss, the `act_*` metrics and
    every gradient."""
    _, video, ((ref, ref_metrics), jgrads), tm = action_pair
    tm.train()
    tm.zero_grad()
    loss, metrics = tm(torch.from_numpy(video))
    loss.backward()
    assert {"loss", "act_rec_loss", "act_q_loss", "act_lfq_avg_entropy"} <= set(metrics)
    _check_loss_and_grads(tm, loss, metrics, ref, ref_metrics, jgrads)


def test_action_train_step_matches_optax(action_pair):
    params, video, (_, jgrads), _ = action_pair
    tm = ActionTrainModule(GENIE_CFG["latent_action"]).train()
    load_flax_params(tm, _np_tree(params))
    _check_step(tm, params, jgrads, lambda step: step(torch.from_numpy(video)))


# --------------------------------------------------------------------- #
# Stage 3: dynamics on token batches
# --------------------------------------------------------------------- #

def _jax_mask(key, shape):
    """The Bernoulli mask `DynamicsModel.compute_loss` draws from `key`."""
    k_rate, k_mask = jax.random.split(key)
    rate = jax.random.uniform(k_rate, (), minval=0.5, maxval=1.0)
    return np.array(jax.random.bernoulli(k_mask, rate, shape))


def _dynamics_pair(cfg, shape, seed):
    dyn = cfg["dynamics"]
    jm = jlosses.DynamicsTrainModule(dynamics=dyn)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, dyn["tok_vocab"], shape).astype(np.int32),
             "actions": rng.integers(0, dyn["act_vocab"], shape[:2]).astype(np.int32)}
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda k, b: jm.init(k, b, k))(jax.random.PRNGKey(4), batch)["params"]
    out = jax.jit(jax.value_and_grad(lambda p, b: jm.apply({"params": p}, b, key),
                                     has_aux=True))(params, batch)
    tm = DynamicsTrainModule(**cfg)
    assert load_flax_params(tm, _np_tree(params)) == []
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return params, tbatch, torch.from_numpy(_jax_mask(key, shape)), out, tm


def _compact_dynamics_config():
    dyn = dict(GENIE_CFG["dynamics"], tok_vocab=2 ** 8, act_vocab=2 ** 4)
    return {"dynamics": dyn}


DYN_CASES = {
    "compact": (_compact_dynamics_config, (B, 4, 4, 4)),
    "full_width": (dynamics_yaml_config, (1, 3, 4, 4)),
}


@pytest.mark.parametrize("case", [
    "compact", pytest.param("full_width", marks=pytest.mark.slow)])
def test_dynamics_train_module_matches_jax(case):
    """Masked-token cross-entropy on `{"tokens", "actions"}` with JAX's
    mask: `loss` = `dyn_loss`, `dyn_masked_frac`, `dyn_masked_acc`, every
    gradient, then one f32 train step against optax."""
    make_cfg, shape = DYN_CASES[case]
    params, batch, mask, ((ref, ref_metrics), jgrads), tm = _dynamics_pair(make_cfg(), shape, 5)
    loss, metrics = tm(batch, mask=mask)
    loss.backward()
    assert set(metrics) == {"loss", "dyn_loss", "dyn_masked_frac", "dyn_masked_acc"}
    assert metrics["dyn_loss"] is metrics["loss"]
    _check_loss_and_grads(tm, loss, metrics, ref, ref_metrics, jgrads)
    tm = DynamicsTrainModule(**make_cfg())
    load_flax_params(tm, _np_tree(params))
    _check_step(tm, params, jgrads, lambda step: step(batch, mask=mask))


def test_dynamics_train_module_draws_its_mask():
    """Without a mask the module draws one from its generator: a rate in
    [0.5, 1), the same draw for the same seed."""
    tm = DynamicsTrainModule(**_compact_dynamics_config())
    batch = {"tokens": torch.randint(0, 256, (B, 4, 4, 4)), "actions": torch.zeros(B, 4).long()}
    runs = [tm(batch, generator=torch.Generator().manual_seed(0))[1] for _ in range(2)]
    assert 0.4 < runs[0]["dyn_masked_frac"].item() <= 1.0
    assert runs[0]["loss"].item() == runs[1]["loss"].item()
    with pytest.raises(ValueError):
        tm(batch)


@pytest.mark.slow
def test_tokenize_yaml_full_width_round_trip_matches_jax():
    """The tokenize.yaml tokenizer at its own widths: tokenize -> decode on
    a (1, 2, 64, 64, 3) clip against JAX."""
    from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer
    from open_genie_tpu_torch.models.tokenizer import VideoTokenizer

    kw = tokenize_yaml_config()["tokenizer"]
    video = np.random.default_rng(20).uniform(size=(1, 2, 64, 64, 3)).astype(np.float32)
    jm, tm = JTokenizer(**kw), VideoTokenizer(**kw).eval()
    params = jax.jit(lambda k: jm.init(k, video))(jax.random.PRNGKey(0))["params"]
    load_flax_params(tm, _np_tree(params))
    ref_q, ref_idxs = jax.jit(lambda p: jm.apply({"params": p}, video,
                                                 method=JTokenizer.tokenize))(params)
    quant, idxs = tm.tokenize(torch.from_numpy(video))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ref_idxs))
    ref_rec = jax.jit(lambda p: jm.apply({"params": p}, ref_idxs,
                                         method=JTokenizer.decode_tokens))(params)
    np.testing.assert_allclose(tm.decode_tokens(idxs).numpy(), np.asarray(ref_rec), **GRAD_TOL)
