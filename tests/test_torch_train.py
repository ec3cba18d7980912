"""Genie joint training in the PyTorch port against JAX on the CPU.

The compact Genie (`tools/parity_check.py::GENIE_CFG` = the port's
`genie_compact_config()`), JAX weights through `bridge.py`, and the
dynamics' Bernoulli mask that JAX draws from its key fed to the port.
Tolerances: losses within 1e-5 relative; token and action ids exactly
(action ids wherever decided, |z| >= 1e-5); every gradient within atol
2e-3 / rtol 2e-2 (`tools/parity_check.py`); an optimizer step on the same
gradients within atol 1e-6 (the same f32 arithmetic in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.dynamics import DynamicsModel as JDynamics  # noqa: E402
from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.train.config import load_config  # noqa: E402
from open_genie_tpu.train.loop import make_optimizer as jmake_optimizer  # noqa: E402
from open_genie_tpu.train.losses import frozen_param_mask as jfrozen_mask  # noqa: E402
from open_genie_tpu.train.trainer import genie_model_kwargs  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import genie_compact_config, genie_train_config  # noqa: E402
from open_genie_tpu_torch.models.dynamics import DynamicsModel  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.train.losses import GenieTrainModule, frozen_param_mask  # noqa: E402
from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402

torch.set_num_threads(1)
GRAD_TOL = dict(atol=2e-3, rtol=2e-2)
LR = 1e-4
B, T, HW = 2, 4, 32  # the compact latent action's inp_shape is 32x32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mask(key, shape):
    """The Bernoulli mask `DynamicsModel.compute_loss` draws from `key`."""
    key_rate, key_mask = jax.random.split(key)
    rate = jax.random.uniform(key_rate, (), minval=0.5, maxval=1.0)
    return np.array(jax.random.bernoulli(key_mask, rate, shape))


@pytest.fixture(scope="module")
def genies():
    jm = JGenie(**GENIE_CFG)
    video = np.random.default_rng(0).uniform(size=(B, T, HW, HW, 3)).astype(np.float32)
    params = jax.jit(lambda k: jm.init(k, video, k, method=jm.init_full))(
        jax.random.PRNGKey(1))["params"]
    return jm, params, video


def _port_genie(params):
    tm = Genie(**genie_compact_config())
    assert load_flax_params(tm, _np_tree(params)) == []
    return tm


def test_genie_train_config_is_the_yaml_model():
    def norm(x):
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        return x

    ref = genie_model_kwargs(load_config("configs/genie.yaml", "genie").model)
    assert norm(genie_train_config()) == norm(ref)
    assert genie_compact_config() == GENIE_CFG


def test_bridge_loads_latent_action(genies):
    _, params, _ = genies
    tm = _port_genie(params)
    la = params["latent_action_"]
    np.testing.assert_array_equal(tm.latent_action.to_act.weight.detach().numpy(),
                                  np.asarray(la["to_act"]["kernel"]).T)
    cross = la["dec_layers_0"]["temp_attn"]["attn"]
    tcross = tm.latent_action.dec_layers[0].temp_attn.attn
    for name in ("to_q", "to_k", "to_v"):
        np.testing.assert_array_equal(getattr(tcross, name).weight.detach().numpy(),
                                      np.asarray(cross[name]["kernel"]).T)


def test_dynamics_compute_loss_matches_jax():
    desc = (("space-time_attn", {"n_rep": 2, "n_embd": 32, "n_head": 2, "d_head": 16}),)
    jm = JDynamics(desc=desc, tok_vocab=64, act_vocab=16, embed_dim=32)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 64, (B, 3, 4, 4)).astype(np.int32)
    acts = rng.integers(0, 16, (B, 3)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    params = jm.init(key, toks, acts)["params"]

    def jloss(p):
        return jm.apply({"params": p}, toks, acts, key, method=jm.compute_loss)

    (ref, ref_aux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = DynamicsModel(desc, 64, 16, 32)
    load_flax_params(tm, _np_tree(params))
    mask = torch.from_numpy(_jax_mask(key, toks.shape))
    loss, aux = tm.compute_loss(torch.from_numpy(toks), torch.from_numpy(acts), mask=mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for k in ("masked_frac", "masked_acc"):
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-6)
    ref_grads, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    g = torch.Generator().manual_seed(0)
    drawn, _ = tm.compute_loss(torch.from_numpy(toks), torch.from_numpy(acts), generator=g)
    assert torch.isfinite(drawn)
    with pytest.raises(ValueError, match="Generator or a mask"):
        tm.compute_loss(torch.from_numpy(toks), torch.from_numpy(acts))


def _jax_loss_and_grads(jm, params, video, key):
    def loss(p):
        return jm.apply({"params": p}, video, key, training=True, return_act_idxs=True,
                        method=jm.compute_loss)

    return jax.value_and_grad(loss, has_aux=True)(params)


def test_genie_compute_loss_matches_jax(genies):
    """Loss, every aux term, token and action ids, and every gradient."""
    jm, params, video = genies
    key = jax.random.PRNGKey(4)
    (ref, ref_aux), jgrads = _jax_loss_and_grads(jm, params, video, key)
    ref_tok = jax.jit(lambda p, v: jm.apply({"params": p}, v, method=jm.tokenize_prompt))(
        params, video)

    tm = _port_genie(params)
    vt = torch.from_numpy(video)
    _, tok = tm.tokenizer.tokenize_frozen(vt)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    mask = torch.from_numpy(_jax_mask(key, tuple(tok.shape)))
    loss, aux = tm.compute_loss(vt, mask=mask)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    ref_aux = dict(ref_aux)
    ref_idxs = np.asarray(ref_aux.pop("act_idxs"))
    assert set(aux) == set(ref_aux)
    for k, v in aux.items():
        np.testing.assert_allclose(float(torch.as_tensor(v).detach()), float(ref_aux[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    la = tm.latent_action
    with torch.no_grad():
        (_, idxs, enc), _, _ = la.encode(vt)
        z = la.to_act(enc.reshape(B, T, -1))
    decided = (z.abs() >= 1e-5).all(-1)
    assert decided.float().mean() > 0.9
    np.testing.assert_array_equal(idxs[decided].numpy(), ref_idxs[decided.numpy()])

    ref_grads, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        if name.startswith("tokenizer."):
            assert p.grad is None, name  # frozen: it ran without a graph
            assert not ref_grads[name].any(), name  # JAX's stop_gradient zeros
            continue
        assert p.grad is not None and p.grad.abs().sum() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # below and above the clip
def test_optimizer_steps_match_optax(genies, grad_scale):
    """Two AdamW steps with global-norm clipping and the frozen tokenizer,
    on the same random gradients, against optax's `make_optimizer`."""
    _, params, _ = genies
    tm = _port_genie(params)
    jopt = jmake_optimizer(lr=LR, weight_decay=0.01, grad_clip=1.0,
                           frozen_mask=jfrozen_mask(params, ("tokenizer_",)))
    opt = make_optimizer(tm, lr=LR, weight_decay=0.01, grad_clip=1.0,
                         frozen_mask=frozen_param_mask(tm, ("tokenizer",)))
    jparams, jstate = params, jopt.init(params)
    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * grad_scale).astype(np.float32), params)
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tgrads, _ = state_dict_from_flax(_np_tree(grads), tm)
        for name, p in tm.named_parameters():
            if p.requires_grad:
                p.grad = tgrads[name].clone()
        opt.step()
        opt.zero_grad()
    ref, _ = state_dict_from_flax(_np_tree(jparams), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        if name.startswith("tokenizer."):
            assert not p.requires_grad


def test_train_step_matches_jax(genies):
    """One f32 `make_train_step` step against `jax.grad` + optax on the
    same weights, video and mask: every update of size lr where JAX's
    gradient is clearly away from zero agrees; a bf16 step runs with f32
    gradients and leaves the tokenizer unchanged."""
    jm, params, video = genies
    key = jax.random.PRNGKey(6)
    (_, _), jgrads = _jax_loss_and_grads(jm, params, video, key)
    jopt = jmake_optimizer(lr=LR, weight_decay=0.01, grad_clip=1.0,
                           frozen_mask=jfrozen_mask(params, ("tokenizer_",)))
    updates, _ = jopt.update(jgrads, jopt.init(params), params)

    module = GenieTrainModule(genie_compact_config())
    load_flax_params(module.model, _np_tree(params))
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    opt = make_optimizer(module, lr=LR, frozen_mask=frozen_param_mask(module, ("model/tokenizer",)))
    _, tok = module.model.tokenizer.tokenize_frozen(torch.from_numpy(video))
    mask = torch.from_numpy(_jax_mask(key, tuple(tok.shape)))
    metrics = make_train_step(module, opt)(torch.from_numpy(video), mask=mask)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    ref_norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(jgrads))))
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref_norm, rtol=2e-2)

    ref_upd, _ = state_dict_from_flax(_np_tree(updates), module.model)
    ref_g, _ = state_dict_from_flax(_np_tree(jgrads), module.model)
    for name, p in module.named_parameters():
        key_ = name[len("model."):]
        upd = (p.detach() - before[name]).numpy()
        clear = np.abs(ref_g[key_].numpy()) > 1e-4
        np.testing.assert_allclose(upd[clear], ref_upd[key_].numpy()[clear], atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(upd, ref_upd[key_].numpy(), atol=2.1 * LR, err_msg=name)

    step = make_train_step(module, opt, compute_dtype=torch.bfloat16)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    metrics = step(torch.from_numpy(video), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"]) and metrics["loss"].dtype == torch.float32
    for name, p in module.named_parameters():
        assert p.dtype == torch.float32 and p.grad is None
        changed = not torch.equal(p.detach(), before[name])
        assert changed != name.startswith("model.tokenizer."), name
