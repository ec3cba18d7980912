"""Generation and the staged-training data path of the PyTorch port against
the JAX package on the CPU.

`DynamicsModel.generate` (KV-cached, and the uncached re-forward for trunks
that are not all `space-time_attn`, keeping the zero "mock" action of the
appended frame), `Genie.rollout_tokens_full`, `Genie.tokenize_with_actions`,
`Genie.compute_loss(return_act_idxs=True)`, `Genie.init_full` and
`GenieTrainModule.full_init`/`generate`, on the compact model
(`tools/parity_check.py::GENIE_CFG`) with JAX's weights through
`bridge.py`. JAX's Gumbel noise and Bernoulli masks are fed to the port
(`tests/test_torch_genie.py::_gumbel`/`_rollout_gumbel`). Token ids exact;
losses within 1e-5 relative; pixels within atol 2e-3 / rtol 2e-2
(`tools/parity_check.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.dynamics import DynamicsModel as JDynamics  # noqa: E402
from open_genie_tpu.models.genie import Genie as JGenie  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.dynamics import DynamicsModel  # noqa: E402
from open_genie_tpu_torch.models.genie import Genie  # noqa: E402
from open_genie_tpu_torch.train.losses import GenieTrainModule  # noqa: E402
from test_torch_genie import _gumbel, _rollout_gumbel  # noqa: E402
from tools.parity_check import GENIE_CFG  # noqa: E402

torch.set_num_threads(1)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)
B, S = 2, 4  # batch, MaskGIT steps
HW, V = 16, 2 ** GENIE_CFG["tokenizer"]["d_codebook"]  # 4x4 token grids
A = 2 ** GENIE_CFG["latent_action"]["d_codebook"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def genies():
    jm = JGenie(**GENIE_CFG)
    params = jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 4, 32, 32, 3)), k, method=jm.init_full)
    )(jax.random.PRNGKey(0))["params"]
    tm = Genie(**GENIE_CFG).eval()
    assert load_flax_params(tm, _np_tree(params)) == []
    return jm, params, tm


def _step_gumbel(key, steps):
    """The noise `generate` draws: one key per step."""
    return np.stack([_gumbel(k, (B, HW, V)) for k in jax.random.split(key, steps)])


def _history(seed, t=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, t, 4, 4)).astype(np.int32),
            rng.integers(0, A, (B, t)).astype(np.int32))


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached", "uncached"])
def test_generate_matches_jax(genies, use_cache):
    """`DynamicsModel.generate` appends one frame: exact tokens with JAX's
    noise, through the KV caches or by re-forwarding the clip each step."""
    jm, params, tm = genies
    toks, acts = _history(1)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda p: jm.apply(
        {"params": p}, toks, acts, key, S, use_cache=use_cache,
        method=lambda m, *a, **k: m.dynamics_.generate(*a, **k)))(params)
    out = tm.dynamics.generate(torch.from_numpy(toks), torch.from_numpy(acts), S,
                               use_cache=use_cache,
                               gumbel=torch.from_numpy(_step_gumbel(key, S)))
    assert tuple(out.shape) == (B, 4, 4, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out[:, :3].numpy(), toks)


def test_generate_falls_back_on_a_mixed_trunk():
    """A trunk with a layer other than `space-time_attn` has no decode
    caches: `supports_cached_decode` is false in both packages and
    `generate` re-forwards (exact tokens with JAX's noise)."""
    kw = dict(desc=(("space-time_attn", {"n_rep": 1, "n_embd": 32, "n_head": 2, "d_head": 16}),
                    ("gelu", {})),
              tok_vocab=64, act_vocab=A, embed_dim=32)
    jm, tm = JDynamics(**kw), DynamicsModel(**kw).eval()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 64, (B, 2, 4, 4)).astype(np.int32)
    acts = rng.integers(0, A, (B, 2)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(3), toks, acts)["params"]
    load_flax_params(tm, _np_tree(params))
    assert not jm.supports_cached_decode() and not tm.supports_cached_decode()
    assert DynamicsModel(**GENIE_CFG["dynamics"], tok_vocab=V, act_vocab=A
                         ).supports_cached_decode()
    key = jax.random.PRNGKey(4)
    ref = jm.apply({"params": params}, toks, acts, key, 3, method=JDynamics.generate)
    noise = np.stack([np.array(jax.random.gumbel(k, (B, HW, 64), jnp.bfloat16)
                               .astype(jnp.float32)) for k in jax.random.split(key, 3)])
    out = tm.generate(torch.from_numpy(toks), torch.from_numpy(acts), 3,
                      gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_rollout_tokens_full_matches_jax(genies):
    """`rollout_tokens_full` against JAX's with its noise: exact tokens; and
    the port's cached `rollout_tokens` gives the same tokens on that noise."""
    jm, params, tm = genies
    frames = 2
    toks, _ = _history(5, t=2)
    acts = np.random.default_rng(6).integers(0, A, (B, 2 + frames)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda p: jm.apply({"params": p}, toks, acts, key, frames, S,
                                     method=JGenie.rollout_tokens_full))(params)
    gumbel = torch.from_numpy(_rollout_gumbel(key, frames, S))
    args = (torch.from_numpy(toks), torch.from_numpy(acts), frames, S)
    out = tm.rollout_tokens_full(*args, gumbel=gumbel)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tm.rollout_tokens(*args, gumbel=gumbel).numpy(), out.numpy())


def test_tokenize_with_actions_matches_jax(genies):
    """Tokens and token-time-aligned action ids, eval mode whatever the
    module's mode (and the mode is left as it was)."""
    jm, params, tm = genies
    video = np.random.default_rng(8).uniform(size=(B, 4, 32, 32, 3)).astype(np.float32)
    ref_tok, ref_act = jax.jit(lambda p, v: jm.apply(
        {"params": p}, v, method=JGenie.tokenize_with_actions))(params, video)
    tm.train()
    try:
        tok, act = tm.tokenize_with_actions(torch.from_numpy(video))
        assert tm.latent_action.training
    finally:
        tm.eval()
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(act.numpy(), np.asarray(ref_act))
    assert tuple(act.shape) == tuple(tok.shape[:2])


def _jax_mask(key, shape):
    """The Bernoulli mask JAX's `DynamicsModel.compute_loss` draws from `key`."""
    k_rate, k_mask = jax.random.split(key)
    rate = jax.random.uniform(k_rate, (), minval=0.5, maxval=1.0)
    return np.asarray(jax.random.bernoulli(k_mask, rate, shape))


def test_compute_loss_act_idxs_and_init_full_match_jax(genies):
    """`compute_loss(return_act_idxs=True)` in eval and in training mode
    (the latent action's LFQ loss on), and `init_full`, the loss plus 0 x
    the reconstruction, with JAX's mask."""
    jm, params, tm = genies
    video = np.random.default_rng(9).uniform(size=(B, 4, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    tok_shape = (B, 4, 8, 8)  # 32x32 frames, 4x space downsampling
    mask = torch.from_numpy(np.array(_jax_mask(key, tok_shape)))
    for training in (False, True):
        ref, ref_aux = jax.jit(lambda p, v: jm.apply(
            {"params": p}, v, key, training=training, return_act_idxs=True,
            method=JGenie.compute_loss))(params, video)
        tm.train(training)
        loss, aux = tm.compute_loss(torch.from_numpy(video), mask=mask, return_act_idxs=True)
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
        assert set(aux) == set(ref_aux)
        np.testing.assert_array_equal(aux.pop("act_idxs").numpy(),
                                      np.asarray(ref_aux.pop("act_idxs")))
        for k, v in aux.items():
            v = v.detach() if torch.is_tensor(v) else v
            np.testing.assert_allclose(float(v), float(ref_aux[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    ref_init = jax.jit(lambda p, v: jm.apply({"params": p}, v, key, method=JGenie.init_full))(
        params, video)
    tmod = GenieTrainModule(GENIE_CFG)
    load_flax_params(tmod.model, _np_tree(params))
    for value in (tm.init_full(torch.from_numpy(video), mask=mask),
                  tmod.full_init(torch.from_numpy(video), mask=mask)):
        np.testing.assert_allclose(value.item(), float(ref_init), rtol=1e-5)
    value.backward()  # the joint loss's graph, the reconstruction's none
    assert tmod.model.tokenizer.dec_layers[0].conv3d.weight.grad is None
    tm.eval()


def test_genie_train_module_generate_matches_jax(genies):
    """`GenieTrainModule.generate` is the rollout: exact against JAX's."""
    _, params, _ = genies
    jmod = jlosses.GenieTrainModule(genie=GENIE_CFG)
    tmod = GenieTrainModule(GENIE_CFG).eval()
    load_flax_params(tmod.model, _np_tree(params))
    prompt = np.random.default_rng(12).uniform(size=(B, 1, 16, 16, 3)).astype(np.float32)
    actions = np.array([[1, 5, 9], [15, 0, 3]], np.int32)
    key = jax.random.PRNGKey(13)
    ref = jax.jit(lambda p: jmod.apply({"params": {"model": p}}, prompt, actions, key,
                                       num_frames=2, steps_per_frame=S,
                                       method=jlosses.GenieTrainModule.generate))(params)
    pix = tmod.generate(torch.from_numpy(prompt), torch.from_numpy(actions), 2, S,
                        gumbel=torch.from_numpy(_rollout_gumbel(key, 2, S)))
    assert tuple(pix.shape) == (B, 3, 16, 16, 3)
    np.testing.assert_allclose(pix.numpy(), np.asarray(ref), **STACK_TOL)
