"""The latent-action model's parts in the PyTorch port against JAX on the CPU.

Cross-attention, the transposed-conv upsample, the LFQ training loss and
the whole `LatentAction` (stock `LATENT_ACT_*` topology at n_embd 16),
forward and gradients. JAX weights go through `bridge.py`, and so do JAX's
parameter gradients (the layouts are linear), so every gradient is compared
under the port's parameter name. Tolerances: one op atol 1e-5 / rtol 1e-4;
stacks atol 2e-3 / rtol 2e-2 (`tools/parity_check.py`); losses within 1e-5
relative; action ids exactly wherever the code is decided (|z| >= 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.action import LatentAction as JLatentAction  # noqa: E402
from open_genie_tpu.models.blueprints import LATENT_ACT_DEC, LATENT_ACT_ENC  # noqa: E402
from open_genie_tpu.modules import attention as jatt  # noqa: E402
from open_genie_tpu.modules import blueprint_st_factor as jst_factor  # noqa: E402
from open_genie_tpu.modules import video as jvid  # noqa: E402
from open_genie_tpu.ops import lfq as jlfq  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.action import LatentAction  # noqa: E402
from open_genie_tpu_torch.modules import attention as tatt  # noqa: E402
from open_genie_tpu_torch.modules import blueprint_st_factor  # noqa: E402
from open_genie_tpu_torch.modules import video as tvid  # noqa: E402
from open_genie_tpu_torch.ops import lfq as tlfq  # noqa: E402

torch.set_num_threads(1)
OP_TOL = dict(atol=1e-5, rtol=1e-4)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)
KEY = jax.random.PRNGKey(0)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(jmod, tmod, inputs, tol, **call_kw):
    """Forward and gradients (of `sum(out * w)` with respect to every
    parameter and every float input) of a JAX module and its port."""
    params = jmod.init(KEY, *inputs, **call_kw)["params"]
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    ref = jmod.apply({"params": params}, *inputs, **call_kw)
    w = _rand(99, *ref.shape)

    def loss(p, *xs):
        return (jmod.apply({"params": p}, *xs, **call_kw) * w).sum()

    jgrads = jax.grad(loss, argnums=tuple(range(len(inputs) + 1)))(params, *inputs)
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = tmod(*xs, **{k: v for k, v in call_kw.items() if k != "train"})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    (out * torch.from_numpy(w)).sum().backward()
    ref_grads, _ = state_dict_from_flax(jax.tree.map(np.asarray, jgrads[0]), tmod)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **tol,
                                   err_msg=name)
    for x, g in zip(xs, jgrads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **tol)


def test_cross_attention():
    jmod = jatt.Attention(n_head=2, d_head=16, key_dim=8, causal=True)
    tmod = tatt.Attention(2, 16, 24, key_dim=8, causal=True)
    assert not hasattr(tmod, "to_qkv")
    _compare(jmod, tmod, [_rand(1, 3, 6, 24), _rand(2, 3, 6, 8)], STACK_TOL)


def test_temporal_and_spatial_cross_attention():
    video = _rand(3, 2, 4, 3, 3, 16)
    _compare(jatt.TemporalAttention(n_head=2, d_head=16, key_dim=8, causal=True),
             tatt.TemporalAttention(2, 16, 16, key_dim=8),
             [video, _rand(4, 2, 4, 8)], STACK_TOL)
    _compare(jatt.SpatialAttention(n_head=2, d_head=16, key_dim=8),
             tatt.SpatialAttention(2, 16, 16, key_dim=8),
             [video, _rand(5, 2, 9, 8)], STACK_TOL)


def test_space_time_attention_time_cond():
    """The latent-action decoder block: actions cross-attend in time only."""
    kw = dict(n_embd=16, n_head=2, d_head=16, time_attn_kw={"key_dim": 8})
    video, act = _rand(6, 2, 4, 4, 4, 16), _rand(7, 2, 4, 8)
    jmod, tmod = jatt.SpaceTimeAttention(**kw), tatt.SpaceTimeAttention(**kw)
    params = jmod.init(KEY, video, cond=(None, act))["params"]
    load_flax_params(tmod, jax.tree.map(np.asarray, params))

    def loss(p, v, a):
        return jnp.square(jmod.apply({"params": p}, v, cond=(None, a))).sum()

    ref, (gp, gv, ga) = jax.value_and_grad(loss, argnums=(0, 1, 2))(params, video, act)
    v, a = torch.from_numpy(video).requires_grad_(), torch.from_numpy(act).requires_grad_()
    out = tmod(v, (None, a)).square().sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    ref_grads, _ = state_dict_from_flax(jax.tree.map(np.asarray, gp), tmod)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **STACK_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(gv), **STACK_TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), **STACK_TOL)
    with pytest.raises(ValueError, match="key_dim=8"):
        tmod(v, (None, a[..., :4]))


@pytest.mark.parametrize("tf,sf", [(1, 2), (2, 2)])
def test_spacetime_upsample(tf, sf):
    kw = dict(in_channels=4, out_channels=6, time_factor=tf, space_factor=sf)
    jmod, tmod = jvid.SpaceTimeUpsample(**kw), tvid.SpaceTimeUpsample(**kw)
    _compare(jmod, tmod, [_rand(8, 2, 3, 4, 5, 4)], OP_TOL)
    assert tmod.st_factor == jmod.st_factor and tmod.t_factor == jmod.t_factor


def test_blueprint_st_factor():
    for bp in (LATENT_ACT_ENC, LATENT_ACT_DEC):
        assert blueprint_st_factor(bp) == jst_factor(bp)


def test_attention_dropout_follows_training_flag():
    """Dropout acts only in training, zeroing outputs and scaling the rest
    by 1 / (1 - rate); the noise itself need not match JAX's."""
    g = torch.Generator().manual_seed(0)
    attn = tatt.Attention(2, 16, 24, dropout=0.5)
    x = torch.randn(4, 8, 24, generator=g)
    attn.eval()
    ref = attn(x)
    attn.train()
    torch.manual_seed(1)
    out = attn(x)
    dropped = out == 0
    assert 0.3 < dropped.float().mean() < 0.7
    torch.testing.assert_close(out[~dropped], 2 * ref[~dropped])


@pytest.mark.parametrize("beta", [1.0, 100.0])
def test_lfq_loss_terms_and_grads(beta):
    x = _rand(9, 4, 16, 8) * 0.5
    kw = dict(beta=beta, commit_weight=0.25, entropy_weight=0.1, diversity_weight=1.0,
              frac_sample=0.5, bit_balance_weight=0.3)

    def jloss(x):
        quant = jnp.where(x > 0, 1.0, -1.0)
        return jlfq.lfq_loss(x, quant, **kw)

    (ref, ref_aux), ref_grad = jax.value_and_grad(jloss, has_aux=True)(x)
    xt = torch.from_numpy(x).requires_grad_()
    loss, aux = tlfq.lfq_loss(xt, torch.where(xt > 0, 1.0, -1.0), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert set(aux) == set(ref_aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), **OP_TOL)
    # Above 4096 codes the entropy streams over the codebook (K5/K6's plain
    # twins on the CPU), as the JAX package's chunked path does.
    big = _rand(4, 40, 13) * 0.5
    np.testing.assert_allclose(
        tlfq.lfq_avg_entropy(torch.from_numpy(big), beta).item(),
        float(jlfq.lfq_avg_entropy(jnp.asarray(big), beta)), rtol=1e-3)


def _small(bp):
    """The stock blueprint at width 16 (its heads and factors unchanged)."""
    out = []
    for name, kw in bp:
        kw = dict(kw)
        for key in ("n_embd", "in_channels"):
            if key in kw:
                kw[key] = 16
        out.append((name, kw))
    return tuple(out)


def test_latent_action_loss_and_grads():
    cfg = dict(enc_desc=_small(LATENT_ACT_ENC), dec_desc=_small(LATENT_ACT_DEC),
               d_codebook=8, n_embd=16, inp_shape=(16, 16))
    video = np.random.default_rng(10).uniform(size=(2, 4, 16, 16, 3)).astype(np.float32)
    jm = JLatentAction(**cfg)
    params = jm.init(KEY, video, training=True)["params"]
    tm = LatentAction(**cfg)
    load_flax_params(tm, jax.tree.map(np.asarray, params))

    def jloss(p):
        idxs, loss, aux = jm.apply({"params": p}, video, training=True)
        return loss, (idxs, aux)

    (ref, (ref_idxs, ref_aux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    idxs, loss, aux = tm(torch.from_numpy(video))
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert set(aux) == set(ref_aux)
    for k in aux:
        np.testing.assert_allclose(float(torch.as_tensor(aux[k]).detach()), float(ref_aux[k]),
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    with torch.no_grad():
        x = tm.proj_in(torch.from_numpy(video))
        for layer in tm.enc_layers:
            x = layer(x)
        z = tm.to_act(x.reshape(2, 4, -1))
    decided = (z.abs() >= 1e-5).all(-1)
    assert decided.float().mean() > 0.9
    np.testing.assert_array_equal(idxs[decided].numpy(), np.asarray(ref_idxs)[decided.numpy()])
    ref_grads, _ = state_dict_from_flax(jax.tree.map(np.asarray, jgrads), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **STACK_TOL,
                                   err_msg=name)
        assert p.grad.abs().sum() > 0, name


def test_init_weights_seeds_every_parameter():
    """Seeded random weights reach every parameter, the transposed conv of
    `spacetime_upsample` included: two inits from one seed agree whatever
    the global RNG did in between."""
    from open_genie_tpu_torch.utils import init_weights

    cfg = dict(enc_desc=_small(LATENT_ACT_ENC), dec_desc=_small(LATENT_ACT_DEC),
               d_codebook=8, n_embd=16, inp_shape=(16, 16))
    states = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        m = init_weights(LatentAction(**cfg), torch.Generator().manual_seed(0))
        states.append(m.state_dict())
    assert any("up.weight" in k for k in states[0])
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
