"""MAGVIT2 tokenizer training in the PyTorch port against JAX on the CPU.

Each module of the tokenizer's full-loss step against its JAX twin through
`bridge.py` (norms, residual blocks, spatial attention on images, the frame
discriminator, VGG16, the perceptual and GAN losses), then the compact
`TokenizerTrainModule` (`tokenizer_compact_train_config()`, whose 13-bit
codebook puts K5/K6's plain twins on its path): loss, every metric and
every gradient against `jax.grad`, and one `make_train_step` step against
optax. JAX's frame indices (`random_frame_idxs` of its keys) are fed to
the port. Tolerances: one module atol 1e-5 / rtol 1e-4; stacks atol 2e-3 /
rtol 2e-2 (`tools/parity_check.py`); losses within 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.models.blueprints import MAGVIT2_DEC_DESC, MAGVIT2_ENC_DESC  # noqa: E402
from open_genie_tpu.modules import attention as jatt  # noqa: E402
from open_genie_tpu.modules import discriminator as jdisc  # noqa: E402
from open_genie_tpu.modules import image as jimg  # noqa: E402
from open_genie_tpu.modules import loss as jloss_mod  # noqa: E402
from open_genie_tpu.modules import norm as jnorm  # noqa: E402
from open_genie_tpu.modules import vgg as jvgg  # noqa: E402
from open_genie_tpu.modules import video as jvid  # noqa: E402
from open_genie_tpu.ops.resample import space_to_depth as jspace_to_depth  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu.train.loop import make_optimizer as jmake_optimizer  # noqa: E402
from open_genie_tpu.utils import pick_frames as jpick_frames  # noqa: E402
from open_genie_tpu.utils import random_frame_idxs as jrandom_frame_idxs  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models import blueprints as tbp  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    tokenizer_compact_train_config,
    tokenizer_train_config,
)
from open_genie_tpu_torch.modules import attention as tatt  # noqa: E402
from open_genie_tpu_torch.modules import get_module, parse_blueprint  # noqa: E402
from open_genie_tpu_torch.modules.discriminator import FrameDiscriminator  # noqa: E402
from open_genie_tpu_torch.modules.image import ImageResidualBlock  # noqa: E402
from open_genie_tpu_torch.modules.loss import GANLoss, PerceptualLoss  # noqa: E402
from open_genie_tpu_torch.modules.misc import Activation  # noqa: E402
from open_genie_tpu_torch.modules.norm import AdaptiveGroupNorm, GroupNorm  # noqa: E402
from open_genie_tpu_torch.modules.vgg import VGG16Features  # noqa: E402
from open_genie_tpu_torch.modules.video import VideoResidualBlock  # noqa: E402
from open_genie_tpu_torch.ops.resample import space_to_depth  # noqa: E402
from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402
from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask  # noqa: E402
from open_genie_tpu_torch.utils import init_weights, pick_frames, random_frame_idxs  # noqa: E402

torch.set_num_threads(1)
OP_TOL = dict(atol=1e-5, rtol=1e-4)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)
KEY = jax.random.PRNGKey(0)
LR = 1e-4
B, T, HW = 2, 4, 32  # the compact config's video


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jiggle(params, seed):
    """Every parameter moved off its init (zero heads, unit scales) so
    that each one's layout shows in the output."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        p + 0.3 * rng.standard_normal(p.shape).astype(np.float32) for p in leaves])


def _compare(jmod, tmod, inputs, tol, call_kw=None, jiggle=False):
    """Forward and gradients (of `sum(out * w)` with respect to every
    parameter and every float input) of a JAX module and its port."""
    call_kw = dict(call_kw or {})
    params = jmod.init(KEY, *inputs, **call_kw)["params"]
    if jiggle:
        params = _jiggle(params, 7)
    load_flax_params(tmod, _np_tree(params))
    ref = jax.jit(lambda p, *xs: jmod.apply({"params": p}, *xs, **call_kw))(params, *inputs)
    w = _rand(99, *ref.shape)

    def loss(p, *xs):
        return (jmod.apply({"params": p}, *xs, **call_kw) * w).sum()

    jgrads = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs) + 1))))(params, *inputs)
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = tmod(*xs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    (out * torch.from_numpy(w)).sum().backward()
    ref_grads, _ = state_dict_from_flax(_np_tree(jgrads[0]), tmod)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **tol, err_msg=name)
    for x, g in zip(xs, jgrads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **tol)


@pytest.mark.parametrize("per_frame", [False, True])
def test_group_norm(per_frame):
    x = _rand(0, 2, 3, 4, 4, 16) * 2.0 + 0.5
    _compare(jnorm.GroupNorm(num_groups=4, num_channels=16, per_frame=per_frame),
             GroupNorm(4, 16, per_frame=per_frame), [x], OP_TOL, jiggle=True)


@pytest.mark.parametrize("per_frame,t_cond", [(False, 3), (True, 3), (True, 1)])
def test_adaptive_group_norm(per_frame, t_cond):
    """The condition pooled in f32 through both heads; per frame, a
    condition frame covers its `T_x / T_c` sub-frames."""
    x = _rand(1, 2, 3, 4, 4, 16) * 2.0
    cond = _rand(2, 2, t_cond, 2, 2, 6)
    _compare(jnorm.AdaptiveGroupNorm(dim_cond=6, num_groups=4, num_channels=16,
                                     per_frame=per_frame),
             AdaptiveGroupNorm(6, 4, 16, per_frame=per_frame), [x, cond], OP_TOL, jiggle=True)


def test_adaptive_group_norm_heads_keep_the_jax_init():
    """std: weight 0 / bias 1; avg: all 0, from the constructor and from
    `init_weights` alike (which draws nothing for them)."""
    jm = jnorm.AdaptiveGroupNorm(dim_cond=6, num_groups=4, num_channels=16)
    params = jm.init(KEY, _rand(3, 1, 2, 4, 4, 16), _rand(4, 1, 2, 2, 2, 6))["params"]
    for m in (AdaptiveGroupNorm(6, 4, 16),
              init_weights(AdaptiveGroupNorm(6, 4, 16), torch.Generator().manual_seed(0))):
        ref, _ = state_dict_from_flax(_np_tree(params), m)
        for name, p in m.state_dict().items():
            np.testing.assert_array_equal(p.numpy(), ref[name].numpy(), err_msg=name)


@pytest.mark.parametrize("kw", [
    {"in_channels": 8},
    {"in_channels": 8, "out_channels": 16, "num_groups": 4},
    {"in_channels": 8, "use_causal": True, "per_frame_norm": True},
])
def test_video_residual_block(kw):
    """Non-causal symmetric-padded convs (MAGVIT2's form), flax GroupNorm
    eps 1e-6 pooled over T, H, W; and the causal per-frame option."""
    jm = jvid.VideoResidualBlock(**kw)
    _compare(jm, VideoResidualBlock(**kw), [_rand(5, 2, 3, 6, 6, 8)], OP_TOL)
    with pytest.raises(NotImplementedError, match="not ported"):
        VideoResidualBlock(8, downsample=2)


def test_space_to_depth():
    x = _rand(6, 2, 8, 6, 3)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jspace_to_depth(jnp.asarray(x), 2)))


@pytest.mark.parametrize("kw", [
    {"inp_channel": 8},
    {"inp_channel": 8, "out_channel": 16, "num_groups": 4},
    {"inp_channel": 8, "out_channel": 16, "downsample": 2},
])
def test_image_residual_block(kw):
    """GroupNorm eps 1e-6, the SpaceDownsample branch, and a strided 1x1
    residual projection with no padding."""
    _compare(jimg.ImageResidualBlock(**kw), ImageResidualBlock(**kw), [_rand(8, 2, 8, 8, 8)],
             OP_TOL, jiggle=True)


@pytest.mark.parametrize("hw", [64, 32])
def test_spatial_attention_on_images(hw):
    """`(B, H, W, C)` images (the frame discriminator's input), with the
    2-D RoPE over the 64x64 and 32x32 grids."""
    kw = dict(n_head=2, d_head=16, d_inp=16, d_out=16)
    _compare(jatt.SpatialAttention(**kw), tatt.SpatialAttention(**kw),
             [_rand(9, 2, hw, hw, 16)], STACK_TOL)


def test_frame_discriminator():
    """The compact config's discriminator (attention and conv FFN in both
    stages, GroupNorm of 4 groups, a strided stage), forward and every
    gradient; the head flattens channels-last."""
    kw = tokenizer_compact_train_config()["disc_kwargs"]
    tm = FrameDiscriminator(**kw)
    _compare(jdisc.FrameDiscriminator(**kw), tm, [np.abs(_rand(10, 3, 32, 32, 3))], STACK_TOL)
    assert tm.head.in_features == 16 * 16 * 32


def test_vgg16_features():
    """Taps `features.1` and `features.6` (the trunk stops at the deepest)."""
    layers = ("features.1", "features.6")
    jm, tm = jvgg.VGG16Features(feat_layers=layers), VGG16Features(layers)
    x = np.abs(_rand(11, 2, 16, 16, 3))
    params = jm.init(KEY, x)["params"]
    load_flax_params(tm, _np_tree(params))
    assert {n.split(".")[0] for n, _ in tm.named_parameters()} == {"conv_0", "conv_2", "conv_5"}
    ref = jm.apply({"params": params}, x)
    out = tm(torch.from_numpy(x))
    assert set(out) == set(layers)
    for k in layers:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **OP_TOL)


def test_frame_picking():
    video = _rand(12, 3, 5, 4, 4, 2)
    key = jax.random.PRNGKey(5)
    idxs = np.array(jrandom_frame_idxs(key, 3, 5, 2))
    np.testing.assert_array_equal(
        pick_frames(torch.from_numpy(video), torch.from_numpy(idxs)).numpy(),
        np.asarray(jpick_frames(jnp.asarray(video), jnp.asarray(idxs))))
    g = torch.Generator().manual_seed(0)
    drawn = random_frame_idxs(g, 3, 5, 4)
    assert drawn.shape == (3, 4)
    assert all(len(set(row.tolist())) == 4 and row.max() < 5 for row in drawn)
    again = random_frame_idxs(torch.Generator().manual_seed(0), 3, 5, 4)
    assert torch.equal(drawn, again)


def _loss_inputs(seed):
    rec = np.clip(_rand(seed, B, T, HW, HW, 3) * 0.2 + 0.5, 0, 1)
    video = np.abs(_rand(seed + 1, B, T, HW, HW, 3)) % 1.0
    return rec, video


def test_perceptual_loss():
    rec, video = _loss_inputs(13)
    key = jax.random.PRNGKey(6)
    layers = ("features.6", "features.13")
    jm = jloss_mod.PerceptualLoss(feat_layers=layers, num_frames=2)
    params = jm.init(KEY, rec, jnp.asarray(video), key)["params"]
    (ref, (g_rec,)) = jax.jit(jax.value_and_grad(
        lambda r: jm.apply({"params": params}, r, jnp.asarray(video), key), argnums=(0,)))(rec)
    tm = PerceptualLoss(feat_layers=layers, num_frames=2)
    load_flax_params(tm, _np_tree(params))
    idxs = torch.from_numpy(np.array(jrandom_frame_idxs(key, B, T, 2)))
    rt = torch.from_numpy(rec).requires_grad_()
    loss = tm(rt, torch.from_numpy(video), idxs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(g_rec), **STACK_TOL)


def _gan_pair(seed):
    kw = tokenizer_compact_train_config()["disc_kwargs"]
    rec, video = _loss_inputs(seed)
    jm = jloss_mod.GANLoss(num_frames=2, disc_kwargs=kw)
    params = jm.init(KEY, rec, jnp.asarray(video), KEY, method=jm.both)["params"]
    tm = GANLoss(num_frames=2, disc_kwargs=kw)
    load_flax_params(tm, _np_tree(params))
    return jm, params, tm, rec, video


def test_gan_loss_both_and_branches():
    """`both`, and `gen` / `dis` alone, on JAX's frame indices: values and
    the gradients into the discriminator and into the reconstruction."""
    jm, params, tm, rec, video = _gan_pair(14)
    key = jax.random.PRNGKey(7)
    idxs = torch.from_numpy(np.array(jrandom_frame_idxs(key, B, T, 2)))

    def jtotal(p, r):
        gen, dis = jm.apply({"params": p}, r, jnp.asarray(video), key, method=jm.both)
        return gen + dis, (gen, dis)

    (_, (jgen, jdis)), (jg_p, jg_r) = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True))(params, rec)
    rt = torch.from_numpy(rec).requires_grad_()
    gen, dis = tm.both(rt, torch.from_numpy(video), idxs)
    (gen + dis).backward()
    np.testing.assert_allclose([gen.item(), dis.item()], [float(jgen), float(jdis)], rtol=1e-5)
    ref, _ = state_dict_from_flax(_np_tree(jg_p), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **STACK_TOL, err_msg=name)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jg_r), **STACK_TOL)
    for train_gen in (True, False):
        want = jm.apply({"params": params}, rec, jnp.asarray(video), key, train_gen=train_gen)
        got = tm(torch.from_numpy(rec), torch.from_numpy(video), idxs, train_gen=train_gen)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_generator_term_gives_the_discriminator_zero_gradient():
    """`-mean(d_f - d_fs + sg(d_fs))`: the two discriminator passes cancel
    in D's parameters (exactly, the passes being the same arithmetic); the
    reconstruction still gets the generator's gradient."""
    _, _, tm, rec, video = _gan_pair(15)
    idxs = torch.tensor([[0, 2], [3, 1]])
    rt = torch.from_numpy(rec).requires_grad_()
    gen, _ = tm.both(rt, torch.from_numpy(video), idxs)
    gen.backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and not p.grad.any(), name
    assert rt.grad.abs().sum() > 0
    tm.zero_grad()
    tm(rt, torch.from_numpy(video), idxs, train_gen=True).backward()
    assert all(not p.grad.any() for p in tm.parameters())


@pytest.fixture(scope="module")
def tokenizer_pair():
    """The JAX module, its weights, a video, a key and `jax.value_and_grad`
    of the loss there."""
    cfg = tokenizer_compact_train_config()
    jm = jlosses.TokenizerTrainModule(**cfg)
    video = (np.abs(_rand(16, B, T, HW, HW, 3)) % 1.0).astype(np.float32)
    params = jax.jit(lambda k, v: jm.init(k, v, k))(jax.random.PRNGKey(1), video)["params"]
    key = jax.random.PRNGKey(8)

    def loss(p, v):
        return jm.apply({"params": p}, v, key)

    return params, video, key, jax.jit(jax.value_and_grad(loss, has_aux=True))(params, video)


def _jax_idxs(key):
    k_perc, k_gan = jax.random.split(key)
    k = min(tokenizer_compact_train_config()["gan_frames_per_batch"], T)
    return {name: torch.from_numpy(np.array(jrandom_frame_idxs(kk, B, T, k)))
            for name, kk in (("perc_idxs", k_perc), ("gan_idxs", k_gan))}


def _port(params):
    tm = TokenizerTrainModule(**tokenizer_compact_train_config())
    assert load_flax_params(tm, _np_tree(params)) == []
    return tm


def test_tokenizer_train_module_matches_jax(tokenizer_pair):
    """Loss, every metric and every gradient (VGG's included: it is frozen
    in the optimizer, not in the graph)."""
    params, video, key, ((ref, ref_metrics), jgrads) = tokenizer_pair
    tm = _port(params)
    loss, metrics = tm(torch.from_numpy(video), **_jax_idxs(key))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert set(metrics) == set(ref_metrics)
    assert "lfq_avg_entropy" in metrics  # the 13-bit codebook's streamed entropy
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(ref_metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    ref_grads, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **STACK_TOL,
                                   err_msg=name)


def test_tokenizer_train_step_matches_optax(tokenizer_pair):
    """One f32 `make_train_step` step with the VGG frozen against `jax.grad`
    + optax; then a bf16 step runs with f32 gradients and leaves the VGG
    unchanged."""
    params, video, key, (_, jgrads) = tokenizer_pair
    jopt = jmake_optimizer(lr=LR, frozen_mask=jlosses.frozen_param_mask(params, ("perc_crit",)))
    updates, _ = jopt.update(jgrads, jopt.init(params), params)

    tm = _port(params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm, lr=LR, frozen_mask=frozen_param_mask(tm, ("perc_crit",)))
    metrics = make_train_step(tm, opt)(torch.from_numpy(video), **_jax_idxs(key))
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    ref_upd, _ = state_dict_from_flax(_np_tree(updates), tm)
    ref_g, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        upd = (p.detach() - before[name]).numpy()
        if name.startswith("perc_crit."):
            assert not upd.any(), name
            continue
        clear = np.abs(ref_g[name].numpy()) > 1e-4
        np.testing.assert_allclose(upd[clear], ref_upd[name].numpy()[clear], atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(upd, ref_upd[name].numpy(), atol=2.1 * LR, err_msg=name)

    step = make_train_step(tm, opt, compute_dtype=torch.bfloat16)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    metrics = step(torch.from_numpy(video), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"]) and metrics["loss"].dtype == torch.float32
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad is None
        assert torch.equal(p.detach(), before[name]) == name.startswith("perc_crit."), name


def test_configs_are_the_bench_and_blueprints(monkeypatch):
    """`tokenizer_train_config()` is what `bench.py::section_tokenizer_train`
    builds; the compact config keeps every module kind of it, a codebook
    above 4096 codes and attention in its discriminator."""
    import bench

    class Built(Exception):
        pass

    def capture(**kwargs):
        raise Built(kwargs)

    monkeypatch.setattr(jlosses, "TokenizerTrainModule", capture)
    with pytest.raises(Built) as built:
        bench.section_tokenizer_train(1, 4, 8)
    assert built.value.args[0] == tokenizer_train_config()
    assert tbp.MAGVIT2_ENC_DESC == MAGVIT2_ENC_DESC and tbp.MAGVIT2_DEC_DESC == MAGVIT2_DEC_DESC

    def kinds(cfg):
        tok = cfg["tokenizer"]
        return {desc[0] for desc in tok["enc_desc"] + tok["dec_desc"]}

    full, compact = tokenizer_train_config(), tokenizer_compact_train_config()
    assert kinds(compact) == kinds(full)
    assert compact["tokenizer"]["d_codebook"] > 12
    assert compact["disc_kwargs"]["use_attn"] and compact["disc_kwargs"]["down_step"][1] == 2


def test_registry_and_seeding_repairs():
    """The tokenizer's names resolve (activations learn their function),
    and `init_weights` seeds 2-D convs: two builds from one seed agree."""
    layers, ext = parse_blueprint((
        ("group_norm", {"num_groups": 8, "num_channels": 16}), ("silu", {}),
        ("adaptive_group_norm", {"dim_cond": 4, "num_groups": 8, "num_channels": 16,
                                 "has_ext": True}),
        ("video-residual", {"in_channels": 16}),
    ), remat=True)
    assert ext == [False, False, True, False]
    assert isinstance(layers[1], Activation) and layers[1].fn == "silu"
    assert get_module("leaky_relu") is Activation
    kw = tokenizer_compact_train_config()["disc_kwargs"]
    a, b = (init_weights(FrameDiscriminator(**kw), torch.Generator().manual_seed(3))
            for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
