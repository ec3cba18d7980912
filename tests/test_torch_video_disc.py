"""The whole-clip GAN of the PyTorch port against the JAX package on the
CPU: `VideoDiscriminator` (attention, causal stem and convs, blur or
strided downsampling, odd clip sizes; the dense head sized at build by the
convs' arithmetic, where JAX sizes it from its first input),
`GANLoss(discriminate="video")` and one `TokenizerTrainModule` step with
`gan_discriminate="video"` on `tokenizer_compact_train_config()` with
`chip_smoke.COMPACT_VIDEO_DISC_KWARGS`.

Weights come from the JAX modules through `bridge.load_flax_params`.
Tolerances: stacks atol 2e-3 / rtol 2e-2 (`tools/parity_check.py`);
losses within 1e-5 relative; the optimizer's update as in
`tests/test_torch_tokenizer_train.py`.
"""
from math import prod

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from open_genie_tpu.modules import discriminator as jdisc  # noqa: E402
from open_genie_tpu.modules import loss as jloss  # noqa: E402
from open_genie_tpu.train import losses as jlosses  # noqa: E402
from open_genie_tpu.train.loop import make_optimizer as jmake_optimizer  # noqa: E402
from open_genie_tpu.utils import random_frame_idxs as jrandom_frame_idxs  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import tokenizer_compact_train_config  # noqa: E402
from open_genie_tpu_torch.modules.discriminator import (  # noqa: E402
    FrameDiscriminator,
    VideoDiscriminator,
    video_disc_out_size,
)
from open_genie_tpu_torch.modules.loss import GANLoss  # noqa: E402
from open_genie_tpu_torch.train.loop import make_optimizer, make_train_step  # noqa: E402
from open_genie_tpu_torch.train.losses import TokenizerTrainModule, frozen_param_mask  # noqa: E402
from test_torch_module_library import STACK_TOL, compare  # noqa: E402

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
LR = 1e-4


def _video(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


DISC_CASES = {
    # The compact twin of phase 27's discriminator: attention, blur.
    "attn_blur": (dict(chip_smoke.COMPACT_VIDEO_DISC_KWARGS, inp_size=(4, 8, 8)), (4, 8, 8)),
    # Causal stem and convs, strided downsampling, odd sizes, W != H.
    "causal_strided": (dict(inp_size=(5, 9, 7), model_dim=4, dim_mults=(1, 2, 2),
                            down_step=((2, 2), 2, None), num_groups=2, use_causal=True,
                            use_blur=False), (5, 9, 7)),
    # `(T, H)` for W = H, blur at odd sizes with attention, a space-only step.
    "blur_odd_2tuple": (dict(inp_size=(3, 9), model_dim=4, dim_mults=(2, 4), down_step=((1, 2), 3),
                             use_attn=True, num_heads=2, dim_head=16), (3, 9, 9)),
}


@pytest.mark.parametrize("case", list(DISC_CASES))
def test_video_discriminator(case):
    """Forward and every gradient against JAX; the head's width is JAX's
    lazily sized one (the bridge refuses any other)."""
    kw, size = DISC_CASES[case]
    tm = VideoDiscriminator(**kw)
    compare(jdisc.VideoDiscriminator(**kw), tm, [_video(1, 2, *size, 3)], STACK_TOL)
    assert tm.head.in_features == prod(tm.out_size) * kw["model_dim"] * kw["dim_mults"][-1]


def test_frame_discriminator_first_block_takes_the_stem_width():
    """With `dim_mults[0] != 1` the first residual block's input is the
    stem's `model_dim` channels, as JAX's lazily sized block takes them
    (the port's used to expect `model_dim * dim_mults[0]` and raise)."""
    kw = dict(inp_size=(8, 8), model_dim=4, dim_mults=(2, 4), down_step=(2, None))
    compare(jdisc.FrameDiscriminator(**kw), FrameDiscriminator(**kw),
            [_video(6, 2, 8, 8, 3)], STACK_TOL)


def test_video_discriminator_sizes_and_mismatch():
    """Phase 27's discriminator: blur to 4 x 32x32, a head over 4 * 32 *
    32 * 256 features (built on the meta device); `video_disc_out_size`
    counts the conv arithmetic (ceil, not floor, at an odd size); a clip
    of another size raises naming both."""
    with torch.device("meta"):
        full = VideoDiscriminator(**chip_smoke.VIDEO_DISC_KWARGS)
    assert full.out_size == (4, 32, 32) and full.head.in_features == 1_048_576
    assert video_disc_out_size((5, 9, 9), 3, (None, 2, 2)) == (3, 5, 5)
    assert video_disc_out_size((5, 9, 9), 3, (None, 2, 2), use_blur=False,
                               use_causal=True) == (2, 5, 5)
    tm = VideoDiscriminator(**DISC_CASES["blur_odd_2tuple"][0])
    with pytest.raises(ValueError, match=r"\(3, 9, 9\).*\(3, 8, 8\)"):
        tm(torch.zeros(1, 3, 8, 8, 3))


def _gan_pair():
    kw = dict(chip_smoke.COMPACT_VIDEO_DISC_KWARGS, inp_size=(4, 8, 8))
    rec = np.random.default_rng(2).standard_normal((2, 4, 8, 8, 3)).astype(np.float32)
    video = _video(3, 2, 4, 8, 8, 3)
    jm = jloss.GANLoss(discriminate="video", disc_kwargs=kw)
    params = jm.init(KEY, rec, jnp.asarray(video), KEY, method=jm.both)["params"]
    tm = GANLoss("video", disc_kwargs=kw)
    load_flax_params(tm, _np_tree(params))
    return jm, params, tm, rec, video


def test_gan_loss_video_both_and_branches():
    """`both` on whole clips (no frame picking; `idxs` ignored): values
    and the gradients into the discriminator and the reconstruction; the
    generator term gives D's parameters exactly zero gradient; `gen` and
    `dis` alone."""
    jm, params, tm, rec, video = _gan_pair()

    def jtotal(p, r):
        gen, dis = jm.apply({"params": p}, r, jnp.asarray(video), KEY, method=jm.both)
        return gen + dis, (gen, dis)

    (_, (jgen, jdis)), (jg_p, jg_r) = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True))(params, rec)
    rt = torch.from_numpy(rec).requires_grad_()
    gen, dis = tm.both(rt, torch.from_numpy(video), None)
    (gen + dis).backward()
    np.testing.assert_allclose([gen.item(), dis.item()], [float(jgen), float(jdis)], rtol=1e-5)
    ref, _ = state_dict_from_flax(_np_tree(jg_p), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **STACK_TOL, err_msg=name)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jg_r), **STACK_TOL)
    tm.zero_grad()
    tm.both(rt, torch.from_numpy(video), None)[0].backward()
    assert all(not p.grad.any() for p in tm.parameters())
    for train_gen in (True, False):
        want = jm.apply({"params": params}, rec, jnp.asarray(video), KEY, train_gen=train_gen)
        got = tm(torch.from_numpy(rec), torch.from_numpy(video), None, train_gen=train_gen)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_tokenizer_train_step_with_video_discriminator():
    """The compact tokenizer with phase 27's compact discriminator: loss,
    every metric and gradient against `jax.value_and_grad`, then one f32
    `make_train_step` update against optax with the VGG frozen (JAX's
    perceptual frame indices fed to the port; the GAN takes none)."""
    cfg = chip_smoke.video_disc_train_config(tokenizer_compact_train_config(),
                                             chip_smoke.COMPACT_VIDEO_DISC_KWARGS)
    jm = jlosses.TokenizerTrainModule(**cfg)
    video = _video(5, 2, 4, 32, 32, 3)
    params = jax.jit(lambda k, v: jm.init(k, v, k))(jax.random.PRNGKey(1), video)["params"]
    key = jax.random.PRNGKey(8)
    # No code sign is decided by rounding (|z| below chip_smoke's
    # LFQ_UNDECIDED): there JAX's own jitted and eager steps part ways.
    from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer

    enc = JTokenizer(**cfg["tokenizer"]).apply({"params": params["model"]}, video,
                                                method=JTokenizer.encode)
    assert np.abs(np.asarray(enc)).min() > chip_smoke.LFQ_UNDECIDED
    (ref, ref_metrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, v: jm.apply({"params": p}, v, key), has_aux=True))(params, video)
    jopt = jmake_optimizer(lr=LR, frozen_mask=jlosses.frozen_param_mask(params, ("perc_crit",)))
    updates, _ = jopt.update(jgrads, jopt.init(params), params)

    tm = TokenizerTrainModule(**cfg)
    assert load_flax_params(tm, _np_tree(params)) == []
    k_perc, _ = jax.random.split(key)
    perc_idxs = torch.from_numpy(np.array(jrandom_frame_idxs(k_perc, 2, 4, 2)))
    loss, metrics = tm(torch.from_numpy(video), perc_idxs=perc_idxs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(ref_metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    ref_g, _ = state_dict_from_flax(_np_tree(jgrads), tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_g[name].numpy(), **STACK_TOL,
                                   err_msg=name)

    tm.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm, lr=LR, frozen_mask=frozen_param_mask(tm, ("perc_crit",)))
    metrics = make_train_step(tm, opt)(torch.from_numpy(video), perc_idxs=perc_idxs)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    ref_upd, _ = state_dict_from_flax(_np_tree(updates), tm)
    for name, p in tm.named_parameters():
        upd = (p.detach() - before[name]).numpy()
        if name.startswith("perc_crit."):
            assert not upd.any(), name
            continue
        clear = np.abs(ref_g[name].numpy()) > 1e-4
        np.testing.assert_allclose(upd[clear], ref_upd[name].numpy()[clear], atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(upd, ref_upd[name].numpy(), atol=2.1 * LR, err_msg=name)
