"""The module library that no repo YAML reaches, in the PyTorch port against
the JAX package on the CPU: blur kernels and pooling, the depth-to-space and
depth-to-time shuffles, the causal conv's pad modes and the causal
transposed conv (functions and modules), the residual block's downsampling
branches, every `ForwardBlock` kind, standalone spatial and temporal
attention, and the registry and blueprint arithmetic around them.

Inputs are numpy from a fixed seed at odd sizes; weights come from the JAX
modules' `init` (moved off it, so every layout shows) through
`bridge.load_flax_params`. Each case compares the forward and the gradient
of `sum(out * w)` with respect to every parameter and every input.
Tolerances: one op (a conv, a blur, a shuffle) atol 1e-5 / rtol 1e-4;
blocks and attention atol 2e-3 / rtol 2e-2, `tools/parity_check.py`'s bound
for stacks; shuffles exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu import modules as jmods  # noqa: E402
from open_genie_tpu.modules import attention as jatt  # noqa: E402
from open_genie_tpu.modules import image as jimg  # noqa: E402
from open_genie_tpu.modules import misc as jmisc  # noqa: E402
from open_genie_tpu.modules import video as jvid  # noqa: E402
from open_genie_tpu.ops import conv as jconv  # noqa: E402
from open_genie_tpu.ops import resample as jres  # noqa: E402
from open_genie_tpu import utils as jutils  # noqa: E402
from open_genie_tpu_torch import modules as tmods  # noqa: E402
from open_genie_tpu_torch import utils as tutils  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.modules import attention as tatt  # noqa: E402
from open_genie_tpu_torch.modules import image as timg  # noqa: E402
from open_genie_tpu_torch.modules import misc as tmisc  # noqa: E402
from open_genie_tpu_torch.modules import video as tvid  # noqa: E402
from open_genie_tpu_torch.ops import conv as tconv  # noqa: E402
from open_genie_tpu_torch.ops import resample as tres  # noqa: E402

torch.set_num_threads(1)
OP_TOL = dict(atol=1e-5, rtol=1e-4)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)
KEY = jax.random.PRNGKey(0)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jiggle(params, seed=7):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        p + 0.3 * rng.standard_normal(p.shape).astype(np.float32) for p in leaves])


def _check(ref, jgrads_x, tout, xs, w, tol):
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(ref), **tol)
    for x, g in zip(xs, jgrads_x):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **tol)


def compare_fn(jfn, tfn, inputs, tol=OP_TOL):
    """A JAX function and its port on the same numpy `inputs`: the output
    and the gradient of `sum(out * w)` with respect to each input."""
    ref, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in inputs])
    w = _rand(99, *ref.shape)
    jgrads = vjp(jnp.asarray(w))
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = tfn(*xs)
    (out * torch.from_numpy(w)).sum().backward()
    _check(ref, jgrads, out, xs, w, tol)
    return out


def compare(jmod, tmod, inputs, tol=OP_TOL):
    """A flax module and its port, the JAX weights moved off their init and
    loaded through the bridge: output, every parameter's gradient and every
    input's."""
    params = _jiggle(jmod.init(KEY, *inputs).get("params", {}))
    load_flax_params(tmod, jax.tree.map(np.asarray, params))

    def fwd(p, *xs):
        return jmod.apply({"params": p}, *xs)

    w = _rand(99, *jax.eval_shape(fwd, params, *inputs).shape)

    @jax.jit
    def ref_and_grads(p, *xs):
        out, vjp = jax.vjp(fwd, p, *xs)
        return out, vjp(jnp.asarray(w))

    ref, grads = ref_and_grads(params, *inputs)
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = tmod(*xs)
    (out * torch.from_numpy(w)).sum().backward()
    _check(ref, grads[1:], out, xs, w, tol)
    ref_grads, _ = state_dict_from_flax(jax.tree.map(np.asarray, grads[0]), tmod)
    assert set(ref_grads) == {n for n, _ in tmod.named_parameters()}
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **tol, err_msg=name)
    return out


# ------------------------------------------------------------- resample


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_blur_kernels(k):
    np.testing.assert_array_equal(tres.binomial_kernel_1d(k), jres.binomial_kernel_1d(k))
    for size in ((k, 3), (3, k)):
        np.testing.assert_array_equal(tres.blur_kernel_2d(size).numpy(),
                                      np.asarray(jres.blur_kernel_2d(size)))
    for size in ((k, 3, 2), (3, k, 5), k):  # each axis its own row
        np.testing.assert_array_equal(tres.blur_kernel_3d(size).numpy(),
                                      np.asarray(jres.blur_kernel_3d(size)))
    np.testing.assert_array_equal(tres.blur_kernel_3d((k, 2, 3), norm=False).numpy(),
                                  np.asarray(jres.blur_kernel_3d((k, 2, 3), norm=False)))


@pytest.mark.parametrize("kernel_size,stride", [(3, 2), (4, 2), ((3, 5), (2, 3)), (5, 1)])
def test_blur_pool_2d(kernel_size, stride):
    """Pad `(k - 1) // stride`, as the JAX package (not `(k - 1) // 2`)."""
    x = _rand(0, 2, 9, 11, 3)
    compare_fn(lambda v: jres.blur_pool_2d(v, kernel_size, stride),
               lambda v: tres.blur_pool_2d(v, kernel_size, stride), [x])


@pytest.mark.parametrize("kernel_size,tf,sf", [(3, 2, 2), ((3, 5, 4), 1, (2, 3)), (2, 3, 1)])
def test_blur_pool_3d(kernel_size, tf, sf):
    x = _rand(1, 2, 7, 9, 10, 3)
    compare_fn(lambda v: jres.blur_pool_3d(v, kernel_size, tf, sf),
               lambda v: tres.blur_pool_3d(v, kernel_size, tf, sf), [x])


@pytest.mark.parametrize("factor", [2, 3])
def test_depth_to_space_and_time(factor):
    x = _rand(2, 2, 3, 5, 4, 2 * factor * factor)
    np.testing.assert_array_equal(tres.depth_to_space(torch.from_numpy(x), factor).numpy(),
                                  np.asarray(jres.depth_to_space(jnp.asarray(x), factor)))
    x = _rand(3, 2, 3, 5, 4, 2 * factor)
    np.testing.assert_array_equal(tres.depth_to_time(torch.from_numpy(x), factor).numpy(),
                                  np.asarray(jres.depth_to_time(jnp.asarray(x), factor)))


def test_blur_pool_bf16_and_reuse_across_modes():
    """The kernel is cast to the input's dtype, as JAX's; a weight cached
    under inference mode can be saved for a later backward."""
    x = _rand(4, 1, 5, 6, 6, 4)
    ref = jres.blur_pool_3d(jnp.asarray(x, jnp.bfloat16), 3, 2, 2)
    with torch.inference_mode():
        out = tres.blur_pool_3d(torch.from_numpy(x).bfloat16(), 3, 2, 2)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)  # bf16 sums in two orders
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    tres.blur_pool_3d(xt, 3, 2, 2).float().sum().backward()
    assert xt.grad is not None


# ----------------------------------------------------------------- conv


PAD_MODES = ["constant", "zeros", "edge", "replicate", "reflect", "wrap", "symmetric"]


@pytest.mark.parametrize("pad_mode", PAD_MODES)
def test_causal_conv3d_pad_modes(pad_mode):
    """Time and space padded in the mode, then VALID: at a stride and a
    dilation, and through the module (`pad_mode` reaches the conv)."""
    x = _rand(5, 2, 5, 6, 7, 3)
    k = _rand(6, 3, 3, 2, 3, 4)  # JAX's (kt, kh, kw, I, O)
    compare_fn(lambda v, kk: jconv.causal_conv3d(v, kk, stride=(1, 2, 1), dilation=(2, 1, 1),
                                                 pad_mode=pad_mode),
               lambda v, kk: tconv.causal_conv3d(v, kk.permute(4, 3, 0, 1, 2), stride=(1, 2, 1),
                                                 dilation=(2, 1, 1), pad_mode=pad_mode),
               [x, k])
    kw = dict(in_channels=3, out_channels=4, kernel_size=(3, 3, 2), stride=(2, 1, 1),
              pad_mode=pad_mode)
    compare(jvid.CausalConv3d(**kw), tvid.CausalConv3d(**kw), [x])


def test_pad_mode_that_numpy_rejects_raises():
    x = _rand(7, 1, 3, 4, 4, 2)
    k = _rand(8, 3, 3, 3, 2, 2)
    with pytest.raises((ValueError, NotImplementedError)):
        jconv.causal_conv3d(jnp.asarray(x), jnp.asarray(k), pad_mode="circular")
    with pytest.raises(ValueError, match="circular"):
        tconv.causal_conv3d(torch.from_numpy(x), torch.from_numpy(k).permute(4, 3, 0, 1, 2),
                            pad_mode="circular")
    cache = torch.zeros(1, 2, 4, 4, 2)
    with pytest.raises(AssertionError, match="constant"):  # streaming keeps constant pads
        tvid.CausalConv3d(2, 2, pad_mode="edge")(torch.from_numpy(x), cache=cache)


@pytest.mark.parametrize("kernel_size,stride,space_pad", [
    (3, (2, 2, 2), None), ((2, 3, 4), (1, 2, 3), None), (3, (2, 1, 2), (0, 2))])
def test_causal_conv_transpose3d(kernel_size, stride, space_pad):
    """The function takes JAX's `transpose_kernel=True` kernel `(kt, kh, kw,
    C_in, C_out)` as torch's `(C_in, C_out, ...)` unflipped; the module
    wraps flax's `ConvTranspose`, whose kernel the bridge flips."""
    x = _rand(9, 2, 3, 4, 5, 6)
    kt, kh, kw = (kernel_size,) * 3 if isinstance(kernel_size, int) else kernel_size
    k = _rand(10, kt, kh, kw, 6, 4)
    b = _rand(11, 4)
    compare_fn(lambda v, kk, bb: jconv.causal_conv_transpose3d(v, kk, bb, stride, space_pad),
               lambda v, kk, bb: tconv.causal_conv_transpose3d(
                   v, kk.permute(3, 4, 0, 1, 2), bb, stride, space_pad), [x, k, b])
    kw_ = dict(in_channels=6, out_channels=4, kernel_size=kernel_size, stride=stride,
               space_pad=space_pad)
    out = compare(jvid.CausalConvTranspose3d(**kw_), tvid.CausalConvTranspose3d(**kw_), [x])
    assert out.shape[1] == 3 * stride[0]  # space is short where k // 2 + s * n > (n-1) s + k
    assert tvid.CausalConvTranspose3d(**kw_).t_factor == jvid.CausalConvTranspose3d(**kw_).t_factor


# -------------------------------------------------------------- modules


def test_blur_pooling_modules():
    """No parameters; `BlurPooling3d` ignores `out_channels` and
    `num_groups`, and its `t_factor` is `1 / time_factor`."""
    x = _rand(12, 2, 7, 9, 3)
    compare(jimg.BlurPooling2d(kernel_size=4, stride=2), timg.BlurPooling2d(4, 2), [x])
    v = _rand(13, 2, 5, 7, 6, 3)
    kw = dict(in_channels=3, kernel_size=(3, 2, 3), out_channels=9, time_factor=2,
              space_factor=(2, 3), num_groups=3)
    out = compare(jvid.BlurPooling3d(**kw), tvid.BlurPooling3d(**kw), [v])
    assert out.shape[-1] == 3 and list(tvid.BlurPooling3d(**kw).parameters()) == []
    assert tvid.BlurPooling3d(**kw).t_factor == jvid.BlurPooling3d(**kw).t_factor == 0.5


@pytest.mark.parametrize("cls,kw", [
    ("DepthToSpaceUpsample", dict(in_channels=6, factor=2)),
    ("DepthToSpaceUpsample", dict(in_channels=6, out_channels=4, factor=3)),
    ("DepthToTimeUpsample", dict(in_channels=6, factor=2)),
    ("DepthToTimeUpsample", dict(in_channels=6, out_channels=5, factor=3)),
])
def test_depth_to_upsamplers(cls, kw):
    jm, tm = getattr(jvid, cls)(**kw), getattr(tvid, cls)(**kw)
    compare(jm, tm, [_rand(14, 2, 3, 5, 4, 6)])
    assert (tm.st_factor, tm.t_factor) == (jm.st_factor, jm.t_factor)


@pytest.mark.parametrize("kw", [
    dict(in_channels=4, out_channels=6, downsample=2),                      # blur, int
    dict(in_channels=4, downsample=(1, 2), kernel_size=(3, 3, 5)),          # blur, space
    dict(in_channels=4, out_channels=6, downsample=(2, 2), use_blur=False),  # strided
    dict(in_channels=4, downsample=2, use_blur=False, use_causal=True, pad_mode="replicate"),
    dict(in_channels=4, out_channels=6, downsample=(2, 1), use_causal=True,
         pad_mode="symmetric", act_fn="leaky", num_groups=2),
    dict(in_channels=4, use_causal=True, pad_mode="reflect", per_frame_norm=True),
    dict(in_channels=4, pad_mode="wrap", use_norm=False),  # non-causal: mode unused
])
def test_video_residual_block_downsample_and_pad_modes(kw):
    """Both branches downsample (the main after conv1, the residual before
    `res_proj`): a blur, or a strided `SpaceTimeDownsample` named
    `down_main` / `down_res`; `pad_mode` reaches only the causal convs."""
    compare(jvid.VideoResidualBlock(**kw), tvid.VideoResidualBlock(**kw),
            [_rand(15, 2, 4, 7, 6, 4)], STACK_TOL)


@pytest.mark.parametrize("block,causal_time,hid_dim", [
    ("dense", False, 12), ("dense", False, None), ("conv2d", False, (10, 6)),
    ("conv3d", False, 12), ("conv3d", True, 12), ("conv3d", True, None),
])
def test_forward_block_kinds(block, causal_time, hid_dim):
    """JAX's defaults (`dense`, `hid_dim` 256, kernel 1) and each kind.
    Without `causal_time` a conv3d block pools its GroupNorm over time and
    pads time on both sides: the port's block used to be per-frame and
    causal whatever it was given."""
    shape = {"dense": (2, 5, 8), "conv2d": (2, 5, 7, 8), "conv3d": (2, 4, 5, 3, 8)}[block]
    kw = dict(in_dim=8, out_dim=6, hid_dim=hid_dim, block=block, num_groups=2, last_act=True,
              kernel_size=3, causal_time=causal_time)
    if block == "dense":
        kw.pop("kernel_size")
    compare(jmisc.ForwardBlock(**kw), tmisc.ForwardBlock(**kw), [_rand(16, *shape)], STACK_TOL)


def test_forward_block_defaults():
    tdef = tmisc.ForwardBlock(8)
    compare(jmisc.ForwardBlock(in_dim=8), tdef, [_rand(17, 2, 3, 8)], STACK_TOL)
    assert tdef.block_0.out_features == 256 and tdef.block == "dense"


@pytest.mark.parametrize("causal", [False, True, None])
@pytest.mark.parametrize("with_cond", [False, True])
def test_temporal_attention(causal, with_cond):
    """`time_attn`: causal only when asked (None: the default, not causal
    in JAX, which the port used to hard-code causal); a condition repeats
    over space; `d_out` sets the output width."""
    kw = dict(n_head=2, d_head=16, d_inp=12, d_out=10)
    if causal is not None:
        kw["causal"] = causal
    inputs = [_rand(18, 2, 5, 3, 2, 12)]
    if with_cond:
        kw["key_dim"] = 6
        inputs.append(_rand(19, 2, 5, 6))
    out = compare(jatt.TemporalAttention(**kw), tatt.TemporalAttention(**kw), inputs, STACK_TOL)
    assert out.shape[-1] == 10


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("image,with_cond", [(True, False), (False, False), (False, True)])
def test_spatial_attention(causal, image, with_cond):
    """`space_attn` on `(B, H, W, C)` images and on videos; a condition
    repeats over time; no `d_out`: the output keeps `d_inp`."""
    kw = dict(n_head=2, d_head=16, d_inp=12, causal=causal)
    shape = (2, 3, 5, 12) if image else (2, 3, 3, 5, 12)
    inputs = [_rand(20, *shape)]
    if with_cond:
        kw["key_dim"] = 6
        inputs.append(_rand(21, 2, 15, 6))
    out = compare(jatt.SpatialAttention(**kw), tatt.SpatialAttention(**kw), inputs, STACK_TOL)
    assert out.shape == shape


# ------------------------------------------------------ registry and blueprints


BLUEPRINT = (
    ("causal-conv3d", {"in_channels": 3, "out_channels": 8, "kernel_size": 3,
                       "pad_mode": "edge"}),
    ("video-residual", {"in_channels": 8, "out_channels": 12, "downsample": [1, 2]}),
    ("space_attn", {"n_head": 2, "d_head": 8}),
    ("time_attn", {"n_head": 2, "d_head": 8, "d_out": 16, "causal": True}),
    ("video-residual", {"in_channels": 16, "downsample": 2, "use_blur": False,
                        "use_causal": True, "pad_mode": "reflect"}),
    ("causal-conv3d-transpose", {"in_channels": 16, "out_channels": 10, "kernel_size": 3,
                                 "stride": [2, 1, 1]}),
    ("depth2time_upsample", {"in_channels": 10, "factor": 2}),
    ("depth2space_upsample", {"in_channels": 10, "out_channels": 6, "factor": 2}),
    ("gelu", {}),
    ("spacetime_downsample", {"in_channels": 6, "time_factor": 2, "space_factor": 2}),
)


def test_blueprint_of_the_new_names():
    """A blueprint of the new names, built by both parsers: the same
    output (the attentions take `d_inp` from the running width), the
    running width at its end, and `blueprint_time_factor` equal to JAX's
    (the residual block's time stride is not counted, in either)."""
    import flax.linen as fnn

    class Stack(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            layers, _ = jmods.parse_blueprint(BLUEPRINT, named=True)
            for layer in layers:
                x = layer(x)
            return x

    layers, _ = tmods.parse_blueprint(BLUEPRINT)
    stack = torch.nn.Sequential(*layers)
    # flax names the layers by position; the port's Sequential by index.
    x = _rand(22, 1, 4, 8, 8, 3)
    params = _jiggle(jax.jit(Stack().init)(KEY, x)["params"])
    renamed = {str(int(name.split("_")[1])): p for name, p in params.items()}
    load_flax_params(stack, jax.tree.map(np.asarray, renamed))
    ref = jax.jit(Stack().apply)({"params": params}, x)
    with torch.no_grad():
        out = stack(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **STACK_TOL)
    assert tmods.blueprint_out_width(BLUEPRINT) == out.shape[-1] == 6
    assert tmods.blueprint_time_factor(BLUEPRINT) == jmods.blueprint_time_factor(BLUEPRINT)
    assert tmods.blueprint_st_factor(BLUEPRINT) == jmods.blueprint_st_factor(BLUEPRINT)
    with pytest.raises(ValueError, match=r"layer 0 \(time_attn\).*d_inp"):
        tmods.parse_blueprint((("time_attn", {"n_head": 2, "d_head": 8}),))
    assert type(tmods.parse_blueprint((("time_attn", {"n_head": 2, "d_head": 8}),),
                                      width=12)[0][0]) is tatt.TemporalAttention


def test_public_helpers():
    x = _rand(23, 2, 3, 4, 5, 6)
    np.testing.assert_array_equal(tutils.to_channels_first(torch.from_numpy(x)).numpy(),
                                  np.asarray(jutils.to_channels_first(jnp.asarray(x))))
    np.testing.assert_array_equal(tutils.to_channels_last(torch.from_numpy(x)).numpy(),
                                  np.asarray(jutils.to_channels_last(jnp.asarray(x))))
    for a, b in (((3,), (3, 4, 5)), ((3, 4), (3,)), ((2,), (2, 1))):
        assert tuple(tutils.enlarge_as(torch.ones(a), torch.ones(b)).shape) == \
            jutils.enlarge_as(jnp.ones(a), jnp.ones(b)).shape
    for name in ("spacetime_downsample", "space_downsample", "video-residual"):
        assert tutils.enc2dec_name(name) == jutils.enc2dec_name(name)
