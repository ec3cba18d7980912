"""PyTorch port modules against their JAX counterparts on the CPU.

Weights come from the JAX modules' `init` and go through `bridge.py`;
inputs are numpy from a fixed seed. Tolerances: a module that is one op
(a conv) agrees to atol 1e-5 / rtol 1e-4; attention and space-time stacks
to atol 2e-3 / rtol 2e-2, the repo's cross-backend parity bound
(`tools/parity_check.py`); integer results exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import open_genie_tpu.models.blueprints as jbp  # noqa: E402
from open_genie_tpu.models.dynamics import get_schedule as jget_schedule  # noqa: E402
from open_genie_tpu.modules import attention as jatt  # noqa: E402
from open_genie_tpu.modules import misc as jmisc  # noqa: E402
from open_genie_tpu.modules import video as jvid  # noqa: E402
import open_genie_tpu_torch.models.blueprints as tbp  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    genie_compact_config,
    genie_serve_config,
    genie_rollout_config,
)
from open_genie_tpu_torch.models.dynamics import get_schedule  # noqa: E402
from open_genie_tpu_torch.modules import attention as tatt  # noqa: E402
from open_genie_tpu_torch.modules import get_module, parse_blueprint  # noqa: E402
from open_genie_tpu_torch.modules import misc as tmisc  # noqa: E402
from open_genie_tpu_torch.modules import video as tvid  # noqa: E402

torch.set_num_threads(1)
OP_TOL = dict(atol=1e-5, rtol=1e-4)  # one f32 op, different summation order
STACK_TOL = dict(atol=2e-3, rtol=2e-2)  # parity_check.py's bound for stacks
KEY = jax.random.PRNGKey(0)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _port(jmod, tmod, *inputs, **kwargs):
    """Init the JAX module on `inputs`, load its params into `tmod`, and
    return the params."""
    params = jmod.init(KEY, *inputs, **kwargs)["params"]
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    return params


# ---------------------------------------------------------------- video


@pytest.mark.parametrize(
    "jcls,tcls,kw",
    [
        (jvid.CausalConv3d, tvid.CausalConv3d,
         dict(in_channels=3, out_channels=8, kernel_size=3)),
        (jvid.CausalConv3d, tvid.CausalConv3d,
         dict(in_channels=3, out_channels=8, kernel_size=(3, 1, 3), stride=(1, 2, 1))),
        (jvid.CausalConv3d, tvid.CausalConv3d,
         dict(in_channels=3, out_channels=8, kernel_size=1)),
        (jvid.SpaceTimeDownsample, tvid.SpaceTimeDownsample,
         dict(in_channels=3, out_channels=8, kernel_size=3, time_factor=1, space_factor=4)),
        (jvid.SpaceTimeDownsample, tvid.SpaceTimeDownsample,
         dict(in_channels=3, kernel_size=3, time_factor=2, space_factor=2)),
        (jvid.DepthToSpaceTimeUpsample, tvid.DepthToSpaceTimeUpsample,
         dict(in_channels=3, out_channels=2, kernel_size=3, time_factor=1, space_factor=4)),
        (jvid.DepthToSpaceTimeUpsample, tvid.DepthToSpaceTimeUpsample,
         dict(in_channels=3, kernel_size=3, time_factor=2, space_factor=2)),
    ],
)
def test_video_modules(jcls, tcls, kw):
    x = _rand(0, 2, 4, 8, 8, 3)
    jmod, tmod = jcls(**kw), tcls(**kw)
    params = _port(jmod, tmod, x)
    ref = jmod.apply({"params": params}, x)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **OP_TOL)
    assert tmod.t_factor == jmod.t_factor


GOLDEN_CONV = {  # the cases of tests/test_golden_parity.py
    "k3": dict(kernel_size=3),
    "k3_s2": dict(kernel_size=3, stride=2),
    "k3_d2": dict(kernel_size=3, dilation=2),
    "k1": dict(kernel_size=1),
    "k311": dict(kernel_size=(3, 1, 1)),
    "k3_st211": dict(kernel_size=3, stride=(2, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CONV))
def test_causal_conv3d_golden_through_bridge(case):
    """The reference implementation's recorded CausalConv3d outputs: its
    torch weights, put in the flax layout, round-trip through the bridge
    unchanged, and the port reproduces the recorded outputs."""
    import os

    fx = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                              "golden_reference.npz"))
    w = fx[f"conv/{case}/weight"]
    conv = tvid.CausalConv3d(2, 3, **GOLDEN_CONV[case])
    load_flax_params(conv, {"conv3d": {"kernel": w.transpose(2, 3, 4, 1, 0),
                                       "bias": fx[f"conv/{case}/bias"]}})
    np.testing.assert_array_equal(_np(conv.conv3d.weight), w)
    with torch.no_grad():
        out = conv(torch.from_numpy(fx["conv/input"].transpose(0, 2, 3, 4, 1).copy()))
    np.testing.assert_allclose(
        _np(out), fx[f"conv/{case}/out"].transpose(0, 2, 3, 4, 1), **OP_TOL
    )


@pytest.mark.parametrize("hid_dim", [None, 12])
def test_forward_block(hid_dim):
    x = _rand(1, 2, 3, 4, 4, 8)
    jmod = jmisc.ForwardBlock(
        in_dim=8, out_dim=6, hid_dim=hid_dim, block="conv3d", num_groups=2,
        use_bias=True, kernel_size=3, causal_time=True,
    )
    tmod = tmisc.ForwardBlock(8, 6, hid_dim, block="conv3d", num_groups=2, use_bias=True,
                              kernel_size=3, causal_time=True)
    params = _port(jmod, tmod, x)
    ref = jmod.apply({"params": params}, x)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **STACK_TOL)


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("rope_kind", [None, "1d", "2d"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_full(rope_kind, causal):
    x = _rand(2, 3, 9, 32)
    kw = dict(n_head=2, d_head=16, d_inp=32, causal=causal, rope_kind=rope_kind)
    jmod, tmod = jatt.Attention(**kw), tatt.Attention(**kw)
    params = _port(jmod, tmod, x)
    ref = jmod.apply({"params": params}, x)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **STACK_TOL)


def test_attention_decode_modes():
    """Decode-write matches JAX (output and written buffers); read-only
    decode matches JAX's read-only decode and the port's write decode."""
    b, heads, dh, n_max, pos = 4, 2, 16, 8, 3
    kw = dict(n_head=heads, d_head=dh, d_inp=32, causal=True, rope_kind="1d")
    jmod, tmod = jatt.Attention(**kw), tatt.Attention(**kw)
    x = _rand(3, b, 1, 32)
    params = _port(jmod, tmod, _rand(4, b, 5, 32))
    k_buf, v_buf = _rand(5, b, heads, n_max, dh), _rand(6, b, heads, n_max, dh)
    k_buf[:, :, pos:] = 0.0
    v_buf[:, :, pos:] = 0.0

    ref_w, (ref_k, ref_v) = jmod.apply(
        {"params": params}, x, kv_cache=(k_buf, v_buf), cache_pos=pos
    )
    ref_r, _ = jmod.apply(
        {"params": params}, x, kv_cache=(k_buf, v_buf), cache_pos=pos,
        cache_write=False,
    )
    with torch.no_grad():
        kt, vt = torch.from_numpy(k_buf.copy()), torch.from_numpy(v_buf.copy())
        out_r, (k_r, _) = tmod(torch.from_numpy(x), kv_cache=(kt, vt),
                               cache_pos=pos, cache_write=False)
        np.testing.assert_array_equal(_np(k_r), k_buf)  # read-only: untouched
        out_w, (k_w, v_w) = tmod(torch.from_numpy(x), kv_cache=(kt, vt), cache_pos=pos)
    np.testing.assert_allclose(_np(out_w), np.asarray(ref_w), **STACK_TOL)
    np.testing.assert_allclose(_np(k_w), np.asarray(ref_k), **STACK_TOL)
    np.testing.assert_allclose(_np(v_w), np.asarray(ref_v), **STACK_TOL)
    np.testing.assert_allclose(_np(out_r), np.asarray(ref_r), **STACK_TOL)
    np.testing.assert_allclose(_np(out_r), _np(out_w), **OP_TOL)


ST_CASES = [
    dict(n_embd=32, n_head=2, d_head=16),
    dict(d_inp=24, d_out=24, n_head=2, d_head=16),  # space_skip + ffn_skip
    dict(d_inp=32, d_out=32, n_head=(2, 4), d_head=16),  # time_skip
]


@pytest.mark.parametrize("kw", ST_CASES)
def test_space_time_attention(kw):
    """Full forward against JAX, then the port's cached decode (commit and
    read-only refine) against the JAX full forward frame by frame."""
    b, t, h, w = 2, 5, 4, 4
    c = kw.get("d_inp", kw.get("n_embd"))
    x = _rand(7, b, t, h, w, c)
    jmod, tmod = jatt.SpaceTimeAttention(**kw), tatt.SpaceTimeAttention(**kw)
    params = _port(jmod, tmod, x)
    ref = np.asarray(jmod.apply({"params": params}, x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = tmod(xt)
        np.testing.assert_allclose(_np(out), ref, **STACK_TOL)
        cache = tatt.st_attn_cache(kw, b, h, w, t, torch.float32)
        for pos in range(t):
            peek, _ = tmod(xt[:, pos: pos + 1], cache=cache, cache_pos=pos,
                           cache_write=False)
            step, cache = tmod(xt[:, pos: pos + 1], cache=cache, cache_pos=pos)
            np.testing.assert_allclose(_np(step[:, 0]), ref[:, pos], **STACK_TOL)
            np.testing.assert_allclose(_np(peek), _np(step), atol=1e-5, rtol=1e-4)


def test_st_attn_cache_layout():
    kw = dict(n_rep=2, n_embd=32, n_head=2, d_head=16)
    ref = jatt.st_attn_cache(kw, 2, 4, 4, 5, jnp.float32)
    out = tatt.st_attn_cache(kw, 2, 4, 4, 5, torch.float32)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        k: tuple(v.shape) for k, v in ref.items()
    }
    assert out["k"].shape[2] == 8  # t_max rounded up to a multiple of 8


# --------------------------------------------------- registry and data


def test_blueprints_equal_jax():
    names = [n for n in dir(jbp) if n.isupper()]
    assert names and names == [n for n in dir(tbp) if n.isupper()]
    for name in names:
        assert getattr(tbp, name) == getattr(jbp, name), name


@pytest.mark.parametrize("which", ["linear", "cosine", "arccos"])
@pytest.mark.parametrize("steps", [1, 3, 25])
def test_get_schedule(which, steps):
    np.testing.assert_array_equal(
        get_schedule(steps, (16, 16), which), jget_schedule(steps, (16, 16), which)
    )


def test_configs_equal_jax_side():
    import bench
    from tools.parity_check import GENIE_CFG

    assert genie_rollout_config() == bench._genie_cfg()
    assert genie_compact_config() == GENIE_CFG


def test_serve_config_equals_jax_side():
    import bench

    assert genie_serve_config() == bench._serve_cfg()


def test_unported_module_names_raise():
    """No name of the JAX registry is left unported: each resolves, and
    builds from a blueprint; only a name in neither registry raises."""
    from open_genie_tpu.modules import _REGISTRY as JAX_REGISTRY

    for name in JAX_REGISTRY:
        assert get_module(name).__name__ == JAX_REGISTRY[name].__name__, name
    layers, _ = parse_blueprint((("depth2space_upsample", {"in_channels": 8}),
                                 ("blur_pool", {})))
    assert [type(m).__name__ for m in layers] == ["DepthToSpaceUpsample", "BlurPooling2d"]
    with pytest.raises(ValueError, match="Unknown module name"):
        get_module("no-such-module")
    layers, ext = parse_blueprint(
        (("space-time_attn", {"n_rep": 2, "n_embd": 32, "n_head": 2, "d_head": 16}),)
    )
    assert len(layers) == 2 and ext == [False, False]
