"""The port's streaming pixel decode against the JAX package on the CPU.

`VideoTokenizer.decode_stream` decodes one token frame a call against
per-layer states. Every streamable layer is strictly time-causal, so the
stream equals the batch `decode_tokens` within f32 rounding (atol 2e-5 /
rtol 1e-5, the JAX package's own pin in `tests/test_stream_decode.py`), and
the port's stream equals JAX's `decode_stream` frame by frame within the
same bound. Weights come from the JAX models through `bridge.py`; the
adaptive norms' condition heads are set to random values first (their init
ignores the condition). Also here: the modules' streaming paths one by one,
the per-frame adaptive norm on one token frame of condition for 4 pixel
frames, `stream_decodable` on the JAX package's blueprints, `quantize`, and
the MAGVIT2 d=18 tokenize -> decode round trip with the `magvit2_stream`
decoder (`genie_serve_config()`'s tokenizer) at 1/16 of its widths here
and in full under the `slow` marker.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from open_genie_tpu.models import blueprints as jbp  # noqa: E402
from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer  # noqa: E402
from open_genie_tpu.modules import norm as jnorm  # noqa: E402
from open_genie_tpu.modules import video as jvideo  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.models.configs import genie_serve_config  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from open_genie_tpu_torch.modules import norm as tnorm  # noqa: E402
from open_genie_tpu_torch.modules import video as tvideo  # noqa: E402
from test_stream_decode import TOK_KW, TOK_RES_KW, TOK_TF2_KW  # noqa: E402

torch.set_num_threads(1)
EXACT = dict(atol=2e-5, rtol=1e-5)  # stream vs batch, f32
STACK_TOL = dict(atol=2e-3, rtol=2e-2)  # parity_check.py's bound for stacks
KEY = jax.random.PRNGKey(0)


def _randomize_cond_heads(params, seed):
    """The adaptive norms' `std`/`avg` heads at random values, so that the
    condition moves the output."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for path, val in flat.items():
        if any(p in ("std", "avg") for p in path):
            flat[path] = (0.3 * rng.standard_normal(val.shape)).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def _tokenizers(kw, t, hw, seed=0):
    jm, tm = JTokenizer(**kw), VideoTokenizer(**kw).eval()
    video = jnp.zeros((1, t, hw, hw, 3), jnp.float32)
    params = jax.jit(lambda k: jm.init(k, video))(jax.random.PRNGKey(seed))["params"]
    params = _randomize_cond_heads(params, seed)
    load_flax_params(tm, params)
    return jm, tm, params


def _jax_stream(jm, params, idxs):
    """JAX's `decode_stream` frame by frame: a list of `(B, tf, H, W, C)`."""
    b, t, h, w = idxs.shape
    cache = jm.apply({"params": params}, b, h, w, t, method=JTokenizer.init_stream_cache)
    step = jax.jit(lambda p, f, c, pos: jm.apply(
        {"params": p}, f, c, pos, method=JTokenizer.decode_stream))
    outs = []
    for pos in range(t):
        pix, cache = step(params, idxs[:, pos], cache, jnp.asarray(pos))
        outs.append(np.asarray(pix))
    return outs


def _port_stream(tm, idxs):
    b, t, h, w = idxs.shape
    cache = tm.init_stream_cache(b, h, w, t)
    return [tm.decode_stream(idxs[:, pos], cache, pos)[0] for pos in range(t)]


@pytest.mark.parametrize("kw", [TOK_KW, TOK_TF2_KW, TOK_RES_KW], ids=["tf1", "tf2", "residual"])
def test_stream_matches_batch_and_jax(kw):
    """The three decoders of the JAX pins: the port's stream against its own
    batch decode, and frame by frame against JAX's stream."""
    jm, tm, params = _tokenizers(kw, t=4, hw=16)
    idxs = np.random.default_rng(1).integers(0, 2 ** 5, (1, 4, 4, 4)).astype(np.int32)
    batch = tm.decode_tokens(torch.from_numpy(idxs))
    frames = _port_stream(tm, torch.from_numpy(idxs))
    stream = torch.cat(frames, dim=1)
    assert stream.shape == batch.shape
    np.testing.assert_allclose(stream.numpy(), batch.numpy(), **EXACT)
    for got, want in zip(frames, _jax_stream(jm, params, idxs)):
        np.testing.assert_allclose(got.numpy(), want, **EXACT)
    ref = jm.apply({"params": params}, idxs, method=JTokenizer.decode_tokens)
    np.testing.assert_allclose(batch.numpy(), np.asarray(ref), **EXACT)


def _module_case(kind):
    """(JAX module, port module, input width) of one streaming module."""
    if kind == "conv":
        kw = dict(in_channels=6, out_channels=8, kernel_size=3, dilation=(2, 1, 1))
        return jvideo.CausalConv3d(**kw), tvideo.CausalConv3d(**kw), 6
    if kind == "depth2spacetime":
        kw = dict(in_channels=6, out_channels=4, kernel_size=3, time_factor=2, space_factor=2)
        return jvideo.DepthToSpaceTimeUpsample(**kw), tvideo.DepthToSpaceTimeUpsample(**kw), 6
    kw = dict(in_channels=6, out_channels=8, num_groups=2, use_causal=True,
              per_frame_norm=kind == "residual")
    if kind == "residual_no_norm":
        kw["use_norm"] = False
    return jvideo.VideoResidualBlock(**kw), tvideo.VideoResidualBlock(**kw), 6


def _zero_cache(jmod, tmod, x):
    tp = tmod.stream_state_len()
    assert tp == jmod.stream_state_len()
    win = lambda c: np.zeros((x.shape[0], tp, *x.shape[2:4], c), np.float32)  # noqa: E731
    if isinstance(tmod, tvideo.VideoResidualBlock):
        return {"conv1": win(x.shape[-1]), "conv2": win(8)}
    return win(x.shape[-1])


@pytest.mark.parametrize("kind", ["conv", "depth2spacetime", "residual", "residual_no_norm"])
def test_module_stream_matches_jax(kind):
    """Each streaming module fed 5 frames as chunks of 2, 1 and 2: its
    outputs and its windows against JAX's, and its outputs against its own
    full forward."""
    jmod, tmod, c = _module_case(kind)
    x = np.random.default_rng(2).standard_normal((2, 5, 4, 4, c)).astype(np.float32)
    params = jax.jit(lambda k: jmod.init(k, x))(KEY)["params"]
    load_flax_params(tmod, jax.tree.map(np.asarray, params))
    jcache = _zero_cache(jmod, tmod, x)
    tcache = jax.tree.map(torch.from_numpy, jcache)
    outs = []
    for lo, hi in ((0, 2), (2, 3), (3, 5)):
        ref, jcache = jmod.apply({"params": params}, x[:, lo:hi], cache=jcache)
        with torch.no_grad():
            out, tcache = tmod(torch.from_numpy(x[:, lo:hi]), cache=tcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EXACT)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), **EXACT),
                     tcache, jcache)
        outs.append(out)
    with torch.no_grad():
        full = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), **EXACT)


def test_stream_refuses_what_is_not_causal():
    with torch.no_grad():
        block = tvideo.VideoResidualBlock(4, use_causal=True)  # time-pooled GroupNorm
        cache = {"conv1": torch.zeros(1, 2, 2, 2, 4), "conv2": torch.zeros(1, 2, 2, 2, 4)}
        with pytest.raises(AssertionError, match="per_frame_norm"):
            block(torch.zeros(1, 1, 2, 2, 4), cache=cache)
        strided = tvideo.CausalConv3d(4, 4, stride=(2, 1, 1))
        with pytest.raises(AssertionError, match="time stride 1"):
            strided(torch.zeros(1, 2, 2, 2, 4), cache=torch.zeros(1, 1, 2, 2, 4))


def test_per_frame_adaptive_norm_one_token_frame_for_four_pixel_frames():
    """After both time upsamples of the MAGVIT2 decoder, one token frame of
    condition meets 4 pixel frames; a 2-token-frame condition meets 8."""
    kw = dict(dim_cond=5, num_groups=2, num_channels=8, per_frame=True)
    jmod, tmod = jnorm.AdaptiveGroupNorm(**kw), tnorm.AdaptiveGroupNorm(**kw)
    rng = np.random.default_rng(3)
    for t_c in (1, 2):
        x = rng.standard_normal((2, 4 * t_c, 4, 4, 8)).astype(np.float32)
        cond = rng.standard_normal((2, t_c, 2, 2, 5)).astype(np.float32)
        params = jax.jit(lambda k: jmod.init(k, x, cond))(KEY)["params"]
        params = _randomize_cond_heads(params, t_c)
        load_flax_params(tmod, params)
        with torch.no_grad():
            out = tmod(torch.from_numpy(x), torch.from_numpy(cond))
        ref = jmod.apply({"params": params}, x, cond)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EXACT)
    gkw = dict(num_groups=2, num_channels=8, per_frame=True)
    jgn, tgn = jnorm.GroupNorm(**gkw), tnorm.GroupNorm(**gkw)
    params = jax.jit(lambda k: jgn.init(k, x))(KEY)["params"]
    load_flax_params(tgn, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        frame = tgn(torch.from_numpy(x[:, :1]))
    np.testing.assert_allclose(frame.numpy(), np.asarray(jgn.apply({"params": params}, x)[:, :1]),
                               **EXACT)


_ATTN_AFTER_TF = dict(TOK_TF2_KW, dec_desc=TOK_TF2_KW["dec_desc"] + (
    ("space-time_attn", {"n_embd": 3, "n_head": 1, "d_head": 3}),))
_DECODABLE_CASES = {
    "tf1": TOK_KW,
    "tf2": TOK_TF2_KW,
    "residual": TOK_RES_KW,
    "magvit2": dict(enc_desc=jbp.MAGVIT2_ENC_DESC, dec_desc=jbp.MAGVIT2_DEC_DESC, d_codebook=18),
    "magvit2_stream": dict(enc_desc=jbp.MAGVIT2_ENC_DESC, dec_desc=jbp.MAGVIT2_STREAM_DEC_DESC,
                           d_codebook=18),
    "attn_after_time_upsample": _ATTN_AFTER_TF,
}


@pytest.mark.parametrize("case", list(_DECODABLE_CASES))
def test_stream_decodable_matches_jax(case):
    """The blueprints of the JAX package's static checks (built on the meta
    device: no weights are needed to answer)."""
    kw = _DECODABLE_CASES[case]
    with torch.device("meta"):
        tm = VideoTokenizer(**kw)
    assert tm.stream_decodable() == JTokenizer(**kw).stream_decodable()
    assert tm.stream_decodable() == (case not in ("magvit2", "attn_after_time_upsample"))


def test_quantize_matches_jax():
    jm, tm, params = _tokenizers(TOK_RES_KW, t=4, hw=16)
    enc = np.random.default_rng(4).standard_normal((2, 2, 4, 4, 5)).astype(np.float32)
    (jq, jidx), jloss, _ = jm.apply({"params": params}, enc, method=JTokenizer.quantize)
    with torch.no_grad():
        (q, idx), loss, aux = tm.quantize(torch.from_numpy(enc))
    assert loss is None and jloss is None and aux == {}
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def _magvit2_stream_tokenizer(div):
    """`genie_serve_config()`'s tokenizer with every width but the
    codebook's (18) and the pixels' (3) divided by `div`."""
    keep = {3, 18}

    def scale(desc):
        out = []
        for name, kw in desc:
            kw = {k: (v // div if k in ("in_channels", "out_channels", "num_channels")
                      and v not in keep else v) for k, v in kw.items()}
            out.append((name, kw))
        return tuple(out)

    tok = genie_serve_config()["tokenizer"]
    return dict(tok, enc_desc=scale(tok["enc_desc"]), dec_desc=scale(tok["dec_desc"]))


_DIVS = [pytest.param(16, id="width_div16"), pytest.param(1, id="full", marks=pytest.mark.slow)]


@pytest.mark.parametrize("div", _DIVS)
def test_magvit2_stream_round_trip_matches_jax(div):
    """Tokenize -> decode of a (1, 4, 64, 64, 3) clip (one 8x8 token frame):
    token ids exact (K2's plain twin on the port's side), pixels within the
    stack bound."""
    kw = _magvit2_stream_tokenizer(div)
    jm, tm, params = _tokenizers(kw, t=4, hw=64, seed=5)
    video = np.random.default_rng(6).uniform(size=(1, 4, 64, 64, 3)).astype(np.float32)
    jq, jidx = jm.apply({"params": params}, video, method=JTokenizer.tokenize)
    jrec = jm.apply({"params": params}, jidx, method=JTokenizer.decode_tokens)
    q, idx = tm.tokenize(torch.from_numpy(video))
    rec = tm.decode_tokens(idx)
    assert tuple(idx.shape) == (1, 1, 8, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert tuple(rec.shape) == (1, 4, 64, 64, 3)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **STACK_TOL)


@pytest.mark.parametrize("div", _DIVS)
def test_magvit2_stream_decode_matches_jax(div):
    """Two token frames streamed through the `magvit2_stream` decoder (4
    pixel frames each): against JAX's stream frame by frame (stack bound),
    and against the port's own batch decode (f32, exact bound)."""
    kw = _magvit2_stream_tokenizer(div)
    jm, tm, params = _tokenizers(kw, t=4, hw=64, seed=7)
    idxs = np.random.default_rng(8).integers(0, 2 ** 18, (1, 2, 8, 8)).astype(np.int32)
    frames = _port_stream(tm, torch.from_numpy(idxs))
    assert [tuple(f.shape) for f in frames] == [(1, 4, 64, 64, 3)] * 2
    for got, want in zip(frames, _jax_stream(jm, params, idxs)):
        np.testing.assert_allclose(got.numpy(), want, **STACK_TOL)
    batch = tm.decode_tokens(torch.from_numpy(idxs))
    np.testing.assert_allclose(torch.cat(frames, dim=1).numpy(), batch.numpy(), **EXACT)
