"""Phase 28's tokenizers (`chip_smoke.alt_tokenizers`) in the PyTorch port
against the JAX package on the CPU, at their compact widths (MAGVIT2 d=18
with every width divided by 16: 8 to 32): `ALT_ENC` (blur, strided causal
edge-padded and int-`downsample` residual blocks, `space_attn` and a
causal `time_attn`) with `ALT_STREAM_DEC` (depth-to-time and depth-to-space
upsamplers) and with `ALT_TCONV_DEC` (causal transposed convs).

Token ids exactly (K2's plain twin on the port's side), pixels within
`tools/parity_check.py`'s stack bound (atol 2e-3 / rtol 2e-2); the stream
against the port's own batch decode in f32 within the JAX package's stream
pin (atol 2e-5 / rtol 1e-5); `init_stream_cache`'s shapes against JAX's
(the port's used to keep `(h, w)` past a `depth2space_upsample`);
`temporal_downsampling` against JAX's for every blueprint here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from open_genie_tpu.models import blueprints as jbp  # noqa: E402
from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer  # noqa: E402
from open_genie_tpu_torch.models.configs import (  # noqa: E402
    genie_compact_config,
    tokenizer_compact_train_config,
)
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from open_genie_tpu_torch.utils import last_out_channels  # noqa: E402
from test_torch_stream_decode import _jax_stream, _port_stream, _tokenizers  # noqa: E402

torch.set_num_threads(1)
EXACT = dict(atol=2e-5, rtol=1e-5)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)
ALT = chip_smoke.alt_tokenizers(16)
VIDEO = (1, 8, 16, 16, 3)  # two 2x2 token frames


@pytest.fixture(scope="module", params=["stream", "tconv"])
def alt_pair(request):
    jm, tm, params = _tokenizers(ALT[request.param], t=VIDEO[1], hw=VIDEO[2], seed=3)
    return request.param, jm, tm, params


def test_round_trip_matches_jax(alt_pair):
    """Tokenize -> decode: the encoder's attentions at d_inp 32, its blur
    and strided downsamples; ids exact, pixels within the stack bound."""
    kind, jm, tm, params = alt_pair
    video = np.random.default_rng(4).uniform(size=VIDEO).astype(np.float32)
    enc = jm.apply({"params": params}, video, method=JTokenizer.encode)
    # No sign decided by rounding (chip_smoke.LFQ_UNDECIDED).
    assert np.abs(np.asarray(enc)).min() > chip_smoke.LFQ_UNDECIDED
    jq, jidx = jm.apply({"params": params}, video, method=JTokenizer.tokenize)
    jrec = jm.apply({"params": params}, jidx, method=JTokenizer.decode_tokens)
    q, idx = tm.tokenize(torch.from_numpy(video))
    assert tm.head_fusable() and tuple(idx.shape) == (1, 2, 2, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    rec = tm.decode_tokens(idx)
    assert tuple(rec.shape) == VIDEO
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **STACK_TOL)


def test_stream_decode_matches_batch_and_jax(alt_pair):
    """`ALT_STREAM_DEC` streams (JAX agrees) and `ALT_TCONV_DEC` does not;
    the stream's states have JAX's shapes, its frames JAX's stream's and
    the port's batch decode's, 4 pixel frames per token frame."""
    kind, jm, tm, params = alt_pair
    assert tm.stream_decodable() == jm.stream_decodable() == (kind == "stream")
    if kind != "stream":
        return
    idxs = np.random.default_rng(5).integers(0, 2 ** 18, (1, 2, 2, 2)).astype(np.int32)
    jcache = jm.apply({"params": params}, 1, 2, 2, 2, method=JTokenizer.init_stream_cache)
    tcache = tm.init_stream_cache(1, 2, 2, 2)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jcache)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), tcache)
    frames = _port_stream(tm, torch.from_numpy(idxs))
    assert [tuple(f.shape) for f in frames] == [(1, 4, 16, 16, 3)] * 2
    for got, want in zip(frames, _jax_stream(jm, params, idxs)):
        np.testing.assert_allclose(got.numpy(), want, **STACK_TOL)
    batch = tm.decode_tokens(torch.from_numpy(idxs))
    np.testing.assert_allclose(torch.cat(frames, 1).numpy(), batch.numpy(), **EXACT)


def test_temporal_downsampling_matches_jax():
    """The ALT encoder's residual blocks carry no time factor in JAX (4
    input frames still make one token frame), and the port keeps that;
    every other encoder in the repo's configs and blueprints agrees too."""
    encoders = [ALT["stream"]["enc_desc"], chip_smoke.alt_encoder(jbp.MAGVIT2_ENC_DESC),
                jbp.MAGVIT2_ENC_DESC, jbp.REPR_TOK_ENC, jbp.LATENT_ACT_ENC,
                tokenizer_compact_train_config()["tokenizer"]["enc_desc"],
                genie_compact_config()["tokenizer"]["enc_desc"]]
    got = []
    for enc in encoders:
        dec = (("causal-conv3d", {"in_channels": last_out_channels(enc), "out_channels": 3,
                                  "kernel_size": 1}),)
        with torch.device("meta"):
            port = VideoTokenizer(enc_desc=enc, dec_desc=dec).temporal_downsampling
        assert port == JTokenizer(enc_desc=enc, dec_desc=dec).temporal_downsampling, enc
        got.append(port)
    assert got[:3] == [1, 1, 4]
