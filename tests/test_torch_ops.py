"""PyTorch port ops against their JAX counterparts on the CPU.

Same inputs (numpy, fixed seed) through both. Tolerances: single ops in
f32 agree to atol 1e-5 / rtol 1e-4 (one op, different but equally exact
summation orders); integer ids and sign codes are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.ops import attention as jattn  # noqa: E402
from open_genie_tpu.ops import conv as jconv  # noqa: E402
from open_genie_tpu.ops import lfq as jlfq  # noqa: E402
from open_genie_tpu.ops import resample as jres  # noqa: E402
from open_genie_tpu.ops import rope as jrope  # noqa: E402
from open_genie_tpu.ops.pallas.flash_attention import _flash_forward  # noqa: E402
from open_genie_tpu.ops.pallas.lfq_head import lfq_head as jlfq_head  # noqa: E402
from open_genie_tpu_torch.ops import attention as tattn  # noqa: E402
from open_genie_tpu_torch.ops import conv as tconv  # noqa: E402
from open_genie_tpu_torch.ops import lfq as tlfq  # noqa: E402
from open_genie_tpu_torch.ops import resample as tres  # noqa: E402
from open_genie_tpu_torch.ops import rope as trope  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head, lfq_head_plain  # noqa: E402

torch.set_num_threads(1)
OP_TOL = dict(atol=1e-5, rtol=1e-4)  # one f32 op, different summation order


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize(
    "kernel,stride,dilation",
    [
        ((3, 3, 3), 1, 1),
        ((1, 1, 1), 1, 1),
        ((3, 3, 3), (1, 4, 4), 1),
        ((3, 3, 3), (2, 2, 2), 1),
        ((2, 3, 1), 1, (2, 1, 1)),
    ],
)
def test_causal_conv3d(kernel, stride, dilation):
    x = _rand(0, 2, 5, 8, 8, 3)
    k = _rand(1, *kernel, 3, 4) * 0.3
    b = _rand(2, 4)
    ref = jconv.causal_conv3d(x, k, b, stride=stride, dilation=dilation)
    out = tconv.causal_conv3d(
        torch.from_numpy(x), torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()),
        torch.from_numpy(b), stride=stride, dilation=dilation,
    )
    np.testing.assert_allclose(_np(out), np.asarray(ref), **OP_TOL)


def test_causal_time_pad():
    for args in [(3, 1, 1), (3, 2, 1), (1, 1, 1), (4, 1, 2)]:
        assert tconv.causal_time_pad(*args) == jconv.causal_time_pad(*args)


def test_depth_to_spacetime():
    x = _rand(3, 2, 3, 4, 5, 3 * 2 * 4 * 4)
    ref = jres.depth_to_spacetime(x, 2, 4)
    out = tres.depth_to_spacetime(torch.from_numpy(x), 2, 4)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("offset", [0, 5])
def test_rope(kind, offset):
    dim = 32
    np.testing.assert_allclose(
        trope.rope_frequencies(dim, kind), np.asarray(jrope.rope_frequencies(dim, kind)),
        **OP_TOL,
    )
    seq = _rand(4, 3, 16, dim)
    freq = jrope.rope_frequencies(dim, kind)
    ref = jrope.apply_rope(seq, freq, offset=offset)
    out = trope.apply_rope(
        torch.from_numpy(seq), torch.from_numpy(trope.rope_frequencies(dim, kind)),
        offset=offset,
    )
    np.testing.assert_allclose(_np(out), np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize(
    "nq,nk,causal,masked",
    [(16, 16, False, False), (16, 16, True, False), (4, 16, True, False),
     (1, 8, False, True), (16, 16, False, True)],
)
def test_plain_attention(nq, nk, causal, masked):
    q, k, v = _rand(5, 2, 3, nq, 16), _rand(6, 2, 3, nk, 16), _rand(7, 2, 3, nk, 16)
    mask = None
    if masked:
        mask = np.random.default_rng(8).uniform(size=(2, 1, nq, nk)) > 0.3
        mask[..., 0] = True  # keep every row attendable
    ref = jattn._xla_attention(q, k, v, 0.25, causal=causal, mask=mask)
    out = tattn._plain_attention(
        *map(torch.from_numpy, (q, k, v)), 0.25, causal=causal,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(_np(out), np.asarray(ref), **OP_TOL)


def test_dot_product_attention_dispatch_matches_plain():
    """The unmasked nq == nk route (flash wrapper) and the plain path agree."""
    q, k, v = (torch.from_numpy(_rand(s, 2, 3, 17, 16)) for s in (9, 10, 11))
    for causal in (False, True):
        np.testing.assert_allclose(
            _np(tattn.dot_product_attention(q, k, v, causal=causal)),
            _np(tattn._plain_attention(q, k, v, 0.25, causal=causal)), **OP_TOL,
        )


def _pallas_flash(q, k, v, scale, causal):
    """`_flash_forward` in interpret mode, padded to its block grid the way
    its wrapper `flash_attention` pads (it returns `o` only)."""
    bh, n, _ = q.shape
    blk = min(512, -(-n // 128) * 128)
    n_pad = -(-n // blk) * blk
    pad = lambda t: jnp.pad(t, ((0, 0), (0, n_pad - n), (0, 0)))  # noqa: E731
    o, lse = _flash_forward(
        pad(q), pad(k), pad(v), scale, causal, blk, blk, True,
        kv_len=n if n_pad != n else 0,
    )
    return np.asarray(o[:, :n]), np.asarray(lse[:, :n, 0])


@pytest.mark.parametrize("n", [1, 17, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_plain_matches_pallas(n, causal, d):
    q, k, v = _rand(12, 2, n, d), _rand(13, 2, n, d), _rand(14, 2, n, d)
    scale = d ** -0.5
    o_ref, lse_ref = _pallas_flash(q, k, v, scale, causal)
    o, lse = flash_attention(*map(torch.from_numpy, (q, k, v)), scale, causal)
    o_plain, _ = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), scale, causal)
    np.testing.assert_array_equal(_np(o), _np(o_plain))  # CPU routes to the twin
    np.testing.assert_allclose(_np(o), o_ref, **OP_TOL)
    np.testing.assert_allclose(_np(lse), lse_ref, **OP_TOL)


def test_lfq_head_plain_matches_pallas():
    n, c, d = 1000, 32, 10
    x, w, b = _rand(15, n, c), _rand(16, c, d) * 0.2, _rand(17, d) * 0.1
    codes_ref, idx_ref = jlfq_head(x, w, b, block=256, interpret=True)
    codes, idx = lfq_head(*map(torch.from_numpy, (x, w, b)))
    z = x @ w + b
    # A sign decided by rounding (|z| at f32 rounding level) may differ
    # between summation orders; everything else is exact.
    decided = np.abs(z) >= 1e-5
    assert decided.all(axis=1).mean() > 0.99
    np.testing.assert_array_equal(_np(codes)[decided], np.asarray(codes_ref)[decided])
    rows = decided.all(axis=1)
    np.testing.assert_array_equal(idx.numpy()[rows], np.asarray(idx_ref)[rows])
    assert idx.dtype == torch.int32
    codes_p, idx_p = lfq_head_plain(*map(torch.from_numpy, (x, w, b)))
    assert torch.equal(codes, codes_p) and torch.equal(idx, idx_p)


def test_lfq_quantize_and_codebook():
    x = _rand(18, 4, 7, 10)
    x[0, 0, :3] = 0.0  # exact zeros quantize to -1 (x > 0 decides)
    quant_ref, idx_ref = jlfq.lfq_quantize(x, 10, training=False)
    quant, idx = tlfq.lfq_quantize(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(_np(quant), np.asarray(quant_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    ids = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        _np(tlfq.codebook_entries(torch.from_numpy(ids), 10)),
        np.asarray(jlfq.codebook_entries(ids, 10)),
    )
    np.testing.assert_array_equal(
        tlfq.bit_mask(10).numpy(), np.asarray(jlfq.bit_mask(10))
    )
