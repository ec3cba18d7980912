"""Gradients of the port's flash attention on the CPU.

`FlashAttention` (the plain twins of K1, K3 and K4 on a CPU tensor) against
`jax.grad` of the JAX package's Pallas flash attention in interpret mode,
on the same numpy inputs, at the sequence lengths and head dims that the
tensor-core kernels' tiles treat differently; the plain backward against
torch autograd of the plain forward; and the choice of K1's, K3's and K4's
variant from the dtype. Tolerances: f32 atol 1e-5 / rtol 1e-4 (the same math in
another order); bf16 atol/rtol 2e-2 (rounding of p, ds and the outputs to
bf16 at slightly different places in the two programs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.ops.pallas.flash_attention import flash_attention as jflash  # noqa: E402
from open_genie_tpu_torch.modules.attention import Attention  # noqa: E402
from open_genie_tpu_torch.ops.attention import dot_product_attention  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    VARIANTS,
    FlashAttention,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_variant,
)

torch.set_num_threads(1)
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _inputs(seed, b, h, n, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4)]


def _port_grads(q, k, v, w, causal, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = dot_product_attention(*ts, causal=causal)
    assert isinstance(out.grad_fn.next_functions[0][0], FlashAttention._backward_cls)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out, [t.grad for t in ts]


def _jax_grads(q, k, v, w, causal, dtype):
    def loss(q, k, v):
        o = jflash(q, k, v, causal=causal, interpret=True)
        return (o.astype(jnp.float32) * w).sum(), o

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return out, grads


@pytest.mark.parametrize("n", [5, 64, 130])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_pallas_f32(n, d, causal):
    q, k, v, w = _inputs(n + d, 2, 2, n, d)
    out, grads = _port_grads(q, k, v, w, causal, torch.float32)
    ref_out, ref = _jax_grads(q, k, v, w, causal, jnp.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **F32_TOL)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)


# The sequence lengths and head dims that the tensor-core kernels' tiles
# treat differently: one row, a partial 16-row chunk, exactly one chunk, one
# past it, one 64-row tile, one past it, two tiles and a ragged third; every
# head dim. Each (N, D) pair once; causal and dtype alternate so that every
# N and every D meets both masks and both dtypes.
_NS, _DS = (1, 5, 16, 17, 64, 65, 130), (16, 32, 64, 128)
TILE_SHAPES = [
    (n, d, (a + b) % 2 == 0, "bf16" if (a + b // 2) % 2 else "f32")
    for a, n in enumerate(_NS) for b, d in enumerate(_DS)
]


@pytest.mark.parametrize("n,d,causal,dtype", TILE_SHAPES)
def test_plain_twins_match_pallas_at_tile_edges(n, d, causal, dtype):
    """The plain twins of K1, K3 and K4 (forward and every gradient through
    `FlashAttention`) against `jax.grad` of the Pallas kernels in interpret
    mode, on the same inputs, at B*H = 2."""
    q, k, v, w = _inputs(1000 + 10 * n + d, 1, 2, n, d)
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL) if dtype == "f32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    out, grads = _port_grads(q, k, v, w, causal, tdt)
    ref_out, ref = _jax_grads(q, k, v, w, causal, jdt)
    assert out.dtype == tdt and all(g.dtype == tdt for g in grads)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref_out, np.float32), **tol)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), **tol)


def test_variant_follows_dtype_for_every_head_dim():
    """bf16 takes the tensor-core variant of K1, K3 and K4, f32 the
    CUDA-core one, at every head dim; anything else raises before a
    launch."""
    for d in HEAD_DIMS:
        assert flash_variant(torch.bfloat16, d) == "mma"
        assert flash_variant(torch.float32, d) == "simt"
    for d in (8, 48, 256):
        with pytest.raises(ValueError, match="head dim"):
            flash_variant(torch.bfloat16, d)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_variant(torch.float16, 64)
    assert set(VARIANTS) == {"mma", "simt"}
    for fn in (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq):
        assert set(fn.launches_by_variant) == set(VARIANTS)


def test_flash_grads_match_pallas_bf16():
    q, k, v, w = _inputs(7, 2, 2, 64, 16)
    out, grads = _port_grads(q, k, v, w, True, torch.bfloat16)
    ref_out, ref = _jax_grads(q, k, v, w, True, jnp.bfloat16)
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref_out, np.float32), **BF16_TOL)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), **BF16_TOL)


@pytest.mark.parametrize("bh,n,d,causal", [(3, 1, 16, True), (2, 37, 32, False),
                                           (4, 70, 64, True)])
def test_plain_backward_matches_autograd(bh, n, d, causal):
    """The explicit formula against torch autograd of the plain forward."""
    g = torch.Generator().manual_seed(n)
    q, k, v, do = (torch.randn(bh, n, d, generator=g) for _ in range(4))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_plain(qa, ka, va, d ** -0.5, causal)
    o.backward(do)
    got = flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do, d ** -0.5, causal)
    for a, t in zip(got, (qa, ka, va)):
        torch.testing.assert_close(a, t.grad, **F32_TOL)


def test_attention_projections_get_gradients():
    """Every projection of a self- and a cross-attention module receives a
    nonzero gradient through the flash path, and without a gradient wanted
    the flash path builds no graph."""
    g = torch.Generator().manual_seed(0)
    for attn, kw in ((Attention(2, 16, 24, causal=True), {}),
                     (Attention(2, 16, 24, key_dim=8, causal=True),
                      {"key": torch.randn(3, 6, 8, generator=g)})):
        x = torch.randn(3, 6, 24, generator=g)
        attn(x, **kw).square().sum().backward()
        for name, p in attn.named_parameters():
            assert p.grad is not None and p.grad.abs().sum() > 0, name
        with torch.no_grad():
            assert attn(x, **kw).grad_fn is None
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with torch.no_grad():
        assert dot_product_attention(q, q, q).grad_fn is None


def test_backward_kernel_wrappers_need_cuda():
    """The K3 and K4 wrappers launch only on CUDA tensors: a CPU tensor
    raises instead of running a plain twin, as does a device without the
    kernel."""
    q = torch.zeros(2, 8, 16)
    stats = torch.zeros(2, 8)
    for fn in (flash_attention_bwd_dkv, flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(q, q, q, q, stats, stats, 0.25)
        m = torch.empty(2, 8, 16, device="meta")
        ms = torch.empty(2, 8, device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(m, m, m, m, ms, ms, 0.25)
    with pytest.raises(ValueError, match="contiguous dO"):
        flash_attention_bwd_dkv(q, q, q, q.transpose(0, 1).contiguous().transpose(0, 1),
                                stats, stats, 0.25)
    o, lse = flash_attention(q, q, q, 0.25)
    assert o.shape == q.shape and lse.shape == stats.shape


_BAD_BWD_INPUTS = {
    "dO of another shape": ({"do": torch.zeros(2, 8, 32, dtype=torch.bfloat16)}, "contiguous dO"),
    "bf16 lse": ({"lse": torch.zeros(2, 8, dtype=torch.bfloat16)}, r"f32 \(BH, N\)"),
    "strided delta": ({"delta": torch.zeros(8, 2).t()}, r"f32 \(BH, N\)"),
    "lse on another device": ({"lse": torch.zeros(2, 8, device="meta")}, "different devices"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_BWD_INPUTS))
def test_backward_wrappers_refuse_bad_inputs_before_any_launch(bad):
    """K3 and K4 take a dO like q and contiguous f32 (BH, N) lse and delta
    on q's device: anything else raises before the device is looked at and
    counts no launch."""
    q = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    change, match = _BAD_BWD_INPUTS[bad]
    args = {"do": q, "lse": torch.zeros(2, 8), "delta": torch.zeros(2, 8), **change}
    for fn in (flash_attention_bwd_dkv, flash_attention_bwd_dq):
        before = fn.launches
        with pytest.raises(ValueError, match=match):
            fn(q, q, q, args["do"], args["lse"], args["delta"], 0.25)
        assert fn.launches == before
