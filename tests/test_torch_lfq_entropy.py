"""The LFQ diversity entropy above 4096 codes (kernels K5/K6 and their
plain twins) and the LFQ loss, against the JAX package on the CPU.

The oracles are the Pallas kernels in interpret mode
(`lfq_avg_entropy_pallas`, its `_avg_probs_fwd` and its `jax.grad`) and the
JAX `lfq_loss`. The port forms each codeword's log-probability as a sum of
non-positive terms, so it carries no cancellation error; the Pallas kernel
subtracts two f32 numbers of about `2 beta sum|x|`. At beta = 100 and |x|
about 3 that leaves the Pallas `q` up to 8.6e-4 of max q away from a
float64 evaluation (the port: 3e-8). Tolerances: `q` and H within 1e-3
relative (`q` relative to its largest entry); the gradient within atol
2e-4 / rtol 2e-2 at beta = 5 and at cosine above 0.999 at beta = 100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from open_genie_tpu.ops import lfq as jlfq  # noqa: E402
from open_genie_tpu.ops.pallas.lfq_entropy import (  # noqa: E402
    _avg_probs_fwd,
    _grad_x,
    lfq_avg_entropy_pallas,
)
from open_genie_tpu_torch.ops import lfq as tlfq  # noqa: E402
from open_genie_tpu_torch.ops.kernels.lfq_entropy import (  # noqa: E402
    LfqAvgEntropy,
    avg_probs_plain,
    entropy_grad_plain,
    grad_splits,
    lfq_avg_probs,
    lfq_entropy_grad,
    token_terms,
)

torch.set_num_threads(1)
EPS = 1e-6
# (n, d, beta, scale): the cases of tests/test_lfq_pallas.py.
CASES = [(64, 8, 5.0, 0.2), (33, 8, 5.0, 0.1), (128, 13, 100.0, 1.0), (128, 13, 100.0, 3.0)]


def _x(n, d, scale, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, d)) * scale).astype(np.float32)


def _pallas(x, beta):
    chunk = min(4096, 2 ** x.shape[1])
    return lambda v: lfq_avg_entropy_pallas(v, beta, EPS, 32, chunk, True)


@pytest.mark.parametrize("n,d,beta,scale", CASES)
def test_avg_probs_twin_matches_pallas_elementwise(n, d, beta, scale):
    """q codeword by codeword (a reversed bit order would permute q and
    leave H unchanged), and H."""
    x = _x(n, d, scale)
    q_ref = np.asarray(_avg_probs_fwd(jnp.asarray(x), beta, 32, min(4096, 2 ** d), True))
    q = lfq_avg_probs(torch.from_numpy(x), beta).numpy()
    assert np.abs(q - q_ref).max() <= 1e-3 * q_ref.max()
    assert np.argmax(q) == np.argmax(q_ref)
    h_ref = float(_pallas(x, beta)(jnp.asarray(x)))
    h = float(LfqAvgEntropy.apply(torch.from_numpy(x), beta, EPS))
    np.testing.assert_allclose(h, h_ref, rtol=1e-3)
    assert h >= 0.0


@pytest.mark.parametrize("n,d,beta,scale", CASES)
def test_entropy_gradient_matches_pallas(n, d, beta, scale):
    x = _x(n, d, scale, seed=1)
    g_ref = np.asarray(jax.grad(_pallas(x, beta))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    LfqAvgEntropy.apply(xt, beta, EPS).backward()
    g = xt.grad.numpy()
    assert np.isfinite(g).all()
    cos = float((g * g_ref).sum() / (np.linalg.norm(g) * np.linalg.norm(g_ref)))
    assert cos > 0.999, cos
    if beta == 5.0:
        np.testing.assert_allclose(g, g_ref, atol=2e-4, rtol=2e-2)


def test_entropy_grad_twin_matches_pallas_bwd_kernel():
    """K6's twin against `_grad_x` on the same code weights, and the
    Function's gradient scaled by the incoming gradient, in x's dtype."""
    x = _x(96, 13, 0.3, seed=2)
    q = np.asarray(_avg_probs_fwd(jnp.asarray(x), 5.0, 32, 4096, True))
    w = np.where(q > EPS, 1.0 + np.log(np.maximum(q, EPS)), np.log(EPS)).astype(np.float32)
    ref = np.asarray(_grad_x(jnp.asarray(x), jnp.asarray(w), 5.0, 32, 4096, True))
    got = lfq_entropy_grad(torch.from_numpy(x), torch.from_numpy(w), 5.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=1e-3)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    (3.0 * LfqAvgEntropy.apply(xb, 5.0, EPS)).backward()
    assert xb.grad.dtype == torch.bfloat16
    one = torch.from_numpy(x).bfloat16().float().requires_grad_()
    LfqAvgEntropy.apply(one, 5.0, EPS).backward()
    torch.testing.assert_close(xb.grad.float(), (3.0 * one.grad).bfloat16().float())


def test_token_terms_give_the_log_normalizer():
    x = _x(40, 13, 2.0, seed=3)
    pos, two_abs, rest = token_terms(torch.from_numpy(x), 100.0)
    log_z = (two_abs / 2).sum(-1) + rest
    np.testing.assert_allclose(log_z.numpy(), np.asarray(jlfq._log_normalizer(jnp.asarray(x), 100.0)),
                               rtol=1e-6)
    assert torch.equal(pos, torch.from_numpy(x > 0))


def test_dispatch_by_device():
    """Above 4096 codes `lfq_avg_entropy` streams through `LfqAvgEntropy`
    (the plain twins on a CPU tensor); a meta tensor has no kernel."""
    x = _x(50, 13, 0.5, seed=4)
    ref = float(jlfq._lfq_avg_entropy_chunked(jnp.asarray(x), 10.0, EPS))
    np.testing.assert_allclose(float(tlfq.lfq_avg_entropy(torch.from_numpy(x), 10.0)), ref,
                               rtol=1e-5)
    before = (lfq_avg_probs.launches, lfq_entropy_grad.launches)
    avg_probs_plain(torch.from_numpy(x), 10.0)
    entropy_grad_plain(torch.from_numpy(x), torch.zeros(2 ** 13), 10.0)
    assert (lfq_avg_probs.launches, lfq_entropy_grad.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        lfq_avg_probs(torch.zeros(4, 13, device="meta"), 10.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lfq_avg_probs(torch.zeros(4, 13, dtype=torch.float64), 10.0)


@pytest.mark.parametrize("n,d,sms,splits", [(512, 18, 132, 128), (1000, 18, 132, 64),
                                            (33, 13, 132, 32), (512, 13, 132, 32)])
def test_grad_splits_fill_the_card(n, d, sms, splits):
    got = grad_splits(n, d, sms)
    assert got == splits
    assert (2 ** d) % got == 0 and (2 ** d) // got >= 256


@pytest.mark.parametrize("beta", [5.0, 100.0])
def test_lfq_loss_codebooks_and_scales_match_jax(beta):
    """`lfq_loss` with two codebooks of 13 bits (K5/K6's path), a frame
    subsample, the entropy anneal scale and the bit balance scale. At beta
    = 100 the JAX chunked entropy carries its cancellation error (see the
    module docstring), about 5e-5 of this loss."""
    x = _x(2 * 3 * 16 * 2, 13, 0.4, seed=5).reshape(2, 3, 16, 2, 13)
    kw = dict(beta=beta, commit_weight=0.25, entropy_weight=0.1, diversity_weight=1.0,
              frac_sample=0.5, num_codebooks=2, entropy_scale=0.3, bit_balance_scale=0.5,
              bit_balance_weight=0.2)

    def jloss(v):
        return jlfq.lfq_loss(v, jnp.where(v > 0, 1.0, -1.0), **kw)

    (ref, ref_aux), ref_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss, aux = tlfq.lfq_loss(xt, torch.where(xt > 0, 1.0, -1.0), **kw)
    loss.backward()
    rtol = 1e-5 if beta == 5.0 else 1e-4
    np.testing.assert_allclose(loss.item(), float(ref), rtol=rtol)
    assert set(aux) == set(ref_aux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), atol=2e-4, rtol=2e-2)
