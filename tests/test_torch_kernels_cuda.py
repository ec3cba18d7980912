"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: skipped without an NVIDIA GPU. On a machine with the card
and without JAX run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py`.
Tolerances: f32 with TF32 off agrees to atol 1e-5 (the same f32 math in a
different order); a bf16 output is within atol 2e-2 of the f32 result on
the same bf16 inputs (the kernel rounds p and o to bf16);
LFQ signs exactly wherever |z| >= 1e-5. The backward kernels K3/K4 against
the plain backward on the same inputs and saved forward: f32 atol 1e-4 /
rtol 1e-5 (sums of up to N terms reordered), bf16 atol/rtol 2e-2 (the twin
rounds p and ds where the kernels do; a last-bit flip is left). K5/K6
against their twins, which use the same cancellation-free formulation: q
within 1e-5 of max q (f32 sums over the tokens reordered); the entropy
gradient dx / n within atol 2e-4 / rtol 2e-2 and at cosine above 0.99999
(its sums over 2^d codes of p w, whose w change sign, reordered); two calls
bit-identical.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from open_genie_tpu_torch.ops.attention import dot_product_attention  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from open_genie_tpu_torch.ops.kernels.lfq_entropy import (  # noqa: E402
    avg_probs_plain,
    entropy_grad_plain,
    lfq_avg_probs,
    lfq_entropy_grad,
)
from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head, lfq_head_plain  # noqa: E402

pytestmark = pytest.mark.cuda


def _by_heads(fn, tensors, *args):
    """`fn(*tensors, *args)` over slices of the leading B*H axis, each with
    at most 2^28 logits, concatenated: the plain twins' (N, N) matrices of
    a few heads at a time."""
    bh, n = tensors[0].shape[:2]
    step = max(1, 2 ** 28 // (n * n))
    parts = [fn(*(t[i:i + step] for t in tensors), *args) for i in range(0, bh, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "bh,n,d,causal",
    [(8, 256, 16, False), (8, 256, 64, False), (2048, 5, 16, True),
     (2048, 17, 16, True), (4, 1000, 64, False), (4, 1000, 64, True),
     (3, 1, 32, True), (2, 130, 128, True), (64, 4096, 32, False), (64, 1024, 32, False)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, bh, n, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(bh, n, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    # The f32 result on the same (possibly bf16-rounded) inputs.
    o_ref, lse_ref = _by_heads(flash_attention_plain, (q.float(), k.float(), v.float()),
                               d ** -0.5, causal)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref, atol=atol, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,c,d", [(256, 128, 10), (4096, 512, 18), (7, 3, 31)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lfq_head_kernel(cuda, n, c, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, c, generator=g, device=cuda).to(dtype)
    w = torch.randn(c, d, generator=g, device=cuda) * c ** -0.5
    b = torch.randn(d, generator=g, device=cuda) * 0.1
    codes, idx = lfq_head(x, w, b)
    torch.cuda.synchronize()
    codes_ref, idx_ref = lfq_head_plain(x, w, b)
    decided = (x.float() @ w + b).abs() >= 1e-5
    assert torch.equal(codes[decided], codes_ref[decided])
    rows = decided.all(dim=1)
    assert torch.equal(idx[rows], idx_ref[rows])


@pytest.mark.parametrize(
    "bh,n,d,causal",
    [(8, 4096, 16, False), (256, 16, 16, True), (64, 256, 64, False), (4, 1000, 64, True),
     (2048, 17, 16, True), (8, 17, 16, False), (3, 1, 32, True), (2, 130, 128, True),
     (64, 4096, 32, False), (64, 1024, 32, False)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernels(cuda, bh, n, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(bh, n, d, generator=g, device=cuda).to(dtype) for _ in range(4))
    o, lse = flash_attention(q, k, v, d ** -0.5, causal)
    before = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    ref = _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), d ** -0.5, causal)
    tol = dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), **tol)
    again = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


def test_attention_gradients_reach_inputs_on_the_card(cuda):
    """The autograd path on CUDA tensors: gradients through K1, K3 and K4
    equal those of the plain path on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 4, 64, 16, generator=g, device=cuda, requires_grad=True)
               for _ in range(3))
    w = torch.randn(2, 4, 64, 16, generator=g, device=cuda)
    (dot_product_attention(q, k, v, causal=True) * w).sum().backward()
    got = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    o, _ = flash_attention_plain(q, k, v, 0.25, causal=True)
    (o * w).sum().backward()
    for a, t in zip(got, (q, k, v)):
        assert a is not None and a.abs().sum() > 0
        torch.testing.assert_close(a, t.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n,d", [(512, 18), (1000, 13), (33, 18)])
@pytest.mark.parametrize("beta,scale", [(5.0, 0.1), (100.0, 1.0), (100.0, 3.0)])
def test_lfq_entropy_kernels(cuda, n, d, beta, scale):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(n, d, generator=g, device=cuda) * scale
    before = (lfq_avg_probs.launches, lfq_entropy_grad.launches)
    q = lfq_avg_probs(x, beta)
    q_ref = avg_probs_plain(x, beta)
    w = torch.where(q_ref > 1e-6, 1.0 + torch.log(q_ref.clamp_min(1e-6)), math.log(1e-6))
    dx = lfq_entropy_grad(x, w, beta)
    torch.cuda.synchronize()
    assert (lfq_avg_probs.launches, lfq_entropy_grad.launches) == (before[0] + 1, before[1] + 1)
    assert (q - q_ref).abs().max() <= 1e-5 * q_ref.max()
    dx_ref = entropy_grad_plain(x, w, beta)
    torch.testing.assert_close(dx / n, dx_ref / n, atol=2e-4, rtol=2e-2)
    cos = torch.nn.functional.cosine_similarity(dx.flatten().double(), dx_ref.flatten().double(),
                                                dim=0)
    assert cos > 0.99999
    assert torch.equal(lfq_avg_probs(x, beta), q)
    assert torch.equal(lfq_entropy_grad(x, w, beta), dx)


def test_lfq_entropy_kernels_refuse_what_they_do_not_take(cuda):
    for d in (12, 14):  # built for the configurations' codebooks, 13 and 18 bits
        with pytest.raises(ValueError, match="d in"):
            lfq_avg_probs(torch.zeros(8, d, device=cuda), 10.0)
    with pytest.raises(ValueError, match="shape"):
        lfq_entropy_grad(torch.zeros(8, 13, device=cuda), torch.zeros(10, device=cuda), 10.0)
