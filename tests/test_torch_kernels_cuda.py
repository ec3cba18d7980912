"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: skipped without an NVIDIA GPU. On a machine with the card
and without JAX run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py`.
Tolerances: f32 with TF32 off agrees to atol 1e-5 (the same f32 math in a
different order); a bf16 output is within `chip_smoke.bf16_excess`'s limit
of the f32 result on the same bf16 inputs (2^-7 of each value, one to two
bf16 ulps, plus 1/32 of the output's RMS: the kernel rounds p and o to
bf16), its lse within
1e-4 (exact bf16 products summed in f32 in another order);
LFQ signs exactly wherever |z| >= 1e-5, two calls bit-identical. The
backward kernels K3/K4 against
the plain backward on the same inputs and saved forward: f32 atol 1e-4 /
rtol 1e-5 (sums of up to N terms reordered), bf16 within the same limit as
K1's o (the twin rounds p and ds where the kernels do). K5/K6
against their twins, which use the same factorized, cancellation-free
algorithm with the products in float64: q within 1e-5 of max q (f32 sums
over the tokens); the entropy gradient dx / n within atol 2e-4 / rtol 2e-2
and at cosine above 0.99999 (f32 sums of p w, whose w change sign); two
calls bit-identical.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the paths' shapes and the bf16 limit)
from open_genie_tpu_torch.ops.attention import dot_product_attention  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_variant,
)
from open_genie_tpu_torch.ops.kernels.lfq_entropy import (  # noqa: E402
    avg_probs_plain,
    entropy_grad_plain,
    lfq_avg_probs,
    lfq_entropy_grad,
)
from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head  # noqa: E402

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


# Every (B*H, N, D, causal) that the rollout, the Genie step, the tokenizer
# step, the session and the staged training's paths give K1 and K3
# (`chip_smoke.PATH_CASES`, which the smoke run holds to what the paths
# launch), then tile edges, ragged N and D = 128.
PATH_SHAPES = chip_smoke.FLASH_BF16_CASES


@pytest.mark.parametrize("bh,n,d,causal", PATH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, bh, n, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(bh, n, d, generator=g, device=cuda).to(dtype) for _ in range(3))
    variant = flash_variant(dtype, d)
    before = (flash_attention.launches, flash_attention.launches_by_variant[variant])
    o, lse = flash_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_by_variant[variant]) == (
        before[0] + 1, before[1] + 1)
    # The f32 result on the same (possibly bf16-rounded) inputs.
    o_ref, lse_ref = _by_heads(flash_attention_plain, (q.float(), k.float(), v.float()),
                               d ** -0.5, causal)
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)
    else:
        assert chip_smoke.bf16_excess(o, o_ref) <= 1
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    again = flash_attention(q, k, v, d ** -0.5, causal)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("n,c,d,offset", chip_smoke.LFQ_HEAD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lfq_head_kernel(cuda, n, c, d, offset, dtype):
    """The paths' calls and edges (`chip_smoke.LFQ_HEAD_CASES`): codes and
    decided rows' ids equal the plain twin's, two calls bit-identical, one
    launch each."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x, w, b = chip_smoke.lfq_head_inputs(g, n, c, d, offset, dtype, cuda)
    before = lfq_head.launches
    chip_smoke.lfq_head_check(x, w, b)
    assert lfq_head.launches == before + 2


@pytest.mark.parametrize(
    "bh,n,d,causal",
    PATH_SHAPES + [(256, 16, 16, True), (64, 256, 64, False), (8, 4096, 16, False)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernels(cuda, bh, n, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(bh, n, d, generator=g, device=cuda).to(dtype) for _ in range(4))
    o, lse = flash_attention(q, k, v, d ** -0.5, causal)
    variant = flash_variant(dtype, d)
    before = (flash_attention_bwd_dkv.launches_by_variant[variant],
              flash_attention_bwd_dq.launches_by_variant[variant],
              flash_attention_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches_by_variant[variant],
            flash_attention_bwd_dq.launches_by_variant[variant],
            flash_attention_bwd_dq.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    ref = _by_heads(flash_attention_bwd_plain, (q, k, v, o, lse, do), d ** -0.5, causal)
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
        else:
            assert chip_smoke.bf16_excess(a, b) <= 1
    again = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


def test_tensor_core_kernels_refuse_unaligned_tensors(cuda):
    """The bf16 kernels copy rows in 16-byte pieces: a contiguous view that
    starts off a 16-byte boundary raises before any launch."""
    buf = torch.zeros(2 * 8 * 16 + 1, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(2, 8, 16)
    stats = torch.zeros(2, 8, device=cuda)
    fns = (flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    before = [fn.launches for fn in fns]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, q, q, 0.25)
    for fn in fns[1:]:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q, q, q, q, stats, stats, 0.25)
    assert [fn.launches for fn in fns] == before


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


@pytest.mark.parametrize("n,d", [(512, 18), (1000, 13), (33, 18), (512, 15), (33, 24)])
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
    for d in (12, 25):  # the kernels take 13 to 24 bits
        with pytest.raises(ValueError, match="d from 13 to 24"):
            lfq_avg_probs(torch.zeros(8, d, device=cuda), 10.0)
    with pytest.raises(ValueError, match="shape"):
        lfq_entropy_grad(torch.zeros(8, 13, device=cuda), torch.zeros(10, device=cuda), 10.0)
