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
calls bit-identical. K7 (the MaskGIT commit) against its plain twin on
the same logits and noise: pred exactly (x, the Gumbel noise and their sum
are the twin's own f32 arithmetic), conf within 2e-6 (the log-sum-exp sums
over V in another order, a few ulps of a conf near -13), mask and code
exactly for every player whose twin confidences at the threshold lie more
than 1e-5 apart (`chip_smoke.maskgit_check`); the generator left as the
draw before the kernel left it, and the session token-exact with
`rollout_tokens` of the same seed.
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
from open_genie_tpu_torch.ops.kernels.maskgit_sample import (  # noqa: E402
    maskgit_sample,
    maskgit_sample_plain,
)

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
# step, the session, the staged training's paths and a rank of the
# tensor-parallel Genie step (half of every attention's heads) give K1 and
# K3 (`chip_smoke.PATH_CASES`, which the smoke run holds to what the paths
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


@pytest.mark.parametrize("b,hw,v,dtype,noise,temp,top_k", chip_smoke.MASKGIT_CASES)
def test_maskgit_sample_kernel(cuda, b, hw, v, dtype, noise, temp, top_k):
    g = torch.Generator(device=cuda).manual_seed(b * hw + v)
    x, u, mask, code = chip_smoke.maskgit_inputs(g, b, hw, v, dtype, noise, cuda)
    before = maskgit_sample.launches
    chip_smoke.maskgit_check(x, u, mask, code, max(1, int(mask[0].sum()) // 2), temp,
                             noise == "u", top_k)
    assert maskgit_sample.launches == before + 4  # two calls of two kernels


@pytest.mark.parametrize("scale,conf_atol", [(0.01, chip_smoke.MASKGIT_CONF_ATOL), (40.0, 1e-4)])
def test_maskgit_sample_kernel_at_logit_scales(cuda, scale, conf_atol):
    """Logits nearly flat (the noise decides the token) and far apart (the
    logits decide it): pred still the twin's. At std 40 the log-sum-exp is
    near 180, whose f32 ulp is 1.5e-5, so conf is held to 1e-4 there."""
    g = torch.Generator(device=cuda).manual_seed(int(scale * 100))
    x, u, mask, code = chip_smoke.maskgit_inputs(g, 8, 64, 2 ** 18, torch.float32, "u", cuda)
    chip_smoke.maskgit_check(x * (scale / 3), u, mask, code, 8, 1.0, True, conf_atol=conf_atol)


def test_maskgit_sample_kernel_refuses_unaligned(cuda):
    """The kernel loads 4 elements at once: V = 1001, or logits a bf16
    element off an 8-byte boundary, raise before any launch."""
    b, hw = 4, 16
    mask = torch.ones(b, hw, dtype=torch.bool, device=cuda)
    code = torch.zeros(b, hw, dtype=torch.int64, device=cuda)
    before = maskgit_sample.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        maskgit_sample(torch.zeros(b, hw, 1001, device=cuda),
                       torch.rand(b, hw, 1001, device=cuda), mask, code, 2)
    off = torch.zeros(b * hw * 1024 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(b, hw, 1024)
    with pytest.raises(ValueError, match="aligned"):
        maskgit_sample(off, torch.rand(b, hw, 1024, device=cuda), mask, code, 2)
    assert maskgit_sample.launches == before


def test_maskgit_commit_draws_as_before_on_the_card(cuda):
    """One refinement from a generator: K7's commit equals the plain twin's
    on the noise that `gumbel_noise` draws from a generator of the same
    seed, and both generators end in the same state."""
    from open_genie_tpu_torch.models.dynamics import gumbel_noise, maskgit_commit

    g = torch.Generator(device=cuda).manual_seed(1)
    b, hw, v = 8, 64, 2 ** 18
    x = (torch.randn(b, hw, v, generator=g, device=cuda) * 3).to(torch.bfloat16)
    mask = torch.rand(b, hw, generator=g, device=cuda) < 0.6
    code = torch.zeros(b, hw, dtype=torch.int64, device=cuda)
    gens = [torch.Generator(device=cuda).manual_seed(7) for _ in range(2)]
    got = maskgit_commit(x, mask, code, 8, generator=gens[0])
    want = maskgit_sample_plain(x, gumbel_noise(x.shape, gens[1], device=cuda), mask, code, 8,
                                uniform=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_session_replays_rollout_on_the_card(cuda):
    """The compact session's own noise, through K7 at every refinement:
    seeded like the generator given to `rollout_tokens`, it gives the
    rollout's tokens."""
    from open_genie_tpu_torch.models.configs import genie_compact_config
    from open_genie_tpu_torch.models.genie import Genie
    from open_genie_tpu_torch.serve import InteractiveSession
    from open_genie_tpu_torch.utils import init_weights

    g = torch.Generator().manual_seed(2)
    genie = init_weights(Genie(**genie_compact_config()), g).to(cuda).eval()
    steps, n = 4, 3
    prompt = torch.rand(2, 1, 32, 32, 3, generator=g)
    acts = torch.randint(0, genie.act_vocab, (2, 1 + n), generator=g)
    sess = InteractiveSession(genie, max_frames=n, steps_per_frame=steps, device=cuda)
    sess.reset(prompt, seed=5, prompt_actions=acts[:, :1])
    before = maskgit_sample.launches
    for i in range(n):
        sess.step(acts[:, 1 + i])
    assert maskgit_sample.launches - before == 2 * steps * n
    want = genie.rollout_tokens(genie.tokenize_prompt(prompt.to(cuda)), acts.to(cuda), n,
                                steps, generator=torch.Generator(device=cuda).manual_seed(5))
    assert torch.equal(sess.tokens.cpu(), want.cpu())


@pytest.mark.parametrize("t,e,k,c,i", chip_smoke.MOE_CASES)
def test_moe_experts_kernel(cuda, t, e, k, c, i):
    """K8 against its plain twin (`chip_smoke.MOE_CASES`): within
    `bf16_excess` of the twin (f32 sums of the same bf16 products in
    another order; h rounded to bf16 on both sides), two launches a call,
    two calls bit-identical."""
    from open_genie_tpu_torch.ops.kernels.moe_experts import moe_experts, moe_experts_plain

    g = torch.Generator(device=cuda).manual_seed(7)
    x, wgu, wd, order, offsets, wts, _ = chip_smoke.moe_inputs(g, t, e, k, c, i, cuda,
                                                               3 if t < 8 else None)
    before = moe_experts.launches
    got = moe_experts(x, wgu, wd, order, offsets, wts, k)
    again = moe_experts(x, wgu, wd, order, offsets, wts, k)
    torch.cuda.synchronize()
    assert moe_experts.launches == before + 4 and torch.equal(got, again)
    assert chip_smoke.bf16_excess(got, moe_experts_plain(x, wgu, wd, order, offsets, wts,
                                                         k)) <= 1


def test_sparse_moe_layer_on_the_card_does_not_sync(cuda):
    """The layer's routing, dispatch, K8 and combine queue without the host
    waiting on the device (CUDA's sync debug mode raises on a sync)."""
    from open_genie_tpu_torch.modules.moe import SparseMoE

    moe = SparseMoE(256, 32, 4, 128).to(cuda, torch.bfloat16)
    x = torch.randn(64, 256, device=cuda).bfloat16()
    moe(x)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y.shape == x.shape and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("b,nq,nk,n,d,end", chip_smoke.BLOCK_ATTN_CASES)
def test_block_attention_kernel(cuda, b, nq, nk, n, d, end):
    """K9 against its plain twin on the f32 casts of the same bf16 inputs
    (`chip_smoke.BLOCK_ATTN_CASES`): within `bf16_excess` (the kernel
    rounds the probabilities to bf16 before the value product), one launch
    a call, two calls bit-identical; q as a slice of wider heads too."""
    from open_genie_tpu_torch.ops.kernels.block_attention import (
        block_attention,
        block_attention_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(8)
    wide = torch.randn(b, n, nq + nk, d, generator=g, device=cuda).bfloat16()
    q = wide[:, :, :nq]
    kc, vc = (torch.randn(b, nk, end + 3, d, generator=g, device=cuda).bfloat16()
              for _ in range(2))
    before = block_attention.launches
    got = block_attention(q, kc, vc, end, d ** -0.5)
    assert torch.equal(got, block_attention(q, kc, vc, end, d ** -0.5))
    assert block_attention.launches == before + 2
    want = block_attention_plain(q.float(), kc.float(), vc.float(), end, d ** -0.5)
    assert chip_smoke.bf16_excess(got, want) <= 1


def test_sparse_moe_launches_do_not_grow_with_experts(cuda):
    """One layer call (routing, dispatch, K8, combine) runs about as many
    device ops with 8 experts as with 128 or 512: within 2, since torch's
    sorts take another algorithm at another width (8 experts ran 18, 128
    ran 19 on an H100), where a loop over the experts would add at least 2
    a expert."""
    from torch.profiler import ProfilerActivity, profile

    from open_genie_tpu_torch.modules.moe import SparseMoE

    ops = {}
    for e in (8, 128, 512):
        moe = SparseMoE(256, e, 8, 128).to(cuda, torch.bfloat16)
        x = torch.randn(256, 256, device=cuda).bfloat16()
        moe(x)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            moe(x)
            torch.cuda.synchronize()
        ops[e] = sum(ev.count for ev in prof.key_averages() if ev.device_type.name == "CUDA")
    assert max(ops.values()) - min(ops.values()) <= 2, ops


def test_block_session_replays_its_graphs_while_a_profiler_records(cuda):
    """A `BlockSession` step runs the same CUDA graphs traced or not: in a
    profiled step K8 and K9 show in the device trace from the graphs'
    replays, no layer span opens (the layers run inside the graphs), and
    the expert-load counter holds each pass's offsets of every layer,
    copied from the layers' `load` buffers after each replay."""
    from torch.profiler import ProfilerActivity, profile

    from open_genie_tpu_torch.models.configs import sdar_compact_config
    from open_genie_tpu_torch.models.dynamics import DynamicsModel
    from open_genie_tpu_torch.modules.moe import expert_load
    from open_genie_tpu_torch.serve import BlockSession
    from open_genie_tpu_torch.utils import debug

    cfg = sdar_compact_config()
    dyn_cfg, blk = cfg["dynamics"], cfg["block_length"]
    kw = dyn_cfg["desc"][0][1]
    torch.manual_seed(11)
    dyn = DynamicsModel(**dyn_cfg).to(cuda, torch.bfloat16)
    b = 4
    sess = BlockSession(dyn, max_blocks=3, block_length=blk, prefill_chunk=8, device=cuda)
    sess.reset(torch.randint(0, dyn_cfg["mask_id"], (b, 3 * blk), device=cuda), seed=3)
    sess.step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sess.step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert sum("moe_gate_up_kernel" in n for n in names) == 5 * kw["n_rep"], names
    assert sum("block_attention_kernel" in n for n in names) == 5 * kw["n_rep"], names
    spans = debug.span_record(1)
    assert [s["name"] for s in spans].count("attn.block") == 0
    load = expert_load({spans[0]["step"]})
    assert len(load) == 5 * kw["n_rep"]
    assert all(r["slots"] == b * blk * kw["top_k"] for r in load), load
