"""The MaskGIT commit through `ops.kernels.maskgit_sample` (kernel K7 on
the card) on the CPU: the wrapper's plain twin against the commit as it was
written before the kernel (`_commit_before`, kept here as the reference),
bit for bit and with the generator left in the same state; what the
wrapper refuses, the layout the kernel's loads take; its launch counter;
the kernel's split of the vocabulary.
The kernel itself is held to the plain twin on the card, in
`tests/test_torch_kernels_cuda.py`.
"""
import pytest

torch = pytest.importorskip("torch")

from open_genie_tpu_torch.models.dynamics import gumbel_noise, maskgit_commit  # noqa: E402
from open_genie_tpu_torch.ops.kernels.maskgit_sample import (  # noqa: E402
    _check_layout,
    maskgit_sample,
    splits,
)

B, HW, V = 2, 6, 37


def _commit_before(logits, mask, code, num_tokens, temp=1.0, top_k=None, generator=None,
                   gumbel=None):
    """`models/dynamics.py::maskgit_commit` as it read before it called the
    kernel's wrapper."""
    b, hw, v = logits.shape
    logits = logits.float() / temp
    if top_k is not None:
        assert top_k >= 1, f"top_k must be >= 1, got {top_k}"
        if top_k < v:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, device=logits.device)
    pred = torch.argmax(logits + gumbel.float(), dim=-1)
    logp = torch.gather(logits, -1, pred[..., None])[..., 0]
    conf = logp - torch.logsumexp(logits, dim=-1)
    conf = conf.masked_fill(~mask, float("-inf"))
    sorted_conf = torch.sort(conf, dim=-1, descending=True).values
    idx = min(max(int(num_tokens) - 1, 0), hw - 1)
    thr = sorted_conf[:, idx: idx + 1]
    commit = (conf >= thr) & mask
    code = torch.where(commit, pred.to(code.dtype), code)
    return mask & ~commit, code


def _inputs(seed, dtype=torch.float32, code_dtype=torch.int64):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(B, HW, V, generator=g) * 3).to(dtype)
    mask = torch.rand(B, HW, generator=g) > 0.3
    code = torch.randint(0, V, (B, HW), generator=g, dtype=code_dtype)
    return logits, mask, code


def _gumbel(seed, dtype):
    return gumbel_noise((B, HW, V), torch.Generator().manual_seed(seed)).to(dtype)


def _tie_at_threshold():
    """Positions 1 and 4 of player 0 have the same peaked logits and the
    same noise: one confidence, the best, so committing one token commits
    both."""
    logits, mask, code = _inputs(3)
    logits[0, 1] = 0.0
    logits[0, 1, 7] = 30.0
    logits[0, 4] = logits[0, 1]
    mask[0] = True
    gumbel = _gumbel(4, torch.float32)
    gumbel[0, 4] = gumbel[0, 1]
    return (logits, mask, code, 1), dict(gumbel=gumbel)


def _perturbed_max_tie():
    """Player 1, position 2: tokens 5 and 9 tie for the perturbed maximum;
    the lower index wins."""
    logits, mask, code = _inputs(5)
    gumbel = torch.zeros(B, HW, V)
    logits[1, 2, 5] = logits[1, 2, 9] = 50.0
    mask[1, 2] = True
    return (logits, mask, code, HW), dict(gumbel=gumbel)


def _few_masked():
    logits, mask, code = _inputs(6, code_dtype=torch.int32)
    mask[:] = False
    mask[:, 1:4] = True
    return (logits, mask, code, 10), dict(gumbel=_gumbel(7, torch.float32))


CASES = {
    "temp": lambda: (_inputs(0) + (2,), dict(temp=0.8, gumbel=_gumbel(1, torch.float32))),
    "top_k": lambda: (_inputs(1) + (3,), dict(temp=0.8, top_k=4,
                                              gumbel=_gumbel(2, torch.float32))),
    "gumbel_bf16": lambda: (_inputs(2, torch.bfloat16) + (2,),
                            dict(gumbel=_gumbel(3, torch.bfloat16))),
    "gumbel_f32": lambda: (_inputs(8, code_dtype=torch.int32) + (4,),
                           dict(gumbel=_gumbel(9, torch.float32) * 1.1)),
    "tie_at_threshold": _tie_at_threshold,
    "num_tokens_above_masked": _few_masked,
    "perturbed_max_tie": _perturbed_max_tie,
}


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_dispatch_returns_the_commit_before_the_kernel(case):
    args, kwargs = CASES[case]()
    want = _commit_before(*args, **kwargs)
    got = maskgit_commit(*args, **kwargs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == args[2].dtype
    if case == "tie_at_threshold":
        assert not got[0][0, 1] and not got[0][0, 4] and int(got[0][0].sum()) == HW - 2
    if case == "perturbed_max_tie":
        assert int(got[1][1, 2]) == 5
    if case == "num_tokens_above_masked":
        assert not got[0].any()


@pytest.mark.parametrize("temp,top_k", [(1.0, None), (0.8, None), (1.0, 4)])
def test_cpu_draw_is_the_one_before_the_kernel(temp, top_k):
    """From a generator: the same commit, and the generator left where the
    commit before the kernel left it (one float32 uniform draw)."""
    logits, mask, code = _inputs(11, torch.bfloat16)
    gens = [torch.Generator().manual_seed(12) for _ in range(2)]
    want = _commit_before(logits, mask, code, 3, temp, top_k, generator=gens[0])
    got = maskgit_commit(logits, mask, code, 3, temp, top_k, generator=gens[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    with pytest.raises(ValueError, match="torch.Generator"):
        maskgit_commit(logits, mask, code, 3)


def _wrapper_args(**change):
    logits, mask, code = _inputs(13)
    args = dict(logits=logits, noise=torch.rand(B, HW, V), mask=mask, code=code)
    args.update(change)
    return args


REFUSED = {
    "non_contiguous_logits": dict(logits=torch.randn(B, V, HW).transpose(1, 2)),
    "non_contiguous_code": dict(code=torch.zeros(HW, B, dtype=torch.int64).t()),
    "noise_shape": dict(noise=torch.rand(B, HW, V + 1)),
    "mask_shape": dict(mask=torch.ones(B, HW + 1, dtype=torch.bool)),
    "logits_rank": dict(logits=torch.randn(B * HW, V), noise=torch.rand(B * HW, V)),
    "float16_logits": dict(logits=torch.randn(B, HW, V).half()),
    "float64_noise": dict(noise=torch.rand(B, HW, V, dtype=torch.float64)),
    "bf16_uniforms": dict(noise=torch.rand(B, HW, V).bfloat16()),
    "int16_code": dict(code=torch.zeros(B, HW, dtype=torch.int16)),
    "float_mask": dict(mask=torch.ones(B, HW)),
    "meta_device": dict(logits=torch.empty(B, HW, V, device="meta"),
                        noise=torch.empty(B, HW, V, device="meta"),
                        mask=torch.empty(B, HW, dtype=torch.bool, device="meta"),
                        code=torch.empty(B, HW, dtype=torch.int64, device="meta")),
    "mixed_devices": dict(noise=torch.empty(B, HW, V, device="meta")),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args = _wrapper_args(**REFUSED[case])
    before = maskgit_sample.launches
    with pytest.raises(ValueError):
        maskgit_sample(args["logits"], args["noise"], args["mask"], args["code"], 2)
    assert maskgit_sample.launches == before


def test_launch_counter_does_not_move_on_the_cpu():
    args = _wrapper_args()
    before, shapes = maskgit_sample.launches, dict(maskgit_sample.launches_by_shape)
    mask, code, pred, conf = maskgit_sample(args["logits"], args["noise"], args["mask"],
                                            args["code"], 2)
    maskgit_commit(args["logits"], args["mask"], args["code"], 2,
                   generator=torch.Generator().manual_seed(0))
    assert maskgit_sample.launches == before
    assert dict(maskgit_sample.launches_by_shape) == shapes
    assert pred.dtype == torch.int64 and conf.dtype == torch.float32
    assert torch.isinf(conf[~args["mask"]]).all() and torch.isfinite(conf[args["mask"]]).all()


@pytest.mark.parametrize("rows,v,sms", [(2048, 2 ** 18, 132), (128, 2 ** 8, 132),
                                        (2048, 1000, 132), (1, 2 ** 18, 132),
                                        (24, 2 ** 10, 132), (65536, 2 ** 18, 132)])
def test_splits_fill_the_card_and_give_every_thread_work(rows, v, sms):
    s = splits(rows, v, sms)
    chunk = -(-v // s)
    assert s >= 1 and (s == 1 or chunk >= 4 * 256)
    assert s == 1 or rows * (s - 1) < 4 * 8 * sms  # no more splits than the waves need
    assert rows * s >= min(4 * 8 * sms, rows * (v // 1024))  # several blocks on each SM
    if v <= 2 ** 10:
        assert s == 1


def _offset(t: torch.Tensor, elements: int) -> torch.Tensor:
    """`t`'s values in a view that starts `elements` into its storage."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype)
    view = flat[elements:].view(t.shape)
    view.copy_(t)
    return view


LAYOUT_REFUSED = {
    "v_not_multiple_of_4": lambda: (torch.randn(B, HW, V), torch.rand(B, HW, V)),
    "f32_logits_off_16_bytes": lambda: (_offset(torch.randn(B, HW, 64), 2),
                                        torch.rand(B, HW, 64)),
    "bf16_logits_off_8_bytes": lambda: (_offset(torch.randn(B, HW, 64).bfloat16(), 2),
                                        torch.rand(B, HW, 64)),
    "noise_off_16_bytes": lambda: (torch.randn(B, HW, 64), _offset(torch.rand(B, HW, 64), 1)),
}


@pytest.mark.parametrize("case", list(LAYOUT_REFUSED))
def test_kernel_layout_refuses_what_its_loads_do_not_take(case):
    """The kernel loads 4 elements at once: V a multiple of 4, rows aligned
    to such a load (the wrapper checks this before a launch on the card)."""
    logits, noise = LAYOUT_REFUSED[case]()
    with pytest.raises(ValueError, match="kernel takes"):
        _check_layout(logits, noise)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_layout_takes_the_paths_tensors(dtype):
    """What the paths hand the kernel: fresh logits, and one refinement's
    noise out of a stack of them (`gumbel[s]`), V a power of 2."""
    stack = torch.rand(3, B, HW, 64)
    _check_layout(torch.randn(B, HW, 64).to(dtype), stack[1])
    _check_layout(_offset(torch.randn(B, HW, 64).to(dtype), 4), stack[2].to(dtype))
