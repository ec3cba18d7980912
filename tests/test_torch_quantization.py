"""Lookup-free quantization with projections and several codebooks in the
PyTorch port, against the JAX package on the CPU.

`LookupFreeQuantization` with an input projection, with two codebooks and
with both: the forward (codes and ids), the LFQ loss and its terms, and the
gradients of the loss and the output with respect to the input and every
parameter, against `jax.grad`; `codebook()` and `decode_entries`; the
bridge's flax Dense to `proj_inp`/`proj_out`. Then `VideoTokenizer` with a
projection and with two codebooks: `tokenize`, `quantize`, `decode_tokens`
and the streaming decode, and the tokenizer of `configs/tokenize.yaml`
(`tokenize_yaml_config()`) at 1/8 of its widths, tokenize -> decode. Weights
come from the JAX modules through `bridge.py`. Tolerances: ids exact; one
module atol 1e-5 / rtol 1e-4; stacks atol 2e-3 / rtol 2e-2
(`tools/parity_check.py`); streamed frames against the batch decode atol
2e-5 / rtol 1e-5 (the JAX package's pin).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from open_genie_tpu.models.tokenizer import VideoTokenizer as JTokenizer  # noqa: E402
from open_genie_tpu.modules.quantization import LookupFreeQuantization as JLFQ  # noqa: E402
from open_genie_tpu_torch.bridge import load_flax_params, state_dict_from_flax  # noqa: E402
from open_genie_tpu_torch.models.configs import tokenize_yaml_config  # noqa: E402
from open_genie_tpu_torch.models.tokenizer import VideoTokenizer  # noqa: E402
from open_genie_tpu_torch.modules.quantization import LookupFreeQuantization  # noqa: E402

torch.set_num_threads(1)
OP_TOL = dict(atol=1e-5, rtol=1e-4)
STACK_TOL = dict(atol=2e-3, rtol=2e-2)
EXACT = dict(atol=2e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)

# (codebook_dim, num_codebook, input_dim, frac_sample): a projection, two
# codebooks, both (with a strided entropy sample), and neither.
LFQ_CASES = {
    "proj": (6, 1, 9, 1.0),
    "two_codebooks": (4, 2, None, 1.0),
    "proj_two_codebooks": (3, 2, 10, 0.5),
    "plain": (5, 1, None, 1.0),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lfq_pair(case):
    d, c, inp, frac = LFQ_CASES[case]
    kw = dict(codebook_dim=d, num_codebook=c, input_dim=inp, frac_sample=frac,
              entropy_weight=0.1, bit_balance_weight=0.5)
    jm, tm = JLFQ(**kw), LookupFreeQuantization(**kw)
    width = inp or d * c
    x = np.random.default_rng(3).standard_normal((2, 6, width)).astype(np.float32)
    params = jm.init(KEY, x, training=True).get("params", {})
    if params:
        assert load_flax_params(tm, _np_tree(params)) == []
    else:
        assert list(tm.parameters()) == []
    return jm, tm, params, x


@pytest.mark.parametrize("case", list(LFQ_CASES))
def test_lfq_module_matches_jax(case):
    """Codes, ids (`(..., c)`, squeezed at c = 1), loss and its terms, and
    the gradients of `loss + sum(out * w)` with respect to the input and
    every parameter."""
    jm, tm, params, x = _lfq_pair(case)
    d, c, _, _ = LFQ_CASES[case]
    w = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jfn(p, xx):
        (out, idxs), loss, aux = jm.apply({"params": p}, xx, training=True)
        return loss + (out * w).sum(), (out, idxs, loss, aux)

    (_, (ref_out, ref_idxs, ref_loss, ref_aux)), (jg_p, jg_x) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    (out, idxs), loss, aux = tm(xt, training=True)
    assert tuple(idxs.shape) == ((2, 6) if c == 1 else (2, 6, c))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ref_idxs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **OP_TOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(aux) == set(ref_aux) == {"sample_entropy", "commit_loss", "bit_entropy",
                                        "avg_entropy", "bit_balance"}
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    (loss + (out * torch.from_numpy(w)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), **OP_TOL)
    if params:
        ref_grads, _ = state_dict_from_flax(_np_tree(jg_p), tm)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), ref_grads[name].numpy(), **OP_TOL,
                                       err_msg=name)
    # Outside training: the same codes and ids, no loss.
    (out_e, idxs_e), loss_e, aux_e = tm(torch.from_numpy(x))
    (ref_e, ref_idxs_e), ref_loss_e, _ = jm.apply({"params": params}, x)
    assert loss_e is None and ref_loss_e is None and aux_e == {}
    np.testing.assert_array_equal(idxs_e.numpy(), np.asarray(ref_idxs_e))
    np.testing.assert_allclose(out_e.detach().numpy(), np.asarray(ref_e), **OP_TOL)


@pytest.mark.parametrize("case", list(LFQ_CASES))
def test_lfq_codebook_and_decode_entries_match_jax(case):
    """`codebook_size`, `codebook()` (with several codebooks the indices run
    past 2^d and only their low d bits count, as in JAX) and
    `decode_entries` of `(..., c)` ids through `proj_out`."""
    jm, tm, params, _ = _lfq_pair(case)
    d, c, _, _ = LFQ_CASES[case]
    bound = jm.bind({"params": params})
    assert tm.codebook_size == bound.codebook_size == 2 ** d * c
    np.testing.assert_array_equal(tm.codebook().numpy(), np.asarray(bound.codebook()))
    shape = (2, 3) if c == 1 else (2, 3, c)
    idxs = np.random.default_rng(5).integers(0, 2 ** d, shape).astype(np.int32)
    ref = bound.decode_entries(idxs)
    got = tm.decode_entries(torch.from_numpy(idxs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **OP_TOL)
    assert got.shape[-1] == (LFQ_CASES[case][2] or d * c)


def test_bridge_loads_lfq_projections():
    """flax Dense `kernel (I, O)` -> `weight (O, I)`, bias as it is, under
    `quant.proj_inp` and `quant.proj_out`."""
    jm = JLFQ(codebook_dim=3, num_codebook=2, input_dim=10)
    params = _np_tree(jm.init(KEY, np.zeros((1, 10), np.float32))["params"])
    holder = torch.nn.Module()
    holder.quant = LookupFreeQuantization(3, 2, input_dim=10)
    state, skipped = state_dict_from_flax({"quant": params}, holder)
    assert skipped == [] and set(state) == set(holder.state_dict())
    for name, (i, o) in (("proj_inp", (10, 6)), ("proj_out", (6, 10))):
        assert params[name]["kernel"].shape == (i, o)
        np.testing.assert_array_equal(state[f"quant.{name}.weight"].numpy(),
                                      params[name]["kernel"].T)
        np.testing.assert_array_equal(state[f"quant.{name}.bias"].numpy(),
                                      params[name]["bias"])
    unbiased = LookupFreeQuantization(3, 2, input_dim=10, use_bias=False)
    assert unbiased.proj_inp.bias is None and unbiased.proj_out.bias is None


# A streamable tokenizer whose 12-wide encoder output enters two 3-bit
# codebooks through `proj_inp` (and the decoder takes 12 wide back).
PROJ_TWO_KW = dict(
    enc_desc=(
        ("spacetime_downsample", {
            "in_channels": 3, "kernel_size": 3, "out_channels": 16,
            "time_factor": 1, "space_factor": 4,
        }),
        ("causal-conv3d", {"in_channels": 16, "out_channels": 12, "kernel_size": 1}),
    ),
    dec_desc=(
        ("causal-conv3d", {"in_channels": 12, "out_channels": 16, "kernel_size": 3}),
        ("space-time_attn", {"n_rep": 1, "n_embd": 16, "n_head": 2, "d_head": 8}),
        ("depth2spacetime_upsample", {
            "in_channels": 16, "kernel_size": 3, "out_channels": 3,
            "time_factor": 1, "space_factor": 4,
        }),
    ),
    d_codebook=3,
    n_codebook=2,
)


def _eighth(value):
    return value // 8 if isinstance(value, int) and value >= 64 else value


def tokenize_yaml_eighth(n_rep=None) -> dict:
    """`tokenize_yaml_config()` at 1/8 of its widths (64 -> 8, head width 64
    -> 8), `n_rep` space-time blocks a stack where given (else its 8)."""
    cfg = tokenize_yaml_config()
    tok = dict(cfg["tokenizer"])
    for key in ("enc_desc", "dec_desc"):
        descs = []
        for name, kw in tok[key]:
            kw = {k: _eighth(v) for k, v in kw.items()}
            if name == "space-time_attn" and n_rep is not None:
                kw["n_rep"] = n_rep
            descs.append((name, kw))
        tok[key] = tuple(descs)
    disc = dict(cfg["disc_kwargs"], inp_size=(32, 32), model_dim=8, dim_head=8, num_groups=4)
    return dict(cfg, tokenizer=tok, disc_kwargs=disc)


TOK_CASES = {
    "tokenize_yaml_eighth": lambda: tokenize_yaml_eighth(n_rep=2)["tokenizer"],
    "proj_two_codebooks": lambda: PROJ_TWO_KW,
}


def _tokenizers(case, video):
    kw = TOK_CASES[case]()
    jm, tm = JTokenizer(**kw), VideoTokenizer(**kw).eval()
    params = jax.jit(lambda k: jm.init(k, video))(KEY)["params"]
    assert load_flax_params(tm, _np_tree(params)) == []
    return jm, tm, params


@pytest.mark.parametrize("case", list(TOK_CASES))
def test_tokenizer_round_trip_matches_jax(case):
    """`tokenize` (the unfused path: a projection or two codebooks leave no
    fusable head), `quantize` and `decode_tokens` against JAX."""
    video = np.random.default_rng(6).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    jm, tm, params = _tokenizers(case, video)
    assert not tm.head_fusable() and not jm.bind({"params": params}).head_fusable()
    ref_q, ref_idxs = jax.jit(lambda p, v: jm.apply({"params": p}, v, method=JTokenizer.tokenize))(
        params, video)
    quant, idxs = tm.tokenize(torch.from_numpy(video))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ref_idxs))
    np.testing.assert_allclose(quant.numpy(), np.asarray(ref_q), **STACK_TOL)
    ref_rec = jax.jit(lambda p, i: jm.apply({"params": p}, i, method=JTokenizer.decode_tokens))(
        params, ref_idxs)
    rec = tm.decode_tokens(idxs)
    assert rec.shape == video.shape
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_rec), **STACK_TOL)
    enc = jm.apply({"params": params}, video, method=JTokenizer.encode)
    (ref_qq, ref_qi), _, _ = jm.apply({"params": params}, enc, method=JTokenizer.quantize)
    (qq, qi), _, _ = tm.quantize(torch.from_numpy(np.array(enc)))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ref_qi))
    np.testing.assert_allclose(qq.detach().numpy(), np.asarray(ref_qq), **OP_TOL)


def test_stream_decode_with_projection_and_two_codebooks():
    """`init_stream_cache` / `decode_stream` (through `decode_entries` and
    `proj_out`) on `(B, 1, H, W, c)` token frames: frame by frame against
    JAX's stream, and against the port's own batch decode."""
    video = np.zeros((1, 4, 16, 16, 3), np.float32)
    jm, tm, params = _tokenizers("proj_two_codebooks", video)
    assert tm.stream_decodable()
    idxs = np.random.default_rng(7).integers(0, 8, (1, 4, 4, 4, 2)).astype(np.int32)
    jcache = jm.apply({"params": params}, 1, 4, 4, 4, method=JTokenizer.init_stream_cache)
    cache = tm.init_stream_cache(1, 4, 4, 4)
    frames = []
    for pos in range(4):
        want, jcache = jm.apply({"params": params}, idxs[:, pos:pos + 1], jcache, pos,
                                method=JTokenizer.decode_stream)
        got, cache = tm.decode_stream(torch.from_numpy(idxs[:, pos:pos + 1]), cache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
        frames.append(got)
    # A frame without its time axis, (B, H, W, c), decodes the same.
    again = tm.init_stream_cache(1, 4, 4, 4)
    first, _ = tm.decode_stream(torch.from_numpy(idxs[:, 0]), again, 0)
    np.testing.assert_array_equal(first.numpy(), frames[0].numpy())
    batch = tm.decode_tokens(torch.from_numpy(idxs))
    np.testing.assert_allclose(torch.cat(frames, 1).numpy(), batch.numpy(), **EXACT)
