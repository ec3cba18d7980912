"""SDAR-30B-A3B's layers in the port (`sdar_block`: block-causal GQA with
QK-norm, sparse experts) against the plain float32 reference
`tests/sdar_reference.py`, at a small size on the CPU: 2 layers 64 wide,
GQA 4/2 x 16, 8 experts of 32 at top 2, 256 tokens, blocks of 4
(`sdar_compact_config()`), seeded random weights.

Tolerances: both sides compute in float32 on the CPU, the port through
SDPA, `F.rms_norm`, a sort-based dispatch and the grouped products' plain
twin, the reference through explicit products, softmax and a loop over
the experts; sums of at most 64 terms in another order, through 2 layers,
agree to rtol 1e-4 / atol 1e-5 of logits of size about 1 (f32 rounds at
6e-8; one order of magnitude per layer of slack). Caches of the same
arithmetic in another order: atol 1e-5. What must be exact (ids, routing
choices, the session's tokens on the same noise) is compared exactly.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from open_genie_tpu_torch.models.configs import sdar_30b_a3b_config, sdar_compact_config
from open_genie_tpu_torch.models.dynamics import DynamicsModel, get_schedule
from open_genie_tpu_torch.modules import parse_blueprint
from open_genie_tpu_torch.modules.moe import SparseMoE, expert_load, route
from open_genie_tpu_torch.ops.kernels.moe_experts import (
    block_m,
    moe_experts,
    moe_experts_plain,
    route_slots,
)
from open_genie_tpu_torch.serve import BlockSession
from open_genie_tpu_torch.utils import debug
from tests import sdar_reference as ref

ROOT = Path(__file__).resolve().parents[1]
CFG = sdar_compact_config()
DYN = CFG["dynamics"]
KW = DYN["desc"][0][1]
BLOCK = CFG["block_length"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _model(seed: int = 0) -> DynamicsModel:
    """The compact model with seeded weights: matrices normal over their
    fan-in, norm scales near 1 (so a wrong scale shows)."""
    g = torch.Generator().manual_seed(seed)
    m = DynamicsModel(**DYN).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5)
    return m


def _ids(b: int, blocks: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, DYN["mask_id"], (b, blocks * BLOCK), generator=g)


def _ref_logits(m, ids):
    with torch.no_grad():
        return ref.forward(DYN, m.state_dict().__getitem__, ids, BLOCK)


def test_reference_names_every_parameter():
    m = DynamicsModel(**DYN)
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == ref.param_names(DYN)


@pytest.mark.parametrize("blocks", [1, 3])
def test_full_forward_matches_reference(blocks):
    m = _model()
    ids = _ids(2, blocks)
    with torch.no_grad():
        got = m(ids.view(2, blocks, 1, BLOCK), None).reshape(2, blocks * BLOCK, -1)
    torch.testing.assert_close(got, _ref_logits(m, ids), **TOL)


def test_block_causality():
    """A later block's tokens move no earlier logit; a token of the same
    block moves every logit of its block."""
    m = _model()
    ids = _ids(1, 3)
    other = ids.clone()
    other[0, 9] = (other[0, 9] + 1) % DYN["mask_id"]
    with torch.no_grad():
        a, b = (m(t.view(1, 3, 1, BLOCK), None).reshape(12, -1) for t in (ids, other))
    assert torch.equal(a[:8], b[:8])
    assert all(not torch.allclose(a[i], b[i]) for i in range(8, 12))


def test_prefill_then_refine_and_commit_match_full_forward():
    """Prefill a prompt through the cache, then for two blocks: refinement
    passes on partly masked inputs (read-only for the rest of the cache)
    and a commit, each pass's logits equal to the reference's full forward
    on the prompt, the blocks committed so far and that input."""
    m = _model()
    b, t0 = 2, 3
    prompt = _ids(b, t0)
    cache = m.init_cache(b, 1, BLOCK, t0 + 2, dtype=torch.float32)
    m.prefill(prompt.view(b, t0, 1, BLOCK), None, cache, 0)
    seq = prompt
    g = torch.Generator().manual_seed(5)
    for pos in range(t0, t0 + 2):
        final = torch.randint(0, DYN["mask_id"], (b, BLOCK), generator=g)
        for masked in (BLOCK, 2, 0):
            inp = final.clone()
            inp[:, :masked] = DYN["mask_id"]
            logits, _ = m.decode_frame(inp.view(b, 1, BLOCK), None, cache, pos,
                                       commit=masked == 0)
            want = _ref_logits(m, torch.cat([seq, inp], 1))[:, -BLOCK:]
            torch.testing.assert_close(logits.reshape(b, BLOCK, -1), want, **TOL)
        seq = torch.cat([seq, final], 1)


@pytest.mark.parametrize("chunk_frames", [1, 2])
def test_chunked_prefill_equals_block_at_a_time(chunk_frames):
    m = _model()
    b, t0 = 2, 4
    frames = _ids(b, t0).view(b, t0, 1, BLOCK)
    whole = m.init_cache(b, 1, BLOCK, t0 + 1, dtype=torch.float32)
    m.prefill(frames, None, whole, 0)
    parts = m.init_cache(b, 1, BLOCK, t0 + 1, dtype=torch.float32)
    for p in range(0, t0, chunk_frames):
        m.prefill(frames[:, p: p + chunk_frames], None, parts, p)
    for cw, cp in zip(whole, parts):
        torch.testing.assert_close(cw["k"], cp["k"], rtol=0, atol=1e-5)
        torch.testing.assert_close(cw["v"], cp["v"], rtol=0, atol=1e-5)
    nxt = _ids(b, 1, seed=9).view(b, 1, BLOCK)
    la, _ = m.decode_frame(nxt, None, whole, t0, commit=False)
    lb, _ = m.decode_frame(nxt, None, parts, t0, commit=False)
    torch.testing.assert_close(la, lb, **TOL)


def test_router_top_k_with_ties():
    """Ties go to the lower expert index, as in the reference; the kept
    probabilities renormalise to 1."""
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0, 0.0, 0.0, 1.0],
                           [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                           [0.0, 0.0, 3.0, 0.0, 0.0, 0.0, 0.0, 3.0]])
    w, idx = route(logits, 2)
    rw, ridx = ref.route(logits, 2)
    assert idx.tolist() == [[1, 2], [0, 1], [2, 7]] == ridx.tolist()
    torch.testing.assert_close(w, rw)
    torch.testing.assert_close(w.sum(-1), torch.ones(3))
    w3, _ = route(logits, 3, norm_topk_prob=False)
    want = torch.softmax(logits, -1).sort(-1, descending=True).values[:, :3]
    torch.testing.assert_close(w3, want)


def test_route_slots_offsets():
    idx = torch.tensor([[3, 0], [0, 5], [5, 3], [1, 0]])
    order, offsets = route_slots(idx, torch.arange(9))
    assert offsets.dtype == torch.int32 and offsets.tolist() == [0, 3, 4, 4, 6, 6, 8, 8, 8]
    assert idx.flatten()[order].tolist() == [0, 0, 0, 1, 3, 3, 5, 5]
    assert order.tolist()[:3] == [1, 2, 7]  # stable: slots in order within an expert
    _, part = route_slots(idx, torch.arange(3, 7))  # experts 3, 4, 5 held
    assert part.tolist() == [4, 6, 6, 8]


def _reference_moe(moe: SparseMoE, x: torch.Tensor) -> torch.Tensor:
    kw = dict(KW, n_experts=moe.n_experts, top_k=moe.top_k)
    sd = {k: v for k, v in moe.state_dict().items()}
    return ref.moe(kw, lambda name: sd[name[len("p."):]], "p.", x)


def test_grouped_experts_equal_the_loop_with_an_idle_expert():
    """The layer's dispatch, grouped products and combine against the
    reference's loop over experts, where one expert gets no token."""
    torch.manual_seed(3)
    moe = SparseMoE(64, 8, 2, 32)
    with torch.no_grad():
        moe.router.weight[3] = -1.0  # on positive inputs expert 3 is never in the top 2
    x = torch.randn(5, 7, 64).abs()
    _, idx = route(moe.router(x.reshape(-1, 64)), 2)
    assert 3 not in idx.flatten().tolist()
    with torch.no_grad():
        torch.testing.assert_close(moe(x), _reference_moe(moe, x), **TOL)


def test_sparse_moe_writes_each_pass_offsets_into_its_load_buffer():
    """The layer's `load` buffer holds the last pass's offsets of each
    expert's sorted slots (a CUDA graph of the pass writes it in place):
    the running sum of the slots each expert got."""
    torch.manual_seed(4)
    moe = SparseMoE(64, 8, 2, 32)
    x = torch.randn(9, 64)
    buf = moe.load
    with torch.no_grad():
        moe(x)
    _, idx = route(moe.router(x), 2)
    want = torch.cat([torch.zeros(1, dtype=torch.long),
                      torch.bincount(idx.flatten(), minlength=8).cumsum(0)])
    assert moe.load is buf and moe.load.dtype == torch.int32
    assert moe.load.tolist() == want.tolist()
    assert "load" not in moe.state_dict()


def test_expert_load_reads_a_stack_of_layers_as_one_pass_each():
    """A counted stack of layers' offsets (the session's count after a
    graph's replay) reads as one dict a layer; the count is a copy, so a
    later write to the buffer does not change it."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.tensor([0, 3, 3, 8], dtype=torch.int32)
    b = torch.tensor([0, 1, 5, 8], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        with debug.span("session.step"):
            debug.count("moe_expert_load", [a, b])
            a.zero_()
    step = debug.span_record(1)[0]["step"]
    load = expert_load({step})
    assert [(r["max"], r["hit"], r["slots"]) for r in load] == [(5, 2, 8), (4, 3, 8)]


def test_grouped_products_twin_in_bf16():
    """The twin rounds h to bf16 as the kernel stores it; the f32 sums
    match a per-slot computation of the same rounding."""
    torch.manual_seed(5)
    e, c, i, k, t = 4, 32, 16, 2, 6
    x = torch.randn(t, c).bfloat16()
    wgu, wd = torch.randn(e, 2 * i, c).bfloat16(), torch.randn(e, c, i).bfloat16()
    idx = torch.tensor([[0, 2], [2, 1], [0, 1], [1, 2], [0, 2], [2, 1]])
    order, offsets = route_slots(idx, torch.arange(e + 1))
    wts = torch.rand(t * k)
    out = moe_experts(x, wgu, wd, order, offsets, wts, k)
    for s in range(t * k):
        ex = int(idx.flatten()[s])
        gu = x[s // k].float() @ wgu[ex].float().T
        h = (torch.nn.functional.silu(gu[:i]) * gu[i:]).bfloat16().float()
        torch.testing.assert_close(out[s], wts[s] * (h @ wd[ex].float().T), rtol=1e-5, atol=1e-5)
    assert out.dtype == torch.float32
    assert torch.equal(out, moe_experts_plain(x, wgu, wd, order, offsets, wts, k))


@pytest.mark.parametrize("slots,experts,want", [(2048, 128, 32), (131072, 128, 64),
                                                (8, 4, 16), (16, 8, 16)])
def test_block_m_from_shapes(slots, experts, want):
    assert block_m(slots, experts) == want


def test_moe_experts_refuses_bad_inputs():
    x = torch.randn(3, 16)
    wgu, wd = torch.randn(2, 8, 16), torch.randn(2, 16, 4)
    order, offsets = route_slots(torch.tensor([[0], [1], [0]]), torch.arange(3))
    with pytest.raises(ValueError, match="offsets"):
        moe_experts(x, wgu, wd, order, offsets[:-1], torch.ones(3), 1)
    with pytest.raises(ValueError, match="float32 routing weights"):
        moe_experts(x, wgu, wd, order, offsets, torch.ones(3, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="do not fit"):
        moe_experts(x, wgu, wd[:, :8], order, offsets, torch.ones(3), 1)


def _drive(m, prompt, seed, blocks, steps):
    """Block by block through `refine_frame` with a generator of `seed`."""
    b, n = prompt.shape
    t0 = n // BLOCK
    cache = m.init_cache(b, 1, BLOCK, t0 + blocks, dtype=torch.float32)
    for p in range(t0):
        m.prefill(prompt.view(b, t0, 1, BLOCK)[:, p: p + 1], None, cache, p)
    gen = torch.Generator().manual_seed(seed)
    schedule = get_schedule(steps, (1, BLOCK))
    out = []
    for f in range(blocks):
        frame, _ = m.refine_frame(cache, t0 + f, None, schedule, 1.0, (b, 1, BLOCK), torch.long,
                                  torch.device("cpu"), generator=gen, decode=m.decode_frame)
        out.append(frame.view(b, BLOCK))
    return out


def test_block_session_equals_refine_frame_on_the_same_noise():
    m = _model()
    prompt = _ids(3, 4)
    sess = BlockSession(m, max_blocks=3, block_length=BLOCK, steps_per_block=4,
                        prefill_chunk=8, device="cpu")
    sess.reset(prompt, seed=11)
    got = [sess.step() for _ in range(3)]
    want = _drive(m, prompt, 11, 3, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(0 <= int(g.min()) and int(g.max()) < DYN["tok_vocab"] for g in got)
    with pytest.raises(RuntimeError, match="max_blocks"):
        sess.step()


def test_block_schedule_commits_one_token_a_step():
    assert get_schedule(4, (1, 4)).tolist() == [1, 1, 1, 1]


def test_refinements_fill_masked_positions_with_the_mask_id():
    m = _model()
    seen = []
    hook = m.tok_emb.register_forward_pre_hook(lambda mod, args: seen.append(args[0].clone()))
    try:
        _drive(m, _ids(2, 2), 3, 1, 4)
    finally:
        hook.remove()
    first = seen[2]  # after the two prefilled frames: the first refinement's input
    assert first.shape == (2, 1, 1, BLOCK) and (first == DYN["mask_id"]).all()
    assert [int((s == DYN["mask_id"]).sum()) for s in seen[2:7]] == [8, 6, 4, 2, 0]


@pytest.mark.parametrize("desc,bad", [
    ((("space-time_attn", {"n_rep": 1, "n_embd": 64, "n_head": 4, "d_head": 16}),
      ("sdar_block", dict(KW, n_rep=1))), "layer 1 (SdarBlock) has a 'token' cache"),
    ((("sdar_block", dict(KW, n_rep=1)), ("gelu", {})), "layer 1 (Activation) has no decode"),
])
def test_a_trunk_mixing_cache_kinds_raises_naming_the_layer(desc, bad):
    m = DynamicsModel(desc, tok_vocab=256, act_vocab=None, embed_dim=64)
    assert not m.supports_cached_decode()
    with pytest.raises(ValueError, match=bad.replace("(", r"\(").replace(")", r"\)")):
        m.init_cache(1, 1, BLOCK, 2)


def test_layers_give_their_own_caches():
    m = _model()
    caches = m.init_cache(2, 1, BLOCK, 5, dtype=torch.bfloat16)
    assert m.supports_cached_decode() and len(caches) == 2
    for c in caches:
        assert set(c) == {"k", "v"} and c["k"].shape == (2, 2, 20, 16)
        assert c["k"].dtype == torch.bfloat16


def test_spans_and_the_expert_load_counter_record_only_under_a_profiler():
    m = _model()
    sess = BlockSession(m, max_blocks=2, block_length=BLOCK, prefill_chunk=8, device="cpu")
    before = len(debug.counter_record("moe_expert_load"))
    sess.reset(_ids(2, 2), seed=1)
    sess.step()
    assert len(debug.counter_record("moe_expert_load")) == before
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        sess.step()
    names = [s["name"] for s in debug.span_record(1)]
    assert names.count("session.step") == 1
    assert names.count("attn.block") == names.count("moe.experts") == 2 * 5
    assert names.count("moe.route") == 10 and names.count("maskgit.sample") == 4
    step = next(s["step"] for s in debug.span_record(1))
    load = expert_load({step})
    assert len(load) == 10
    # 2 rows x 4 tokens x top 2 = 16 slots over 8 experts a pass
    assert all(r["slots"] == 16 and r["hit"] >= 2 and r["max"] >= r["mean"] == 2.0
               for r in load)


def test_prefill_span_and_chunks():
    m = _model()
    sess = BlockSession(m, max_blocks=1, block_length=BLOCK, prefill_chunk=8, device="cpu")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        sess.reset(_ids(1, 5), seed=0)
    spans = debug.span_record(1)
    assert spans[0]["name"] == "session.prefill"
    # 5 frames in chunks of 2: 3 passes of 2 layers
    assert sum(s["name"] == "attn.block" for s in spans) == 6
    with pytest.raises(ValueError, match="multiple of the block"):
        sess.reset(torch.zeros(1, 6, dtype=torch.long))


def test_full_width_configuration():
    """`sdar_30b_a3b_config()` at the published widths: 30.53 B
    parameters, built on the meta device."""
    cfg = sdar_30b_a3b_config()
    with torch.device("meta"):
        m = DynamicsModel(**cfg["dynamics"])
    n = sum(p.numel() for p in m.parameters())
    assert n == 30_532_122_624
    assert len(m.layers) == 48 and m.act_emb is None and m.head.bias is None
    layer = m.layers[0]
    assert tuple(layer.moe.w_gate_up.shape) == (128, 1536, 2048)
    assert tuple(layer.attn.to_qkv.weight.shape) == (40 * 128, 2048)
    assert (cfg["block_length"], cfg["denoising_steps"]) == (4, 4)


def test_benchmark_configuration_file_is_the_function():
    """`benchmark/configs/sdar_30b_a3b.json` holds `sdar_30b_a3b_config()`
    and the catalog's numbers of the published config, which the model
    keeps."""
    data = json.loads((ROOT / "benchmark" / "configs" / "sdar_30b_a3b.json").read_text())
    cfg = sdar_30b_a3b_config()

    def plain(x):
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return {k: plain(v) for k, v in x.items()} if isinstance(x, dict) else x

    assert data["model"] == plain(cfg) and data["reduced"] == {}
    assert data["function"] == "open_genie_tpu_torch.models.configs.sdar_30b_a3b_config"
    kw = cfg["dynamics"]["desc"][0][1]
    assert (data["num_hidden_layers"], data["hidden_size"], data["num_attention_heads"],
            data["num_key_value_heads"], data["head_dim"], data["num_experts"],
            data["num_experts_per_tok"], data["moe_intermediate_size"], data["rope_theta"],
            data["rms_norm_eps"], data["norm_topk_prob"], data["vocab_size"]) == (
        kw["n_rep"], kw["n_embd"], kw["n_head"], kw["n_kv_head"], kw["d_head"],
        kw["n_experts"], kw["top_k"], kw["d_expert"], kw["rope_theta"], kw["eps"],
        kw["norm_topk_prob"], cfg["dynamics"]["tok_vocab"])
    assert data["tie_word_embeddings"] is False and data["attention_bias"] is False
    assert data["mlp_only_layers"] == [] and data["decoder_sparse_step"] == 1
    assert data["dtype"] == "bfloat16"


def test_parse_blueprint_builds_sdar_blocks_at_their_width():
    layers, _ = parse_blueprint(DYN["desc"], width=64)
    assert len(layers) == 2 and layers[0].moe.n_experts == 8


def test_prefill_needs_layers_that_take_several_frames():
    """A trunk of `space-time_attn` commits one frame at a time: `prefill`
    raises rather than run its layers on several frames."""
    m = DynamicsModel((("space-time_attn", {"n_rep": 1, "n_embd": 32, "n_head": 2,
                                            "d_head": 16}),), tok_vocab=16, act_vocab=4,
                      embed_dim=32)
    cache = m.init_cache(1, 2, 2, 3)
    with pytest.raises(NotImplementedError, match="one frame at a time"):
        m.prefill(torch.zeros(1, 2, 2, 2, dtype=torch.long), torch.zeros(1, 2, dtype=torch.long),
                  cache, 0)


def test_block_session_watch_sees_every_pass():
    """`watch` gets each pass's input ids and logits: 4 refinements (the
    first all mask ids) and the commit (no mask id left)."""
    m = _model()
    sess = BlockSession(m, max_blocks=1, block_length=BLOCK, prefill_chunk=8, device="cpu")
    sess.reset(_ids(2, 2), seed=4)
    seen = []
    sess.watch = lambda ids, logits: seen.append((ids.clone(), logits.shape))
    out = sess.step()
    assert len(seen) == 5 and all(shape == (2, 1, BLOCK, DYN["tok_vocab"]) for _, shape in seen)
    assert (seen[0][0] == DYN["mask_id"]).all() and torch.equal(seen[4][0].view(2, BLOCK), out)
